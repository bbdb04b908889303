"""D-Rex-protected distributed checkpointing of PyTorch state dicts.

Every checkpoint is cut into ~item_mb groups; each group is a D-Rex
"data item": the configured scheduler picks (K, P, M) per group against
the live heterogeneous fabric (reliability target + retention window are
checkpoint policy), the Cauchy-RS kernel encodes on the card, and chunks
land on the chosen nodes.  Restore tolerates up to P node losses per
group; ``repair`` re-encodes degraded groups after failures.

``save`` is a streaming encode→place→write pipeline: all groups of a
checkpoint are placed in ONE ``place_many`` batch (one shared
``BatchContext``), encoded in per-(K, P) cohort waves through
``ECCodec.encode_many`` (one kernel launch per wave), copied to the host
once per wave (each group's chunks straight into a reused host block,
page-locked on CUDA, of which the fabric's blobs are views), and each
wave's fabric ``put`` overlaps the *next* wave's encode through a
multi-worker I/O pool (double-buffered — at most two waves of chunks
are in flight).  ``pipeline_workers=0`` is the serial path (per-group
encode then put).

A save starts with a snapshot on the calling thread: every group's
bucket-padded payload is copied into a fresh tensor on the
checkpointer's device, on the caller's current stream, and an event is
recorded behind the copies.  ``save_async`` returns after that; the
placement, the encode waves, their copies to the host and the puts run
on a save-pool worker (``save`` runs the same body inline).  On a CUDA
device that body runs on the checkpointer's own stream, which first
waits on the snapshot's event, so work the caller queues next on its
stream (an in-place training step) runs after the copies and overlaps
the save.  Each wave's payloads are dropped once its chunks are on the
host.  The I/O pool handles host bytes only.

A restore copies each group's first K live chunk rows straight from
the fabric's blobs into one (K, chunk_len) tensor on the checkpointer's
device, a row at a time, on the caller's current stream.  On CUDA the
blobs a save wrote are views of page-locked blocks, which the card
reads directly, so no chunk byte is copied on the host; the host waits
once a batch for those copies before it lets go of the rows.  Leaves
are loaded in batches of consecutive leaves of up to ~256 MiB of
staged chunks (a larger leaf alone): one copy pass and one decode pass
a batch, so a state of many small leaves is not restored leaf by leaf.

The state is an ordered ``dict[str, torch.Tensor]`` (a ``state_dict``);
leaf order is the dict's order and the manifest records each leaf's
name, shape and dtype.  Leaf bytes are the tensor's raw bytes
(``view(torch.uint8)``), so bf16 and every other dtype round-trip
bit-exactly.  Group placement, padding, chunk bytes and fabric keys are
identical to the JAX package's ``repro.checkpoint.manager`` for the same
leaf bytes.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import mmap
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch._device import resolve_device
from repro_torch.core import BatchContext, DataItem, Placement, PlacementEngine, Scheduler
from repro_torch.core.reliability import poisson_binomial_cdf
from repro_torch.ec import ECCodec, plan_cohorts

from .fabric import StorageFabric

__all__ = ["CheckpointPolicy", "DRexCheckpointer", "dtype_name", "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    reliability_target: float = 0.999
    retention_days: float = 30.0
    item_mb: float = 64.0            # max group payload size
    use_kernel: bool = True          # bit-matrix kernel vs GF-table oracle
    keep_last: int = 2               # garbage-collect older checkpoints
    #: fabric-write workers for the save pipeline; 0 = serial
    #: (per-group encode then put, no overlap).
    pipeline_workers: int = 2
    #: max groups fused into one encode launch; also the wave size the
    #: pipeline double-buffers (bounds peak chunk memory to ~2 waves).
    encode_wave_groups: int = 16


@dataclasses.dataclass
class _Group:
    key: str
    k: int
    p: int
    node_ids: list
    orig_nbytes: int


@dataclasses.dataclass
class _Snapshot:
    """What a save needs of the state: the groups' padded payloads (new
    tensors, dropped wave by wave), their unpadded lengths and (leaf,
    part) slots, the manifest skeleton, and on CUDA the event recorded
    behind the payloads' copies."""

    step: int
    manifest: dict
    payloads: list
    orig_lens: list
    slots: list
    ready: Optional[torch.cuda.Event]
    #: the save's operation id while tracing (``telemetry.span``), else None
    op: Optional[int] = None


def dtype_name(dtype: torch.dtype) -> str:
    """Manifest name of a dtype: torch's name without the prefix, which
    is numpy's name for every dtype numpy has ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of :func:`dtype_name` (also reads numpy dtype names)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype for manifest dtype {name!r}")
    return dt


def _leaf_bytes(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The leaf's raw bytes as a flat uint8 tensor on ``device``."""
    flat = t.detach().to(device).contiguous().reshape(-1)
    if flat.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=device)
    return flat.view(torch.uint8)


def _bucket_len(n: int) -> int:
    """Bytes of the power-of-two bucket (at least 4096) that holds ``n``."""
    bucket = 4096
    while bucket < n:
        bucket <<= 1
    return bucket


def _pad_to_bucket(payload: torch.Tensor) -> torch.Tensor:
    """Pad to power-of-two bucket sizes so the codec sees a bounded set of
    chunk shapes — <=2x padding on the tail group only.  Every
    (re-)encode of a group MUST go through this so repaired chunks keep
    the shape of the surviving ones.  The result is always a new tensor,
    also when the payload fills its bucket: a save's snapshot must not
    alias the state."""
    n = payload.numel()
    out = payload.new_zeros(_bucket_len(n))
    out[:n] = payload
    return out


def _staged_len(g: dict) -> int:
    """Bytes a restore stages for a manifest group: its K chunk rows of
    ceil(bucket / K) bytes."""
    return g["k"] * -(-_bucket_len(g["orig_nbytes"]) // g["k"])


#: staged bytes past which a restore stops adding leaves to one
#: ``_load_groups`` call: the K rows of about four 64 MB groups.
_RESTORE_BATCH_BYTES = 256 << 20


def _restore_batches(leaves_meta: list) -> list[list[int]]:
    """Indices of consecutive manifest leaves, cut into the batches a
    restore loads together.  Whole leaves are added while the batch's
    staged bytes stay within :data:`_RESTORE_BATCH_BYTES`; a leaf that
    would take it past them starts the next batch, so a larger leaf is
    a batch of its own."""
    batches: list[list[int]] = []
    size = 0
    for i, meta in enumerate(leaves_meta):
        n = sum(_staged_len(g) for g in meta["groups"])
        if not batches or size + n > _RESTORE_BATCH_BYTES:
            batches.append([])
            size = 0
        batches[-1].append(i)
        size += n
    return batches


def _blob(row: np.ndarray) -> memoryview:
    """A chunk row as the fabric keeps it: a read-only view of its wave's
    host buffer, equal to the row's bytes.  A ``tobytes`` copy would hold
    the GIL for its whole memcpy, and an async save's puts would then
    stall every launch of the caller's training step."""
    return memoryview(row).toreadonly()


#: ``cudaHostRegisterPortable``: page-locked for every CUDA context
_HOST_REGISTER_PORTABLE = 1


def _page_locked(nbytes: int) -> Optional[tuple[torch.Tensor, Callable[[], None]]]:
    """An exact-size host block page-locked in place: an anonymous
    private mapping (page-aligned, so torch's power-of-two rounding of
    page-locked allocations is not paid) registered with CUDA.
    Returns (the block as a uint8 tensor, the call that unregisters it),
    or None where CUDA does not page-lock it."""
    block = torch.frombuffer(mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE), dtype=torch.uint8)
    cudart = torch.cuda.cudart()
    ptr = block.data_ptr()
    if int(cudart.cudaHostRegister(ptr, nbytes, _HOST_REGISTER_PORTABLE)) != 0:
        # the refusal stays this thread's last CUDA error, which torch's
        # next kernel launch would raise; reading it resets it
        ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}").cudaGetLastError()
        return None
    return block, lambda: cudart.cudaHostUnregister(ptr)


def _plain_host(nbytes: int) -> tuple[torch.Tensor, Callable[[], None]]:
    """An exact-size block of plain host memory, for a CPU checkpointer:
    torch frees it with its last reference, so releasing it does nothing."""
    return torch.empty(nbytes, dtype=torch.uint8), lambda: None


class _HostBlocks:
    """A checkpointer's reused host blocks, keyed by exact byte size: each
    group's chunk matrix is copied from the device straight into one.  A
    block a group, not a wave, so that a group placed at another (K, P)
    than in an earlier save changes the size of its own block only, and
    not of every block of its wave and the waves after it.

    ``take`` hands a block out as a fresh ndarray over it.  The group's
    chunk rows, and so the fabric's blobs, are views of that ndarray; when
    the last view is gone (every blob deleted or lost with its node, every
    restore's or repair's view of them dropped) the block goes back to the
    idle list, and only a later ``take`` of the same size writes it again.
    Nothing else frees a block: a restore on another thread may still be
    reading one whose checkpoint was collected.  Idle blocks are kept up
    to the chunk bytes of the largest save so far (``note_save``), with
    any block allocated because none of its size was idle, the oldest
    released first; ``close`` releases the idle ones, and a block still
    viewed then is released when its last view goes.

    ``alloc(nbytes)`` returns (a uint8 tensor of ``nbytes``, the call that
    frees it), or None where it cannot: :func:`_page_locked` on CUDA,
    :func:`_plain_host` on the CPU."""

    def __init__(self, alloc: Callable[[int], Optional[tuple]]):
        self._alloc = alloc
        #: reentrant: a block can come back on a thread already inside
        self._lock = threading.RLock()
        self._idle: list[tuple[torch.Tensor, Callable[[], None]]] = []  # oldest first
        self._limit = 0
        self._closed = False
        #: bytes of the idle blocks, and of every block not yet released
        self.idle_bytes = 0
        self.held_bytes = 0
        # a pool dropped without ``close`` still releases its idle blocks
        weakref.finalize(self, _HostBlocks._release_all, self._idle).atexit = False

    @staticmethod
    def _release_all(idle: list) -> None:
        for _, release in idle:
            release()

    def note_save(self, nbytes: int) -> None:
        """Keep up to a save of ``nbytes`` chunk bytes of idle blocks."""
        with self._lock:
            self._limit = max(self._limit, nbytes)

    def take(self, nbytes: int) -> Optional[tuple[np.ndarray, torch.Tensor, int]]:
        """(a fresh ndarray over a block of exactly ``nbytes``, the block
        as a tensor to copy into, the bytes newly allocated for it), or
        None where no block is idle and none can be allocated."""
        with self._lock:  # the block given back last: its pages are the warmest
            i = next((i for i in reversed(range(len(self._idle)))
                      if self._idle[i][0].numel() == nbytes), None)
            if i is not None:
                block = self._idle.pop(i)
                self.idle_bytes -= nbytes
            else:  # the idle blocks and the new one stay within one save
                self._trim(nbytes)
        fresh = 0
        if i is None:
            block = self._alloc(nbytes)  # outside the lock: page-locking takes a while
            if block is None:
                return None
            fresh = nbytes
            with self._lock:
                self.held_bytes += nbytes
        host = block[0].numpy()
        weakref.finalize(host, self._give_back, block).atexit = False
        return host, block[0], fresh

    def _give_back(self, block: tuple[torch.Tensor, Callable[[], None]]) -> None:
        with self._lock:
            if self._closed:
                self._release(block)
                return
            self._idle.append(block)
            self.idle_bytes += block[0].numel()
            self._trim(0)

    def _trim(self, extra: int) -> None:
        """Release idle blocks, the oldest first, until ``extra`` more
        bytes of them would stay within one save."""
        while self._idle and self.idle_bytes + extra > self._limit:
            old = self._idle.pop(0)
            self.idle_bytes -= old[0].numel()
            self._release(old)

    def _release(self, block: tuple[torch.Tensor, Callable[[], None]]) -> None:
        self.held_bytes -= block[0].numel()
        block[1]()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            while self._idle:
                self._release(self._idle.pop())
            self.idle_bytes = 0


class DRexCheckpointer:
    def __init__(
        self,
        fabric: StorageFabric,
        scheduler: Scheduler | str = "drex_sc",
        policy: CheckpointPolicy | None = None,
        device: str | torch.device = "cuda",
    ):
        self.fabric = fabric
        #: where coding runs and restored leaves are rebuilt.
        self.device = resolve_device(device)
        # auto_commit=False: the fabric is the byte-accounting authority —
        # occupancy updates when chunks actually land (fabric.put), not at
        # decision time.
        # A scheduler named here scores its place_many batches on the
        # checkpointer's device, as the JAX package's does on its own.
        self.engine = PlacementEngine(
            fabric.cluster, scheduler, auto_commit=False, device=self.device
        )
        self.scheduler = self.engine.scheduler
        self.policy = policy or CheckpointPolicy()
        self._manifests: dict[int, dict] = {}
        # A save-pool worker waits only on I/O futures, never on another
        # save, so two overlapping saves cannot deadlock.
        self._save_pool = ThreadPoolExecutor(max_workers=2)
        self._io_pool = ThreadPoolExecutor(
            max_workers=max(1, self.policy.pipeline_workers)
        )
        #: serializes the placement phase (engine + item-id counter) so
        #: concurrent saves see consistent cluster snapshots.
        self._place_lock = threading.Lock()
        self._meta_lock = threading.Lock()
        self._item_counter = 0
        #: the stream a save's placement, encodes and copies run on.
        self._stream = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )
        #: where a save's chunks land on the host, and what the fabric's
        #: blobs view
        self._save_blocks = _HostBlocks(
            _page_locked if self.device.type == "cuda" else _plain_host
        )
        self.stats: dict[str, float] = {
            "bytes_raw": 0.0, "bytes_stored": 0.0, "encode_s": 0.0, "place_s": 0.0,
            # restores: bytes copied to the device (K x chunk_len a group)
            # and those of them that are bucket padding, host seconds
            # waited for those copies on CUDA, and ``_load_groups`` calls
            # made by ``restore`` (one a batch of leaves)
            "restore_staged_bytes": 0, "restore_pad_bytes": 0,
            "restore_buffer_wait_s": 0.0, "restore_batches": 0,
            # saves (and repairs): chunk bytes copied into reused host
            # blocks (page-locked on CUDA), bytes of the blocks newly
            # allocated for them, and chunk bytes that took the pageable
            # copy because no block could be allocated
            "save_pinned_bytes": 0, "save_pinned_alloc_bytes": 0,
            "save_pageable_bytes": 0,
        }

    # -- save -------------------------------------------------------------------

    def save(self, state: Mapping[str, torch.Tensor], step: int) -> dict:
        """Encode→place→write one checkpoint through the batched pipeline.

        Placement decisions for all groups are made against the cluster
        view at the start of the save (one ``place_many`` batch) — the
        fabric's byte accounting still updates as chunks land."""
        with telemetry.span("ckpt.save"):
            return self._write(self._snapshot(state, step))

    def save_async(self, state: Mapping[str, torch.Tensor], step: int) -> Future:
        """Snapshot the state on the calling thread, then place, encode
        and land the chunks on a save-pool worker, as the JAX package's
        ``save_async`` does.  On CUDA the snapshot's copies are queued on
        the caller's current stream and the call returns without waiting
        for them; the worker's kernels run on the checkpointer's own
        stream.  The future resolves to the manifest once every chunk is
        on the fabric; a failure in any phase is raised by ``result()``
        and registers no manifest."""
        try:
            snap = self._snapshot(state, step)
        except Exception as exc:  # surface through the future, like a put error
            failed: Future = Future()
            failed.set_exception(exc)
            return failed
        return self._save_pool.submit(self._write_async, snap)

    def _write_async(self, snap: _Snapshot) -> dict:
        """:meth:`_write` on a save-pool worker, under the save's root
        span, which joins the snapshot's operation."""
        with telemetry.span("ckpt.save", op=snap.op):
            return self._write(snap)

    def _snapshot(self, state, step) -> _Snapshot:
        """Phase 1 of a save, on the calling thread: every leaf split into
        group payloads, each bucket-padded into a new tensor on the
        checkpointer's device, so nothing of the snapshot aliases the
        state."""
        manifest: dict[str, Any] = {"step": step, "leaves": []}
        max_bytes = int(self.policy.item_mb * 1e6)
        payloads: list[torch.Tensor] = []
        orig_lens: list[int] = []
        slots: list[tuple[int, int]] = []  # (leaf_i, part)
        with telemetry.span("ckpt.save.snapshot") as sp:
            for li, (name, leaf) in enumerate(state.items()):
                raw = _leaf_bytes(leaf, self.device)
                manifest["leaves"].append({
                    "name": str(name), "shape": list(leaf.shape),
                    "dtype": dtype_name(leaf.dtype), "groups": [],
                })
                nbytes = raw.numel()
                with self._meta_lock:
                    self.stats["bytes_raw"] += nbytes
                for off in range(0, max(nbytes, 1), max_bytes):
                    payload = raw[off : off + max_bytes]
                    payloads.append(_pad_to_bucket(payload))
                    orig_lens.append(payload.numel())
                    slots.append((li, off // max_bytes))
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
        return _Snapshot(step, manifest, payloads, orig_lens, slots, ready, sp.op)

    @contextlib.contextmanager
    def _save_stream(self, snap: _Snapshot):
        """On CUDA, the checkpointer's stream once the snapshot's copies
        are done; the payloads are marked as used there, so the caller's
        stream reuses their memory only after the save's work on them."""
        if snap.ready is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            self._stream.wait_event(snap.ready)
            for payload in snap.payloads:
                payload.record_stream(self._stream)
            yield

    def _write(self, snap: _Snapshot) -> dict:
        """Phases 2-4 of a save: place, encode waves while earlier waves
        land, register the manifest."""
        groups: list[Optional[_Group]] = [None] * len(snap.payloads)
        with self._save_stream(snap):
            with telemetry.span("ckpt.save.place"):
                placements = self._place(snap)
            # 3. Cohort waves: encode wave i+1 while wave i's chunks land.
            wave_size = 1 if self.policy.pipeline_workers == 0 else max(
                1, self.policy.encode_wave_groups
            )
            waves: list[list[int]] = []
            for (_kp, idxs) in plan_cohorts([(pl.k, pl.p) for pl in placements]):
                for w in range(0, len(idxs), wave_size):
                    waves.append(idxs[w : w + wave_size])
            pending: deque[Future] = deque()
            try:
                self._encode_waves(
                    waves, snap.payloads, placements, snap.slots, snap.orig_lens,
                    groups, snap.step, pending,
                )
            except BaseException:
                self._drain(pending, quiet=True)  # no orphaned background puts
                raise
            with telemetry.span("ckpt.save.put_wait"):
                self._drain(pending)
        with telemetry.span("ckpt.save.finish"):
            return self._finish(snap.manifest, groups, snap.slots, snap.step)

    def _place(self, snap: _Snapshot) -> list[Placement]:
        """2. One placement batch: groups share retention and reliability
        target, so the engine's batch context amortizes the scheduler's
        reliability DP across all groups of this save."""
        policy = self.policy
        with self._place_lock:
            items = []
            for payload in snap.payloads:
                self._item_counter += 1
                items.append(DataItem(
                    item_id=self._item_counter,
                    size_mb=max(payload.numel() / 1e6, 1e-6),
                    arrival_time=float(snap.step),
                    delta_t_days=policy.retention_days,
                    reliability_target=policy.reliability_target,
                ))
            records = self.engine.place_many(items, ctx=BatchContext())
        placements: list[Placement] = []
        for item, record in zip(items, records):
            with self._meta_lock:
                self.stats["place_s"] += record.overhead_s
            if record.placement is None:
                raise IOError(
                    f"D-Rex could not place checkpoint group "
                    f"({item.size_mb:.1f} MB, "
                    f"RT={policy.reliability_target}): {record.reason}"
                )
            placements.append(record.placement)
        return placements

    @staticmethod
    def _drain(pending: deque, quiet: bool = False) -> None:
        """Wait for every pending put, also behind a failed one; raise the
        first failure unless ``quiet``."""
        first = None
        while pending:
            try:
                pending.popleft().result()
            except Exception as exc:
                first = first or exc
        if first is not None and not quiet:
            raise first

    def _finish(self, manifest, groups, slots, step) -> dict:
        """4. Manifest in original (leaf, part) order; register; GC."""
        for g, (li, _part) in zip(groups, slots):
            manifest["leaves"][li]["groups"].append(dataclasses.asdict(g))
        with self._meta_lock:
            self._manifests[step] = manifest
        self._gc(step)
        return manifest

    def _encode_waves(
        self, waves, payloads, placements, slots, orig_lens, groups,
        step, pending,
    ) -> None:
        """Encode each wave, copy its chunks to the host once, drop its
        payloads, and hand the chunks to the I/O pool."""
        policy = self.policy
        self._save_blocks.note_save(sum(
            (pl.k + pl.p) * -(-payloads[i].numel() // pl.k)
            for i, pl in enumerate(placements)))
        for wave in waves:
            k, p = placements[wave[0]].k, placements[wave[0]].p
            codec = ECCodec(k, p, use_kernel=policy.use_kernel, device=self.device)
            t0 = time.perf_counter()
            # encode_s covers the coding and the wave's one copy to the
            # host (which waits for the kernel); the spans
            # ckpt.save.encode and ckpt.save.d2h split it.
            with telemetry.span("ckpt.save.encode"):
                mats = codec.encode_many([payloads[i] for i in wave])
            with telemetry.span("ckpt.save.d2h"):
                chunk_mats = self._to_host(mats)
            del mats  # the wave's device chunks go before the next wave is encoded
            with self._meta_lock:
                self.stats["encode_s"] += time.perf_counter() - t0
            for i in wave:  # the snapshot shrinks as the save proceeds
                payloads[i] = None
            entries = []
            for i, chunks in zip(wave, chunk_mats):
                li, part = slots[i]
                g = _Group(
                    key=f"ck{step}_l{li}_p{part}", k=k, p=p,
                    node_ids=list(placements[i].node_ids),
                    orig_nbytes=orig_lens[i],
                )
                groups[i] = g
                entries.append((g, chunks))
            if policy.pipeline_workers == 0:
                self._put_wave(entries)
            else:
                pending.append(self._io_pool.submit(self._put_wave, entries))
                # double buffer: at most 2 waves of chunks in flight
                if len(pending) > 2:
                    with telemetry.span("ckpt.save.put_wait"):
                        while len(pending) > 2:
                            pending.popleft().result()

    def _to_host(self, mats: list[torch.Tensor]) -> list[np.ndarray]:
        """The chunk matrices copied to the host once, as numpy arrays
        shaped like them: each matrix into a reused host block of its own
        size, on the current stream, the arrays handed out once those
        copies are done; a matrix whose block is refused takes a pageable
        copy."""
        out, pinned, fresh, pageable = [], 0, 0, 0
        for m in mats:
            got = self._save_blocks.take(m.numel())
            if got is None:
                out.append(m.cpu().numpy())
                pageable += m.numel()
                continue
            host, block, new = got
            block.view(m.shape).copy_(m, non_blocking=True)
            out.append(host.reshape(tuple(m.shape)))
            pinned += m.numel()
            fresh += new
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        with self._meta_lock:
            self.stats["save_pinned_bytes"] += pinned
            self.stats["save_pinned_alloc_bytes"] += fresh
            self.stats["save_pageable_bytes"] += pageable
        return out

    def _put_wave(self, entries: list[tuple[_Group, np.ndarray]]) -> None:
        """Land one wave's chunks on the fabric (runs on the I/O pool)."""
        stored = 0.0
        for g, chunks in entries:
            for row, node in enumerate(g.node_ids):
                self.fabric.put(node, f"{g.key}_r{row}", _blob(chunks[row]))
                stored += chunks.shape[1]
        with self._meta_lock:
            self.stats["bytes_stored"] += stored

    # -- restore ----------------------------------------------------------------

    def restore_latest(
        self, like_state: Optional[Mapping[str, torch.Tensor]] = None
    ) -> Optional[tuple[dict[str, torch.Tensor], int]]:
        if not self._manifests:
            return None
        step = max(self._manifests)
        return self.restore(step, like_state), step

    def restore(
        self, step: int, like_state: Optional[Mapping[str, torch.Tensor]] = None
    ) -> dict[str, torch.Tensor]:
        """Rebuild the state dict of checkpoint ``step``.

        Leaves are decoded on the checkpointer's device; with
        ``like_state`` (a state dict with the same leaf names) each leaf
        lands on the device of its counterpart there.  Consecutive leaves
        load together, in the batches :func:`_restore_batches` cuts: one
        gather, one copy pass and one decode pass a batch, then each leaf
        is assembled from its own groups."""
        manifest = self._manifests[step]
        leaves_meta = manifest["leaves"]
        if like_state is not None and list(like_state) != [
            m["name"] for m in leaves_meta
        ]:
            raise ValueError("state structure mismatch: leaf names differ")
        out: dict[str, torch.Tensor] = {}
        with telemetry.span("ckpt.restore"):
            for batch in _restore_batches(leaves_meta):
                # All groups of a batch of leaves decode in cohort launches
                # (per (K, P) and erasure pattern), and the host waits for
                # their copies to the device once.
                metas = [leaves_meta[i] for i in batch]
                parts = self._load_groups([_Group(**g) for m in metas for g in m["groups"]])
                with self._meta_lock:
                    self.stats["restore_batches"] += 1
                off = 0
                for meta in metas:
                    n = len(meta["groups"])
                    out[meta["name"]] = self._assemble(meta, parts[off : off + n], like_state)
                    off += n
        return out

    @staticmethod
    def _assemble(meta: dict, parts: list[torch.Tensor], like_state) -> torch.Tensor:
        """One leaf from its groups' payload bytes, on the device of its
        counterpart in ``like_state`` when given."""
        with telemetry.span("ckpt.restore.assemble"):
            raw = parts[0] if len(parts) == 1 else torch.cat(parts)
            dtype = torch_dtype(meta["dtype"])
            if raw.numel() == 0:
                leaf = torch.empty(meta["shape"], dtype=dtype, device=raw.device)
            else:
                leaf = raw.contiguous().view(dtype).reshape(meta["shape"])
            if like_state is not None:
                leaf = leaf.to(like_state[meta["name"]].device)
        return leaf

    def _load_groups(self, groups: list[_Group]) -> list[torch.Tensor]:
        """Fetch + decode many groups, batching decodes by (K, P).
        Returns each group's payload bytes as a flat uint8 tensor on the
        checkpointer's device."""
        fetched: list[tuple[list[int], list[np.ndarray]]] = []
        with telemetry.span("ckpt.restore.gather"):
            for g in groups:
                rows, chunks = [], []
                for row, node in enumerate(g.node_ids):
                    blob = self.fabric.get(node, f"{g.key}_r{row}")
                    if blob is not None:
                        rows.append(row)
                        chunks.append(np.frombuffer(blob, dtype=np.uint8))
                    if len(rows) == g.k:
                        break
                if len(rows) < g.k:
                    raise IOError(
                        f"checkpoint group {g.key} unrecoverable: "
                        f"{len(rows)}/{g.k} chunks available (P={g.p} exceeded)"
                    )
                fetched.append((rows, chunks))
        # The first K live rows in ascending order are what the codec
        # would pick, so each group's rows go to it as copied.
        staged = self._stage([chunks for _, chunks in fetched])
        with self._meta_lock:
            self.stats["restore_pad_bytes"] += sum(
                mat.numel() - g.orig_nbytes for g, mat in zip(groups, staged))
        gathered = [
            (mat, np.array(rows), g.orig_nbytes)
            for g, (rows, _), mat in zip(groups, fetched, staged)
        ]
        outs: list = [None] * len(groups)
        with telemetry.span("ckpt.restore.decode"):
            for (k, p), idxs in plan_cohorts([(g.k, g.p) for g in groups]):
                codec = ECCodec(k, p, use_kernel=self.policy.use_kernel, device=self.device)
                for i, raw in zip(idxs, codec.decode_many([gathered[i] for i in idxs])):
                    outs[i] = raw
        return outs

    def _stage(self, groups_rows: list[list[np.ndarray]]) -> list[torch.Tensor]:
        """Each group's chunk rows copied straight from the fabric's blobs
        into one new (K, chunk_len) uint8 tensor on the checkpointer's
        device, a non-blocking copy a row on the current stream.  On CUDA
        the host then waits for the copies: once a row's last view is
        gone its block can be written again by a save.  One ``ec.stage``
        span, from the first copy queued to the end of that wait."""
        out: list[torch.Tensor] = []
        waited = 0.0
        with telemetry.span("ec.stage"):
            for rows in groups_rows:
                mat = torch.empty((len(rows), rows[0].size), dtype=torch.uint8,
                                  device=self.device)
                for dst, row in zip(mat, rows):
                    dst.copy_(torch.from_numpy(row), non_blocking=True)
                out.append(mat)
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                t0 = time.perf_counter()
                done.synchronize()
                waited = time.perf_counter() - t0
        with self._meta_lock:
            self.stats["restore_staged_bytes"] += sum(mat.numel() for mat in out)
            self.stats["restore_buffer_wait_s"] += waited
        return out

    # -- failure handling ---------------------------------------------------------

    def on_node_failure(self, node_id: int) -> None:
        self.fabric.fail_node(node_id)

    def repair(self, step: Optional[int] = None, *, strict: bool = True) -> int:
        """Proactive repair: re-encode any group that lost chunks and place
        the replacements through ``PlacementEngine.plan_repair`` (keeps
        (K,P), re-maps; best-effort mode — group health is reported by
        :meth:`group_reliability`).  Returns the number of chunks rebuilt.

        Re-encodes run through the same cached-matrix cohort path as
        ``save`` (one launch per (K, P) cohort of degraded groups).

        A group whose missing chunks cannot *all* be re-placed (not enough
        live nodes with capacity) is left untouched and reported: with
        ``strict=True`` (default) an :class:`IOError` lists every such
        group after the repairable ones were fixed.
        """
        step = step if step is not None else max(self._manifests)
        manifest = self._manifests[step]
        rebuilt = 0
        unplaced: list[tuple[str, int, str]] = []
        # 1. Collect every degraded group (reads only; no mutation yet).
        degraded: list[tuple[dict, _Group, list[tuple[int, int]]]] = []
        for meta in manifest["leaves"]:
            for gd in meta["groups"]:
                g = _Group(**gd)
                missing = [
                    (row, node)
                    for row, node in enumerate(g.node_ids)
                    if self.fabric.get(node, f"{g.key}_r{row}") is None
                ]
                if missing:
                    degraded.append((gd, g, missing))
        if not degraded:
            return 0
        # 2. Cohort re-encode: decode the survivors (raises if > P lost),
        # re-pad exactly as the original encode did (replacement chunks
        # must match the surviving chunks' shape), one launch per (K, P),
        # one copy to the host per cohort.
        payloads = self._load_groups([g for _, g, _ in degraded])
        specs = [(g.k, g.p) for _, g, _ in degraded]
        all_chunks: list = [None] * len(degraded)
        for (k, p), idxs in plan_cohorts(specs):
            codec = ECCodec(k, p, use_kernel=self.policy.use_kernel, device=self.device)
            mats = codec.encode_many([_pad_to_bucket(payloads[i]) for i in idxs])
            for i, chunks in zip(idxs, self._to_host(mats)):
                all_chunks[i] = chunks
        # 3. Re-place + land replacements, group by group (plans see the
        # fabric bytes earlier repairs already landed).
        for (gd, g, missing), chunks in zip(degraded, all_chunks):
            chunk_mb = chunks.shape[1] / 1e6
            missing_rows = {row for row, _ in missing}
            survivors = [
                node
                for row, node in enumerate(g.node_ids)
                if row not in missing_rows
            ]
            with self._place_lock:
                self._item_counter += 1
                item = DataItem(
                    item_id=self._item_counter,
                    size_mb=chunk_mb * g.k,
                    arrival_time=float(step),
                    delta_t_days=self.policy.retention_days,
                    reliability_target=self.policy.reliability_target,
                )
                # require_target=False: the code is fixed at (K, P), so
                # repair is best-effort re-mapping; commit=False because
                # the fabric accounts bytes as chunks land (fabric.put).
                plan = self.engine.plan_repair(
                    item,
                    Placement(k=g.k, p=g.p, node_ids=tuple(g.node_ids)),
                    chunk_mb=chunk_mb,
                    survivors=survivors,
                    allow_parity_growth=False,
                    require_target=False,
                    commit=False,
                )
            if not plan.ok:
                unplaced.append((g.key, len(missing), plan.reason))
                continue
            for (row, _), new_node in zip(missing, plan.new_nodes):
                self.fabric.put(new_node, f"{g.key}_r{row}", _blob(chunks[row]))
                g.node_ids[row] = new_node
                rebuilt += 1
            gd["node_ids"] = g.node_ids
        if unplaced and strict:
            detail = "; ".join(
                f"{key}: {n} missing chunk(s) ({reason})"
                for key, n, reason in unplaced
            )
            raise IOError(
                f"repair left {len(unplaced)} group(s) degraded: {detail}"
            )
        return rebuilt

    def group_reliability(self, step: Optional[int] = None) -> list[float]:
        """Current Pr_avail of every group (post-failure health metric)."""
        step = step if step is not None else max(self._manifests)
        out = []
        for meta in self._manifests[step]["leaves"]:
            for gd in meta["groups"]:
                alive = [n for n in gd["node_ids"] if self.fabric.cluster.alive[n]]
                lost = len(gd["node_ids"]) - len(alive)
                if lost > gd["p"]:
                    out.append(0.0)
                    continue
                fp = self.fabric.cluster.fail_probs(self.policy.retention_days)[alive]
                out.append(poisson_binomial_cdf(fp, gd["p"] - lost))
        return out

    # -- gc -------------------------------------------------------------------------

    def _gc(self, newest_step: int) -> None:
        with self._meta_lock:
            steps = sorted(self._manifests)
            victims = []
            while len(steps) > self.policy.keep_last:
                victim = steps.pop(0)
                victims.append(self._manifests.pop(victim))
        for man in victims:
            for meta in man["leaves"]:
                for gd in meta["groups"]:
                    for row, node in enumerate(gd["node_ids"]):
                        self.fabric.delete(node, f"{gd['key']}_r{row}")

    def close(self) -> None:
        """Shut the save and I/O pools down (waits for running work) and
        release the save's idle host blocks (a block the fabric still
        holds is released when its last view goes)."""
        self._save_pool.shutdown(wait=True)
        self._io_pool.shutdown(wait=True)
        self._save_blocks.close()
