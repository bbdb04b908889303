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
once per wave, and each wave's fabric ``put`` overlaps the *next* wave's
encode through a multi-worker I/O pool (double-buffered — at most two
waves of chunks are in flight).  ``pipeline_workers=0`` is the serial
path (per-group encode then put).  Only the calling thread launches
kernels; the I/O pool handles host bytes only.

The state is an ordered ``dict[str, torch.Tensor]`` (a ``state_dict``);
leaf order is the dict's order and the manifest records each leaf's
name, shape and dtype.  Leaf bytes are the tensor's raw bytes
(``view(torch.uint8)``), so bf16 and every other dtype round-trip
bit-exactly.  Group placement, padding, chunk bytes and fabric keys are
identical to the JAX package's ``repro.checkpoint.manager`` for the same
leaf bytes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Mapping, Optional

import numpy as np
import torch

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


def _pad_to_bucket(payload: torch.Tensor) -> torch.Tensor:
    """Pad to power-of-two bucket sizes so the codec sees a bounded set of
    chunk shapes — <=2x padding on the tail group only.  Every
    (re-)encode of a group MUST go through this so repaired chunks keep
    the shape of the surviving ones."""
    bucket = 4096
    n = payload.numel()
    while bucket < n:
        bucket <<= 1
    if bucket == n:
        return payload
    out = payload.new_zeros(bucket)
    out[:n] = payload
    return out


def _to_host(chunk_mats: list[torch.Tensor]) -> list[np.ndarray]:
    """One device-to-host copy for a list of chunk matrices; returns
    numpy views of the one host buffer, shaped like the inputs."""
    if not chunk_mats:
        return []
    flat = torch.cat([c.reshape(-1) for c in chunk_mats]).cpu().numpy()
    out, off = [], 0
    for c in chunk_mats:
        n = c.numel()
        out.append(flat[off : off + n].reshape(tuple(c.shape)))
        off += n
    return out


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
        self.engine = PlacementEngine(fabric.cluster, scheduler, auto_commit=False)
        self.scheduler = self.engine.scheduler
        self.policy = policy or CheckpointPolicy()
        self._manifests: dict[int, dict] = {}
        # save_async's finishers wait only on I/O futures, never on each
        # other, so two overlapping saves cannot deadlock.
        self._save_pool = ThreadPoolExecutor(max_workers=2)
        self._io_pool = ThreadPoolExecutor(
            max_workers=max(1, self.policy.pipeline_workers)
        )
        #: serializes the placement phase (engine + item-id counter) so
        #: concurrent saves see consistent cluster snapshots.
        self._place_lock = threading.Lock()
        self._meta_lock = threading.Lock()
        self._item_counter = 0
        self.stats: dict[str, float] = {
            "bytes_raw": 0.0, "bytes_stored": 0.0, "encode_s": 0.0, "place_s": 0.0,
        }

    # -- save -------------------------------------------------------------------

    def save(self, state: Mapping[str, torch.Tensor], step: int) -> dict:
        """Encode→place→write one checkpoint through the batched pipeline.

        Placement decisions for all groups are made against the cluster
        view at the start of the save (one ``place_many`` batch) — the
        fabric's byte accounting still updates as chunks land."""
        manifest, groups, slots, pending = self._encode_and_submit(state, step)
        self._drain(pending)
        return self._finish(manifest, groups, slots, step)

    def save_async(self, state: Mapping[str, torch.Tensor], step: int) -> Future:
        """Place and encode on the calling thread (a consistent snapshot,
        and the only thread that launches kernels), land the chunks in the
        background.  The future resolves to the manifest once every chunk
        is on the fabric; a failure in any phase is raised by
        ``result()``."""
        try:
            manifest, groups, slots, pending = self._encode_and_submit(state, step)
        except Exception as exc:  # surface through the future, like a put error
            failed: Future = Future()
            failed.set_exception(exc)
            return failed

        def finish():
            self._drain(pending)
            return self._finish(manifest, groups, slots, step)

        return self._save_pool.submit(finish)

    def _encode_and_submit(self, state, step):
        """Phases 1-3 of a save: split, place, encode waves.  Returns the
        manifest skeleton, the groups, their (leaf, part) slots and the
        pending put futures."""
        manifest: dict[str, Any] = {"step": step, "leaves": []}
        policy = self.policy
        max_bytes = int(policy.item_mb * 1e6)
        # 1. Split every leaf into group payloads (bucket-padded).
        payloads: list[torch.Tensor] = []
        orig_lens: list[int] = []
        slots: list[tuple[int, int]] = []  # (leaf_i, part)
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
        # 2. One placement batch: groups share retention and reliability
        # target, so the engine's batch context amortizes the scheduler's
        # reliability DP across all groups of this save.
        with self._place_lock:
            items = []
            for payload in payloads:
                self._item_counter += 1
                items.append(DataItem(
                    item_id=self._item_counter,
                    size_mb=max(payload.numel() / 1e6, 1e-6),
                    arrival_time=float(step),
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
        # 3. Cohort waves: encode wave i+1 while wave i's chunks land.
        groups: list[Optional[_Group]] = [None] * len(payloads)
        wave_size = 1 if policy.pipeline_workers == 0 else max(
            1, policy.encode_wave_groups
        )
        waves: list[list[int]] = []
        for (_kp, idxs) in plan_cohorts([(pl.k, pl.p) for pl in placements]):
            for w in range(0, len(idxs), wave_size):
                waves.append(idxs[w : w + wave_size])
        pending: deque[Future] = deque()
        try:
            self._encode_waves(
                waves, payloads, placements, slots, orig_lens, groups,
                step, pending,
            )
        except BaseException:
            while pending:  # no orphaned background puts behind an error
                try:
                    pending.popleft().result()
                except Exception:
                    pass
            raise
        return manifest, groups, slots, pending

    @staticmethod
    def _drain(pending: deque) -> None:
        try:
            while pending:
                pending.popleft().result()
        finally:
            while pending:  # no orphaned puts behind a failed one
                try:
                    pending.popleft().result()
                except Exception:
                    pass

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
        """Encode each wave, copy its chunks to the host once, and hand
        them to the I/O pool."""
        policy = self.policy
        for wave in waves:
            k, p = placements[wave[0]].k, placements[wave[0]].p
            codec = ECCodec(k, p, use_kernel=policy.use_kernel, device=self.device)
            t0 = time.perf_counter()
            # encode_s covers the coding and the wave's one copy to the
            # host (which waits for the kernel).
            chunk_mats = _to_host(codec.encode_many([payloads[i] for i in wave]))
            with self._meta_lock:
                self.stats["encode_s"] += time.perf_counter() - t0
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
                while len(pending) > 2:
                    pending.popleft().result()

    def _put_wave(self, entries: list[tuple[_Group, np.ndarray]]) -> None:
        """Land one wave's chunks on the fabric (runs on the I/O pool)."""
        stored = 0.0
        for g, chunks in entries:
            for row, node in enumerate(g.node_ids):
                self.fabric.put(node, f"{g.key}_r{row}", chunks[row].tobytes())
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
        lands on the device of its counterpart there."""
        manifest = self._manifests[step]
        leaves_meta = manifest["leaves"]
        if like_state is not None and list(like_state) != [
            m["name"] for m in leaves_meta
        ]:
            raise ValueError("state structure mismatch: leaf names differ")
        out: dict[str, torch.Tensor] = {}
        for meta in leaves_meta:
            # All groups of a leaf decode in cohort launches (per (K, P)
            # and erasure pattern) instead of one kernel call per group.
            parts = self._load_groups([_Group(**g) for g in meta["groups"]])
            raw = parts[0] if len(parts) == 1 else torch.cat(parts)
            dtype = torch_dtype(meta["dtype"])
            if raw.numel() == 0:
                leaf = torch.empty(meta["shape"], dtype=dtype, device=raw.device)
            else:
                leaf = raw.contiguous().view(dtype).reshape(meta["shape"])
            if like_state is not None:
                leaf = leaf.to(like_state[meta["name"]].device)
            out[meta["name"]] = leaf
        return out

    def _load_groups(self, groups: list[_Group]) -> list[torch.Tensor]:
        """Fetch + decode many groups, batching decodes by (K, P).
        Returns each group's payload bytes as a flat uint8 tensor on the
        checkpointer's device."""
        gathered: list[tuple[np.ndarray, np.ndarray, int]] = []
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
            gathered.append((np.stack(chunks), np.array(rows), g.orig_nbytes))
        outs: list = [None] * len(groups)
        for (k, p), idxs in plan_cohorts([(g.k, g.p) for g in groups]):
            codec = ECCodec(k, p, use_kernel=self.policy.use_kernel, device=self.device)
            for i, raw in zip(idxs, codec.decode_many([gathered[i] for i in idxs])):
                outs[i] = raw
        return outs

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
            for i, chunks in zip(idxs, _to_host(mats)):
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
                self.fabric.put(new_node, f"{g.key}_r{row}", chunks[row].tobytes())
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
        """Shut the save and I/O pools down (waits for running work)."""
        self._save_pool.shutdown(wait=True)
        self._io_pool.shutdown(wait=True)
