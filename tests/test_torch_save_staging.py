"""A save's host blocks on the CPU: each group's chunk matrix copied into
one reused block, of which the fabric's blobs are views.

A CPU checkpointer's ``manager._HostBlocks`` allocates plain host memory;
here it is also given an allocator that records what it gives and frees,
so the whole block path (take, copy, views, give back, reuse) is
watched without a card.  A block is written again only after every view
of it is gone, sizes are matched exactly, idle blocks stay within one
save's chunk bytes, and ``close`` empties the pool.  Chunk bytes and
manifests are held against the JAX package's, with the checkpointer's
own pool and with the recording one; every comparison is exact.
``test_torch_save_card.py`` holds the page-locked path of a CUDA
checkpointer.
"""

from __future__ import annotations

import gc
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.checkpoint import DRexCheckpointer as JCheckpointer
from repro.checkpoint import StorageFabric as JFabric
from repro.storage import make_node_set as j_node_set
from repro_torch.checkpoint import CheckpointPolicy as TPolicy
from repro_torch.checkpoint import DRexCheckpointer as TCheckpointer
from repro_torch.checkpoint import StorageFabric as TFabric
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.interop import state_dict_from_numpy
from repro_torch.storage import make_node_set as t_node_set

SCALE = 1e-5
ITEM_MB = 0.25
KEEP = 2
#: keeps (K, P) from save to save on these nodes, so every save of one
#: layout takes blocks of the same sizes (D-Rex SC's choice moves here)
STEADY = "drex_lb"


class PlainHost:
    """An allocator of plain host memory that records what it gives and
    frees; ``refuse`` makes it give nothing."""

    def __init__(self, refuse: bool = False):
        self.refuse = refuse
        self.blocks: list[tuple[int, int]] = []  # (address, bytes) of every allocation
        self.freed: list[tuple[int, int]] = []
        self._lock = threading.Lock()

    def __call__(self, nbytes: int):
        if self.refuse:
            return None
        block = torch.empty(nbytes, dtype=torch.uint8)
        ptr = block.data_ptr()
        with self._lock:
            self.blocks.append((ptr, nbytes))

        def free():
            with self._lock:
                self.freed.append((ptr, nbytes))

        return block, free

    @property
    def allocated(self) -> int:
        return sum(n for _, n in self.blocks)

    @property
    def released(self) -> int:
        return sum(n for _, n in self.freed)

    def block_of(self, view: np.ndarray) -> int:
        """The address of the newest allocation a view lies in."""
        ptr = view.ctypes.data
        return [b for b, n in self.blocks if b <= ptr < b + n][-1]


def _leaves(seed: int):
    """The same layout at every seed (the bytes differ): a save of it
    takes blocks of the same sizes."""
    rng = np.random.default_rng(seed)
    return [
        ("w", rng.standard_normal((300, 1000)).astype(np.float32)),  # 5 groups
        ("ids", rng.integers(-2**31, 2**31 - 1, size=(50_000,), dtype=np.int32)),
        ("bytes", rng.integers(0, 256, size=(70_001,), dtype=np.uint8)),
        ("empty", np.zeros((0, 4), dtype=np.float32)),
    ]


def _port(alloc=None, workers=2, wave=3, scheduler="drex_sc"):
    """A CPU checkpointer; with ``alloc`` its host blocks come from it."""
    ck = TCheckpointer(TFabric(t_node_set("most_used", capacity_scale=SCALE)), scheduler,
                       TPolicy(item_mb=ITEM_MB, keep_last=KEEP, pipeline_workers=workers,
                               encode_wave_groups=wave), device="cpu")
    if alloc is not None:
        ck._save_blocks = manager._HostBlocks(alloc)
    return ck


def _reference(workers=2, wave=3):
    return JCheckpointer(JFabric(j_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                         JPolicy(item_mb=ITEM_MB, keep_last=KEEP, pipeline_workers=workers,
                                 encode_wave_groups=wave))


def _save(ck, seed: int, step: int) -> dict:
    return ck.save(state_dict_from_numpy(_leaves(seed), "cpu"), step)


def _chunk_bytes(ck, manifest) -> int:
    """Chunk bytes of a save: (K + P) rows a group."""
    total = 0
    for meta in manifest["leaves"]:
        for g in meta["groups"]:
            blob = next(b for b in (ck.fabric._blobs[n].get(f"{g['key']}_r{r}")
                                    for r, n in enumerate(g["node_ids"])) if b is not None)
            total += len(g["node_ids"]) * len(blob)
    return total


def _as_reference(manifest) -> dict:
    """The manifest as the JAX package writes it (its leaves unnamed)."""
    assert [m["name"] for m in manifest["leaves"]] == [n for n, _ in _leaves(0)]
    return dict(manifest, leaves=[{k: v for k, v in m.items() if k != "name"}
                                  for m in manifest["leaves"]])


def _blobs(ck) -> dict:
    return {(n, k): b for n, held in enumerate(ck.fabric._blobs) for k, b in held.items()}


def _restored_bytes(ck, step) -> list[bytes]:
    return [t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            for t in ck.restore(step).values()]


def _want(seed) -> list[bytes]:
    return [a.tobytes() for _, a in _leaves(seed)]


# -- the pool -------------------------------------------------------------------


def test_a_block_comes_back_only_when_its_last_view_goes():
    alloc = PlainHost()
    pool = manager._HostBlocks(alloc)
    pool.note_save(10_000)
    host, block, fresh = pool.take(1000)
    assert fresh == 1000 and host.size == 1000 and host.ctypes.data == block.data_ptr()
    first = block.data_ptr()
    blob = manager._blob(host[100:200].reshape(4, 25)[1])
    del host, block
    assert pool.idle_bytes == 0  # the blob still views the block
    host, block, fresh = pool.take(1000)
    assert fresh == 1000 and block.data_ptr() != first
    del host, block
    assert pool.idle_bytes == 1000  # the second block came back at once
    view = np.frombuffer(blob, dtype=np.uint8)  # as a restore reads it
    del blob
    host, block, fresh = pool.take(1000)
    assert fresh == 0 and block.data_ptr() != first  # the viewed block is not handed out
    del host, block
    assert pool.idle_bytes == 1000
    del view
    assert pool.idle_bytes == 2000
    host, block, fresh = pool.take(1000)
    assert fresh == 0 and block.data_ptr() == first  # the one given back last
    assert len(alloc.blocks) == 2 and pool.held_bytes == 2000 and alloc.freed == []


@pytest.mark.parametrize("sizes", [(1000, 1001), (4096, 4095, 8192), (1, 2, 3)])
def test_sizes_are_matched_exactly(sizes):
    alloc = PlainHost()
    pool = manager._HostBlocks(alloc)
    pool.note_save(sum(sizes))
    held = [pool.take(n) for n in sizes]
    del held  # every block back on the idle list
    assert pool.idle_bytes == sum(sizes) and len(alloc.blocks) == len(sizes)
    for n in reversed(sizes):
        host, block, fresh = pool.take(n)
        assert fresh == 0 and block.numel() == host.size == n
        assert (block.data_ptr(), n) in alloc.blocks
    host, block, fresh = pool.take(max(sizes) + 1)
    assert fresh == max(sizes) + 1 and len(alloc.blocks) == len(sizes) + 1


def test_idle_blocks_stay_within_one_save_oldest_released_first():
    alloc = PlainHost()
    pool = manager._HostBlocks(alloc)
    pool.note_save(3000)
    pool.note_save(2000)  # the largest save so far holds
    taken = [pool.take(1000) for _ in range(5)]
    ptrs = [block.data_ptr() for _, block, _ in taken]
    while taken:
        taken.pop(0)
        assert pool.idle_bytes <= 3000
    assert pool.idle_bytes == 3000 and pool.held_bytes == 3000
    assert [p for p, _ in alloc.freed] == ptrs[:2]


def test_close_empties_the_pool():
    alloc = PlainHost()
    pool = manager._HostBlocks(alloc)
    pool.note_save(10_000)
    kept = pool.take(700)
    pool.take(500)  # dropped at once: idle
    assert pool.idle_bytes == 500 and pool.held_bytes == 1200
    pool.close()
    assert pool.idle_bytes == 0 and pool.held_bytes == 700 and alloc.released == 500
    del kept
    assert pool.held_bytes == 0 and alloc.released == alloc.allocated == 1200


def test_a_pool_dropped_without_close_releases_its_idle_blocks():
    alloc = PlainHost()
    pool = manager._HostBlocks(alloc)
    pool.note_save(10_000)
    pool.take(100)
    pool.take(200)
    assert alloc.freed == []
    del pool
    gc.collect()
    assert alloc.released == alloc.allocated == 300


def test_a_refused_allocation_takes_nothing():
    pool = manager._HostBlocks(PlainHost(refuse=True))
    pool.note_save(1000)
    assert pool.take(1000) is None
    assert pool.held_bytes == pool.idle_bytes == 0


def test_many_threads_take_and_give_back():
    """More threads than cores and a short switch interval: no block is
    held by two takers at once, and no byte of the accounting is lost."""
    alloc = PlainHost()
    pool = manager._HostBlocks(alloc)
    sizes = (4096, 8192, 12288)
    pool.note_save(3 * sum(sizes))
    in_use: set[int] = set()
    lock = threading.Lock()
    clashes = []

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(200):
            host, block, _ = pool.take(int(rng.choice(sizes)))
            ptr = block.data_ptr()
            del block
            with lock:
                clashes.append(ptr in in_use)
                in_use.add(ptr)
            host[:] = seed % 251  # the taker writes the whole block
            view = host[::7]
            del host
            assert np.all(view == seed % 251)
            with lock:
                in_use.discard(ptr)
            del view

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as ex:
            for f in [ex.submit(work, s) for s in range(16)]:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(before)
    assert not any(clashes)
    assert pool.held_bytes == alloc.allocated - alloc.released
    assert pool.idle_bytes == pool.held_bytes <= 3 * sum(sizes)


# -- the checkpointer -----------------------------------------------------------


@pytest.mark.parametrize("pool", ["default", "recorded"])
@pytest.mark.parametrize("workers,wave", [(0, 16), (2, 3)])
def test_chunks_and_manifests_equal_the_references(pool, workers, wave):
    """Saves with collection, a node loss and a repair: every manifest,
    blob and byte count as the JAX package's, with the CPU checkpointer's
    own plain-memory pool and with a recording allocator."""
    alloc = PlainHost() if pool == "recorded" else None
    ck, ref = _port(alloc, workers, wave), _reference(workers, wave)
    for step in range(1, 5):
        man = _save(ck, step, step)
        jman = ref.save([a for _, a in _leaves(step)], step)
        assert _as_reference(man) == jman
        assert ck.fabric._blobs == ref.fabric._blobs
    victim = man["leaves"][0]["groups"][0]["node_ids"][0]
    ck.on_node_failure(victim)
    ref.fabric.fail_node(victim)
    assert ck.repair() == ref.repair() > 0
    assert {s: _as_reference(m) for s, m in ck._manifests.items()} == ref._manifests
    assert ck.fabric._blobs == ref.fabric._blobs
    assert ck.stats["bytes_stored"] == ref.stats["bytes_stored"]
    assert _restored_bytes(ck, 4) == _want(4)
    assert ck.stats["save_pinned_bytes"] > 0 and ck.stats["save_pageable_bytes"] == 0
    if alloc is not None:
        assert ck.stats["save_pinned_alloc_bytes"] == alloc.allocated
    ck.close()


def test_collected_blocks_are_reused_and_counted():
    alloc = PlainHost()
    ck = _port(alloc, scheduler=STEADY)
    per_save = []
    for step in range(KEEP + 4):
        before = ck.stats["save_pinned_bytes"]
        man = _save(ck, step, step)
        per_save.append(ck.stats["save_pinned_bytes"] - before)
        assert per_save[-1] == _chunk_bytes(ck, man)
        if step == KEEP:
            alloc_after_warmup = ck.stats["save_pinned_alloc_bytes"]
        held = ck._save_blocks
        assert held.idle_bytes <= max(per_save)
        assert held.held_bytes <= (KEEP + 1) * max(per_save)
        assert _restored_bytes(ck, step) == _want(step)
    assert len(set(per_save)) == 1
    assert ck.stats["save_pinned_alloc_bytes"] == alloc_after_warmup == (KEEP + 1) * per_save[0]
    assert ck.stats["save_pageable_bytes"] == 0
    assert alloc.allocated == (KEEP + 1) * per_save[0] and alloc.freed == []
    ck.close()


@pytest.mark.parametrize("holder", ["fail_node", "restore_view"])
def test_a_block_is_written_again_only_after_every_view_is_gone(holder):
    """A checkpoint is collected while part of it is still viewed: by a
    row on a node that is lost afterwards, so that the collection does
    not reach it, or by a restore's view of a blob.  The blocks of that
    checkpoint still viewed are not taken again: their bytes stay as
    saved while later saves run; once the view goes, they are."""
    alloc = PlainHost()
    ck = _port(alloc, scheduler=STEADY)
    man = _save(ck, 0, 0)
    g = man["leaves"][0]["groups"][0]
    key = f"{g['key']}_r0"
    blob = ck.fabric.get(g["node_ids"][0], key)
    held = np.frombuffer(blob, dtype=np.uint8)
    saved = held.copy()
    del blob
    if holder == "fail_node":
        # the row's node is lost: the fabric forgets the row, the test
        # keeps the only view of it, as a reader that got it before would
        ck.on_node_failure(g["node_ids"][0])
    home = alloc.block_of(held)
    for step in range(1, KEEP + 4):
        _save(ck, step, step)
        assert np.array_equal(held, saved)
        assert all(alloc.block_of(np.frombuffer(b, dtype=np.uint8)) != home
                   for (_, key), b in _blobs(ck).items() if not key.startswith("ck0_"))
        assert _restored_bytes(ck, step) == _want(step)
    assert 0 not in ck._manifests
    reused_before = ck.stats["save_pinned_bytes"] - ck.stats["save_pinned_alloc_bytes"]
    assert reused_before > 0  # the other blocks of step 0 were taken again
    del held
    _save(ck, 99, KEEP + 4)
    assert any(alloc.block_of(np.frombuffer(b, dtype=np.uint8)) == home
               for b in _blobs(ck).values())
    assert _restored_bytes(ck, KEEP + 4) == _want(99)
    ck.close()


def test_a_refused_block_takes_the_pageable_copy():
    ck, ref = _port(PlainHost(refuse=True)), _reference()
    chunk_bytes = 0
    for step in (1, 2, 3):
        want = ref.save([a for _, a in _leaves(step)], step)
        man = _save(ck, step, step)
        assert _as_reference(man) == want
        chunk_bytes += _chunk_bytes(ck, man)
    assert ck.fabric._blobs == ref.fabric._blobs
    assert ck.stats["save_pinned_bytes"] == ck.stats["save_pinned_alloc_bytes"] == 0
    assert ck.stats["save_pageable_bytes"] == chunk_bytes
    ck.close()


def test_close_releases_idle_blocks_and_the_rest_as_views_go():
    alloc = PlainHost()
    ck = _port(alloc, scheduler=STEADY)
    for step in range(KEEP + 1):
        _save(ck, step, step)
    assert ck._save_blocks.idle_bytes > 0  # step 0's blocks, collected
    ck.close()
    pool = ck._save_blocks
    assert pool.idle_bytes == 0 and 0 < pool.held_bytes < alloc.allocated
    assert _restored_bytes(ck, KEEP) == _want(KEEP)  # the fabric's blobs still read
    for node in range(len(ck.fabric.nodes)):
        ck.fabric.fail_node(node)
    assert pool.held_bytes == 0 and alloc.released == alloc.allocated


def test_async_saves_beside_restores_on_another_thread():
    """Async saves while another thread restores the newest checkpoint
    again and again: every restore gives back the bytes of the step it
    read, though the blocks of collected checkpoints are taken again."""
    alloc = PlainHost()
    ck = _port(alloc, scheduler=STEADY)
    _save(ck, 0, 0)
    stop = threading.Event()
    bad = []

    def restores():
        n = 0
        while not stop.is_set() or n == 0:
            step = max(ck._manifests)
            try:
                got = _restored_bytes(ck, step)
            except (KeyError, IOError):  # collected before or while it was read
                continue
            bad.append(got != _want(step))
            n += 1
        return n

    with ThreadPoolExecutor(1) as ex:
        reader = ex.submit(restores)
        for step in range(1, 8):
            ck.save_async(state_dict_from_numpy(_leaves(step), "cpu"), step).result(timeout=120)
        stop.set()
        assert reader.result(timeout=120) > 0
    assert bad and not any(bad)
    assert ck.stats["save_pinned_alloc_bytes"] < ck.stats["save_pinned_bytes"]
    ck.close()
