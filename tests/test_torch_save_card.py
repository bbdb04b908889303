"""A CUDA save's page-locked host blocks on a card: back-to-back saves of
a ~290 MB state, changed before each, land every wave through reused
page-locked blocks; every chunk of the last save equals a CPU encode of
the state as it was saved.  After ``keep_last`` + 2 saves no block is
page-locked anew, none falls back to the pageable copy, and the blocks
held stay within ``keep_last`` + 1 saves' chunk bytes (x1.1).
Async saves beside restores on another thread, and a repair after a node
loss, give back the saved bytes.  Without a card every case skips
(decided inside the test); jax is not imported.

    PYTHONPATH=src python3 -m pytest -s tests/test_torch_save_card.py
"""

from __future__ import annotations

import mmap
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.checkpoint import manager
from repro_torch.ec import ECCodec
from repro_torch.storage import make_node_set

KEEP = CheckpointPolicy().keep_last
SAVES = KEEP + 4
#: two bytes every this many take the step's number before each save
TOUCH_STRIDE = 1 << 20


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(29)
    return {
        "big": torch.randn((12_288, 8_192), generator=gen, device=device).to(torch.bfloat16),
        "f32": torch.randn((3_000, 7_001), generator=gen, device=device),
        "i8": torch.randint(-128, 128, (17,), generator=gen, device=device, dtype=torch.int8),
        "empty": torch.empty((0, 4), device=device),
    }


def _touch(state, step: int) -> None:
    """The state as training changes it: in every leaf the bytes at each
    multiple of ``TOUCH_STRIDE`` take the step's number."""
    for t in state.values():
        if t.numel():
            t.view(-1).view(torch.uint8)[::TOUCH_STRIDE] = step % 251


def _as_saved(base, step: int) -> dict[str, torch.Tensor]:
    state = {k: v.clone() for k, v in base.items()}
    _touch(state, step)
    return state


def _checkpointer(card) -> DRexCheckpointer:
    return DRexCheckpointer(StorageFabric(make_node_set("most_used")), "drex_sc",
                            CheckpointPolicy(), device=card)


def _mismatched(out, state) -> int:
    bad = 0
    for name, want in state.items():
        got = out[name]
        assert got.dtype == want.dtype and got.shape == want.shape and got.is_cuda
        bad += int((got.view(-1).view(torch.uint8) != want.view(-1).view(torch.uint8)).sum())
    return bad


def _chunks_against_cpu(ck, manifest, state) -> tuple[int, int]:
    """(chunk bytes of the save, bytes of them that differ from a CPU
    encode of the state's groups)."""
    group_bytes = int(ck.policy.item_mb * 1e6)
    total = bad = 0
    for meta in manifest["leaves"]:
        raw = state[meta["name"]].contiguous().view(-1).view(torch.uint8).cpu()
        for part, g in enumerate(meta["groups"]):
            payload = manager._pad_to_bucket(raw[part * group_bytes:][: g["orig_nbytes"]])
            want = ECCodec(g["k"], g["p"], device="cpu").encode(payload).numpy()
            for row, node in enumerate(g["node_ids"]):
                blob = ck.fabric.get(node, f"{g['key']}_r{row}")
                got = np.frombuffer(blob, dtype=np.uint8)
                total += got.size
                bad += int((got != want[row]).sum())
    return total, bad


def test_back_to_back_saves_reuse_page_locked_blocks(card):
    state = _state(card)
    ck = _checkpointer(card)
    per_save, alloc, seconds = [], [], []
    for step in range(SAVES):
        _touch(state, step)
        before = ck.stats["save_pinned_bytes"]
        t0 = time.perf_counter()
        man = ck.save(state, step)
        seconds.append(time.perf_counter() - t0)
        per_save.append(ck.stats["save_pinned_bytes"] - before)
        alloc.append(ck.stats["save_pinned_alloc_bytes"])
        assert ck._save_blocks.held_bytes <= 1.1 * (KEEP + 1) * max(per_save)
        assert ck._save_blocks.idle_bytes <= max(per_save)
    total, bad = _chunks_against_cpu(ck, man, state)
    assert bad == 0 and total == per_save[-1]
    assert ck.stats["save_pageable_bytes"] == 0
    # the first save, on an empty cluster, is placed at other (K, P) than
    # the rest, so the save that would take its blocks page-locks its own
    # instead; from the next on, nothing is page-locked anew
    assert alloc[KEEP + 1:] == [alloc[KEEP + 1]] * (SAVES - KEEP - 1)
    assert _mismatched(ck.restore(SAVES - 1), state) == 0
    print({"saves": SAVES, "chunk_bytes": per_save, "pinned_alloc_bytes": alloc,
           "held_bytes": ck._save_blocks.held_bytes, "idle_bytes": ck._save_blocks.idle_bytes,
           "save_s": [round(s, 4) for s in seconds],
           "device": torch.cuda.get_device_name(card)})
    ck.close()
    assert ck._save_blocks.idle_bytes == 0


def test_async_saves_beside_restores_on_another_thread(card):
    base = _state(card)
    state = {k: v.clone() for k, v in base.items()}
    ck = _checkpointer(card)
    _touch(state, 0)
    ck.save(state, 0)
    stop = threading.Event()

    checked = []

    def restores():
        while not stop.is_set() or not checked:
            step = max(ck._manifests)
            try:
                out = ck.restore(step)
            except (KeyError, IOError):  # collected before or while it was read
                continue
            torch.cuda.synchronize(card)
            checked.append(_mismatched(out, _as_saved(base, step)))
        return checked

    with ThreadPoolExecutor(1) as pool:
        reader = pool.submit(restores)
        step = 1
        while step < SAVES or (len(checked) < 3 and step < 100):
            _touch(state, step)
            ck.save_async(state, step).result(timeout=300)
            step += 1
        stop.set()
        assert reader.result(timeout=300) is checked
    assert len(checked) >= 3 and checked == [0] * len(checked)
    assert ck.stats["save_pageable_bytes"] == 0
    assert ck.stats["save_pinned_alloc_bytes"] < ck.stats["save_pinned_bytes"]
    print({"saves": step, "restores_checked": len(checked),
           "pinned_bytes": ck.stats["save_pinned_bytes"],
           "pinned_alloc_bytes": ck.stats["save_pinned_alloc_bytes"]})
    ck.close()


def test_repair_after_a_node_loss(card):
    state = _state(card)
    ck = _checkpointer(card)
    for step in range(KEEP + 1):
        _touch(state, step)
        man = ck.save(state, step)
    victim = man["leaves"][0]["groups"][0]["node_ids"][0]
    ck.on_node_failure(victim)
    assert ck.repair() > 0
    man = ck._manifests[KEEP]
    assert all(victim not in g["node_ids"] for m in man["leaves"] for g in m["groups"])
    _total, bad = _chunks_against_cpu(ck, man, state)
    assert bad == 0
    assert _mismatched(ck.restore(KEEP), state) == 0
    assert ck.stats["save_pageable_bytes"] == 0
    ck.close()


def test_refused_page_locking_takes_the_pageable_copy(card, monkeypatch):
    """Where CUDA refuses to page-lock a block (here every mapping
    the blocks are made from is registered already), each wave takes the
    pageable copy and is counted; the refusal leaves no CUDA error for the
    next kernel launch, and the chunks are the same."""
    cudart, real_mmap, registered = torch.cuda.cudart(), mmap.mmap, []

    def taken(fileno, size, **kw):
        mm = real_mmap(fileno, size, **kw)
        block = torch.frombuffer(mm, dtype=torch.uint8)
        assert int(cudart.cudaHostRegister(block.data_ptr(), size, 0)) == 0
        registered.append(block)
        return mm

    state = _state(card)
    ck = _checkpointer(card)
    monkeypatch.setattr(manager.mmap, "mmap", taken)
    try:
        chunk_bytes = 0
        for step in range(2):  # the second save's kernels run after the refusals
            _touch(state, step)
            man = ck.save(state, step)
            total, bad = _chunks_against_cpu(ck, man, state)
            assert bad == 0
            chunk_bytes += total
    finally:
        monkeypatch.undo()
        for block in registered:
            cudart.cudaHostUnregister(block.data_ptr())
    assert registered  # every wave was refused
    assert ck.stats["save_pageable_bytes"] == chunk_bytes
    assert ck.stats["save_pinned_bytes"] == ck.stats["save_pinned_alloc_bytes"] == 0
    assert ck._save_blocks.held_bytes == 0
    assert _mismatched(ck.restore(1), state) == 0
    ck.close()
