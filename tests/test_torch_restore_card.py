"""A CUDA restore's copies on a card: back-to-back restores of a ~290 MB
state with a data-carrying node lost, each compared byte for byte with
the state, also from two threads at once.  Each chunk row is copied to
the card straight from the fabric's blob, a view of the save's
page-locked block: after the first restore no restore allocates
page-locked memory, and a profiled restore's host-to-device copies all
read as from pinned memory.  Without a card every case skips (decided
inside the test); jax is not imported.

    PYTHONPATH=src python3 -m pytest tests/test_torch_restore_card.py
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.storage import make_node_set

RESTORES = 4


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(27)
    return {
        "big": torch.randn((12_288, 8_192), generator=gen, device=device).to(torch.bfloat16),
        "f32": torch.randn((3_000, 7_001), generator=gen, device=device),
        "i8": torch.randint(-128, 128, (17,), generator=gen, device=device, dtype=torch.int8),
        "empty": torch.empty((0, 4), device=device),
    }


def _host_allocs() -> int:
    stats = torch.cuda.host_memory_stats()
    return int(stats.get("num_host_alloc", stats.get("allocations.allocated", 0)))


def _pinned_bytes() -> int:
    return int(torch.cuda.host_memory_stats().get("allocated_bytes.current", 0))


def _mismatched(out, state) -> int:
    bad = 0
    for name, want in state.items():
        got = out[name]
        assert got.dtype == want.dtype and got.shape == want.shape and got.is_cuda
        bad += int((got.view(-1).view(torch.uint8) != want.view(-1).view(torch.uint8)).sum())
    return bad


@pytest.mark.parametrize("threads", [1, 2])
def test_back_to_back_restores_after_a_node_loss(card, threads):
    state = _state(card)
    ck = DRexCheckpointer(StorageFabric(make_node_set("most_used")), "drex_sc",
                          CheckpointPolicy(), device=card)
    man = ck.save(state, 1)
    groups = [g for m in man["leaves"] for g in m["groups"]]
    assert len(groups) >= 5
    ck.on_node_failure(groups[0]["node_ids"][0])  # row 0 of the first group: a decode
    lens = [next(len(b) for b in (ck.fabric.get(node, f"{g['key']}_r{row}")
                                  for row, node in enumerate(g["node_ids"])) if b is not None)
            for g in groups]
    staged = sum(g["k"] * n for g, n in zip(groups, lens))
    # a scalar read from the card takes a small page-locked block of its
    # own: warm it before counting
    assert _mismatched(state, state) == 0
    allocs, pinned = _host_allocs(), _pinned_bytes()
    first = ck.restore(1)
    torch.cuda.synchronize(card)
    after_first, pinned_after_first = _host_allocs(), _pinned_bytes()
    assert after_first - allocs <= 1  # one allocation, or torch's cached one reused
    assert _mismatched(first, state) == 0
    start = threading.Barrier(threads)

    def restores():
        start.wait(timeout=60)
        return [ck.restore(1) for _ in range(RESTORES)]  # not waited for between them

    with ThreadPoolExecutor(threads) as pool:
        outs = [o for f in [pool.submit(restores) for _ in range(threads)]
                for o in f.result(timeout=600)]
    torch.cuda.synchronize(card)
    assert [_mismatched(o, state) for o in outs] == [0] * len(outs)
    n = 1 + threads * RESTORES
    assert ck.stats["restore_staged_bytes"] == n * staged
    assert _host_allocs() == after_first and _pinned_bytes() == pinned_after_first
    print({"threads": threads, "groups": len(groups), "restores": n,
           "first_restore_pinned_bytes": pinned_after_first - pinned,
           "buffer_wait_s": ck.stats["restore_buffer_wait_s"],
           "host_memory_stats": {k: v for k, v in torch.cuda.host_memory_stats().items()
                                 if k.startswith(("num_host", "allocated_bytes"))}})
    ck.close()


def test_a_restore_copies_from_pinned_memory_only(card):
    """A profiled restore of block-view blobs: every host-to-device copy
    the card runs reads as from pinned memory, and none as pageable."""
    state = _state(card)
    ck = DRexCheckpointer(StorageFabric(make_node_set("most_used")), "drex_sc",
                          CheckpointPolicy(), device=card)
    man = ck.save(state, 1)
    ck.on_node_failure(man["leaves"][0]["groups"][0]["node_ids"][0])
    ck.restore(1)  # warm: the decode's matrices are built and moved once
    torch.cuda.synchronize(card)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = ck.restore(1)
        torch.cuda.synchronize(card)
    copies = {e.key: e.count for e in prof.key_averages() if e.key.startswith("Memcpy HtoD")}
    print({"htod": copies})
    assert _mismatched(out, state) == 0
    assert copies and set(copies) == {"Memcpy HtoD (Pinned -> Device)"}, copies
    ck.close()
