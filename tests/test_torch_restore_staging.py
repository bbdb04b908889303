"""A restore's copies on the CPU: each group's first K live chunk rows
are copied once, straight from the fabric's blobs, into one
(K, chunk_len) uint8 tensor, which the codec takes as it is.  Restored
bytes are held against the JAX package's restore of the same leaves
after the same losses, also from blobs that are ``bytes`` (what a
``persist_dir`` reload holds) in place of views of the save's blocks;
every comparison is exact.  ``test_torch_restore_card.py`` holds a CUDA
checkpointer's copies from its page-locked blocks.
"""

from __future__ import annotations

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import ml_dtypes
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
from repro_torch.checkpoint import manager as tmanager
from repro_torch.checkpoint.interop import state_dict_from_numpy
from repro_torch.ec import ECCodec
from repro_torch.kernels import ops as tops
from repro_torch.storage import make_node_set as t_node_set

SCALE = 1e-5
ITEM_MB = 0.25
LOSSES = ("none", "data_row", "p_rows")


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [
        ("w", rng.standard_normal((300, 1000)).astype(np.float32)),  # 5 groups
        ("bf16", rng.standard_normal((123, 77)).astype(ml_dtypes.bfloat16)),
        ("i8", rng.integers(-128, 128, size=(1001,), dtype=np.int8)),
        ("flag", rng.integers(0, 2, size=(7, 3)).astype(bool)),
        ("f64", rng.standard_normal((33, 5))),
        ("empty", np.zeros((0, 4), dtype=np.float32)),  # a group of orig_nbytes 0
        ("bytes", rng.integers(0, 256, size=(70_001,), dtype=np.uint8)),
    ]


def _port():
    return TCheckpointer(TFabric(t_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                         TPolicy(item_mb=ITEM_MB), device="cpu")


def _reference():
    return JCheckpointer(JFabric(j_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                         JPolicy(item_mb=ITEM_MB))


def _groups(manifest) -> list[dict]:
    return [g for m in manifest["leaves"] for g in m["groups"]]


def _victims(manifest, loss: str) -> list[int]:
    """The nodes a loss takes: none, the node of the first group's row 0
    (a parity row is then among its K), or its first P nodes."""
    g = _groups(manifest)[0]
    return {"none": [], "data_row": g["node_ids"][:1], "p_rows": g["node_ids"][: g["p"]]}[loss]


def _chunk_len(fabric, g) -> int:
    for row, node in enumerate(g["node_ids"]):
        blob = fabric.get(node, f"{g['key']}_r{row}")
        if blob is not None:
            return len(blob)
    raise AssertionError(g["key"])


def _saved(loss, seed=0):
    """(port, manifest, leaves) after a save and the loss."""
    leaves = _leaves(seed)
    ck = _port()
    man = ck.save(state_dict_from_numpy(leaves, "cpu"), 1)
    for node in _victims(man, loss):
        ck.on_node_failure(node)
    return ck, man, leaves


def _bytes(state) -> dict:
    return {k: v.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            for k, v in state.items()}


@pytest.mark.parametrize("loss", LOSSES)
def test_restore_equals_the_references(loss):
    leaves = _leaves(1)
    ck, ref = _port(), _reference()
    man = ck.save(state_dict_from_numpy(leaves, "cpu"), 1)
    jman = ref.save([a for _, a in leaves], 1)
    assert any(g["orig_nbytes"] == 0 for g in _groups(man))
    for node in _victims(jman, loss):
        ck.on_node_failure(node)
        ref.fabric.fail_node(node)
    tops.reset_matrix_caches()
    got = _bytes(ck.restore(1))
    assert (tops.matrix_cache_stats()["decode_builds"] > 0) is (loss != "none")
    want = [np.ascontiguousarray(a).tobytes() for a in ref.restore(1, [a for _, a in leaves])]
    assert list(got.values()) == want == [a.tobytes() for _, a in leaves]
    ck.close()


@pytest.mark.parametrize("loss", LOSSES)
def test_staged_rows_are_a_copy_and_blobs_stay(loss, monkeypatch):
    ck, _man, leaves = _saved(loss, seed=2)
    blobs = [(node, key, blob) for node, held in enumerate(ck.fabric._blobs)
             for key, blob in held.items()]
    before = [bytes(b) for _, _, b in blobs]
    staged = []
    decode_many = ECCodec.decode_many

    def recording(self, parts):
        staged.extend(chunks for chunks, _rows, _n in parts)
        return decode_many(self, parts)

    monkeypatch.setattr(tmanager.ECCodec, "decode_many", recording)
    got = _bytes(ck.restore(1))
    assert list(got.values()) == [a.tobytes() for _, a in leaves]
    assert staged and all(isinstance(t, torch.Tensor) and t.dtype == torch.uint8
                          for t in staged)
    views = [np.frombuffer(b, dtype=np.uint8) for _, _, b in blobs]
    for t in staged:
        mat = t.numpy()
        assert not any(np.shares_memory(mat, v) for v in views)
    assert [bytes(b) for _, _, b in blobs] == before
    assert [(n, k) for n, held in enumerate(ck.fabric._blobs) for k in held] == [
        (n, k) for n, k, _ in blobs]
    ck.close()


@pytest.mark.parametrize("rows", [[0, 1, 2, 3], [0, 2, 3, 5], [1, 3, 4, 5]])
def test_select_rows_passes_k_ascending_rows_through(rows):
    codec = ECCodec(4, 2, device="cpu")
    chunks = torch.arange(4 * 9, dtype=torch.uint8).reshape(4, 9)
    got, got_rows = codec._select_rows(chunks, np.array(rows))
    assert got is chunks
    np.testing.assert_array_equal(got_rows, rows)


@pytest.mark.parametrize("rows", [[3, 0, 1, 2], [5, 2, 0, 3], [0, 1, 2, 3, 4],
                                  [5, 4, 1, 0, 2], [1, 3, 4, 5, 0, 2]])
def test_select_rows_of_a_tensor_equal_the_numpy_branch(rows):
    """Rows out of order, or more than K: the tensor branch picks what
    the numpy branch picks, and the decode gives the same payload."""
    rng = np.random.default_rng(len(rows) * 7 + rows[0])
    codec = ECCodec(4, 2, device="cpu")
    payload = rng.integers(0, 256, size=4 * 1000 - 3, dtype=np.uint8)
    full = codec.encode(payload).numpy()
    chunks = full[rows]
    got, got_rows = codec._select_rows(torch.from_numpy(chunks.copy()), np.array(rows))
    want, want_rows = codec._select_rows(chunks, np.array(rows))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got_rows, want_rows)
    (dec,) = codec.decode_many([(torch.from_numpy(chunks.copy()), rows, payload.size)])
    np.testing.assert_array_equal(dec.numpy(), payload)
    np.testing.assert_array_equal(codec.decode(chunks, rows, payload.size).numpy(), payload)


@pytest.mark.parametrize("loss", LOSSES)
def test_staging_counters(loss):
    ck, man, _leaves_ = _saved(loss, seed=3)
    want = sum(g["k"] * _chunk_len(ck.fabric, g) for g in _groups(man))
    assert want > 0
    for n in (1, 2):
        ck.restore(1)
        assert ck.stats["restore_staged_bytes"] == n * want
        assert ck.stats["restore_buffer_wait_s"] == 0.0
    ck.close()


@pytest.mark.parametrize("loss", LOSSES)
def test_a_restore_from_bytes_blobs_equals_one_from_block_views(loss):
    """Every blob replaced by ``bytes`` of it, as a ``persist_dir`` reload
    holds them: the restore takes the same copies and gives the same
    bytes as the restore of the save's views."""
    ck, _man, leaves = _saved(loss, seed=6)
    held = ck.fabric._blobs
    assert all(isinstance(b, memoryview) for blobs in held for b in blobs.values())
    views = _bytes(ck.restore(1))
    staged = ck.stats["restore_staged_bytes"]
    for blobs in held:
        for key, blob in blobs.items():
            blobs[key] = bytes(blob)
    assert _bytes(ck.restore(1)) == views
    assert list(views.values()) == [a.tobytes() for _, a in leaves]
    assert ck.stats["restore_staged_bytes"] == 2 * staged
    ck.close()


@pytest.mark.parametrize("loss", LOSSES)
def test_two_threads_restore_at_once(loss):
    ck, _man, leaves = _saved(loss, seed=4)
    want = [a.tobytes() for _, a in leaves]
    start = threading.Barrier(2)

    def restores():
        start.wait(timeout=60)
        return [list(_bytes(ck.restore(1)).values()) for _ in range(3)]

    with ThreadPoolExecutor(2) as pool:
        results = [f.result(timeout=120) for f in [pool.submit(restores) for _ in range(2)]]
    assert all(got == want for res in results for got in res)
    ck.close()


def test_many_threads_restore_and_count():
    """More threads than cores and a short switch interval: every restore
    is exact and no staging count is lost."""
    ck, man, leaves = _saved("data_row", seed=5)
    want = [a.tobytes() for _, a in leaves]
    per_restore = sum(g["k"] * _chunk_len(ck.fabric, g) for g in _groups(man))
    threads, each = 16, 2
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            futures = [pool.submit(lambda: [list(_bytes(ck.restore(1)).values())
                                            for _ in range(each)]) for _ in range(threads)]
            results = [f.result(timeout=300) for f in futures]
    finally:
        sys.setswitchinterval(before)
    assert all(got == want for res in results for got in res)
    assert ck.stats["restore_staged_bytes"] == threads * each * per_restore
    ck.close()
