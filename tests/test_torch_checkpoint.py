"""The slice as a whole: the port's checkpoint plane held against the JAX
package's on the same leaves.

The same seeded numpy leaves go through ``repro.checkpoint`` (as a list:
a dict would be key-sorted by ``jax.tree``) and through
``repro_torch.checkpoint`` (as a ``state_dict`` on the CPU).  Groups,
placements, chunk blobs, repairs and restores must be identical:
every comparison is exact equality.
"""

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
from repro_torch.checkpoint.interop import import_manifest, state_dict_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.storage import make_node_set as t_node_set

SCALE = 1e-5
ITEM_MB = 0.25


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [
        ("w", rng.standard_normal((300, 1000)).astype(np.float32)),  # 5 groups
        ("ids", rng.integers(-2**31, 2**31 - 1, size=(50_000,), dtype=np.int32)),
        ("bytes", rng.integers(0, 256, size=(70_001,), dtype=np.uint8)),
        ("empty", np.zeros((0, 4), dtype=np.float32)),
        ("scalar", np.array(3.5, dtype=np.float32)),
    ]


def _pair(workers=2, wave=16, use_kernel=True, persist_dir=None):
    jfab = JFabric(j_node_set("most_used", capacity_scale=SCALE), persist_dir=persist_dir)
    tfab = TFabric(t_node_set("most_used", capacity_scale=SCALE))
    kw = dict(item_mb=ITEM_MB, pipeline_workers=workers, encode_wave_groups=wave,
              use_kernel=use_kernel)
    return (
        JCheckpointer(jfab, "drex_sc", JPolicy(**kw)),
        TCheckpointer(tfab, "drex_sc", TPolicy(**kw), device="cpu"),
    )


def _groups(manifest):
    return [
        (g["key"], g["k"], g["p"], tuple(g["node_ids"]), g["orig_nbytes"])
        for meta in manifest["leaves"] if meta is not None
        for g in meta["groups"]
    ]


def _save_both(jck, tck, leaves, step=1):
    jman = jck.save([a for _, a in leaves], step)
    tman = tck.save(state_dict_from_numpy(leaves, "cpu"), step)
    return jman, tman


def _assert_same_fabric(jck, tck):
    assert tck.fabric._blobs == jck.fabric._blobs
    np.testing.assert_array_equal(tck.fabric.cluster.used_mb, jck.fabric.cluster.used_mb)
    np.testing.assert_array_equal(tck.fabric.cluster.alive, jck.fabric.cluster.alive)


def _assert_restores(state, leaves):
    assert list(state) == [n for n, _ in leaves]
    for name, arr in leaves:
        t = state[name]
        assert tuple(t.shape) == arr.shape
        np.testing.assert_array_equal(t.numpy(), arr)


class TestSaveEqual:
    @pytest.mark.parametrize("workers,wave", [(0, 16), (2, 16), (2, 3)])
    def test_groups_and_blobs_equal(self, workers, wave):
        leaves = _leaves()
        jck, tck = _pair(workers, wave)
        jman, tman = _save_both(jck, tck, leaves)
        assert _groups(tman) == _groups(jman)
        assert len(_groups(tman)) >= 9
        assert [m["name"] for m in tman["leaves"]] == [n for n, _ in leaves]
        assert [m["dtype"] for m in tman["leaves"]] == [
            m["dtype"] for m in jman["leaves"]
        ]
        _assert_same_fabric(jck, tck)
        assert tck.stats["bytes_raw"] == jck.stats["bytes_raw"]
        assert tck.stats["bytes_stored"] == jck.stats["bytes_stored"]
        _assert_restores(tck.restore(1), leaves)

    def test_oracle_codec_equal(self):
        leaves = _leaves(1)[:2]
        jck, tck = _pair(use_kernel=False)
        jman, tman = _save_both(jck, tck, leaves)
        assert _groups(tman) == _groups(jman)
        _assert_same_fabric(jck, tck)

    def test_async_and_gc_equal(self):
        leaves = _leaves(2)[1:3]
        jck, tck = _pair()
        for step in (1, 2, 3):
            jck.save_async([a for _, a in leaves], step).result(timeout=120)
            tck.save_async(state_dict_from_numpy(leaves, "cpu"), step).result(timeout=120)
        assert sorted(tck._manifests) == sorted(jck._manifests) == [2, 3]
        _assert_same_fabric(jck, tck)
        state, step = tck.restore_latest()
        assert step == 3
        _assert_restores(state, leaves)

    def test_async_failure_surfaces_through_future(self):
        tfab = TFabric(t_node_set("most_used", capacity_scale=1e-9))
        tck = TCheckpointer(tfab, "drex_sc", TPolicy(item_mb=ITEM_MB), device="cpu")
        fut = tck.save_async(state_dict_from_numpy(_leaves()[:1], "cpu"), 1)
        with pytest.raises(IOError):
            fut.result(timeout=60)
        assert 1 not in tck._manifests


class TestFailRestoreRepair:
    def test_data_row_failure_restore_and_repair_equal(self):
        leaves = _leaves(3)
        jck, tck = _pair()
        jman, _ = _save_both(jck, tck, leaves)
        # Fail the node holding row 0 of the first group: the decode
        # kernel path (not the systematic fast path) must run.
        victim = jman["leaves"][0]["groups"][0]["node_ids"][0]
        for ck in (jck, tck):
            ck.fabric.fail_node(victim)
        tops.reset_matrix_caches()
        restored = tck.restore(1, state_dict_from_numpy(leaves, "cpu"))
        _assert_restores(restored, leaves)
        assert tops.matrix_cache_stats()["decode_builds"] > 0
        jrest = jck.restore(1, [a for _, a in leaves])
        for (name, _), a in zip(leaves, jrest):
            np.testing.assert_array_equal(restored[name].numpy(), np.asarray(a))
        assert tck.group_reliability() == jck.group_reliability()
        # repair: same rebuilt count, same new node ids, same blobs
        assert tck.repair() == jck.repair() > 0
        assert _groups(tck._manifests[1]) == _groups(jck._manifests[1])
        _assert_same_fabric(jck, tck)
        assert tck.group_reliability() == jck.group_reliability()
        _assert_restores(tck.restore(1), leaves)
        assert tck.repair() == 0

    def test_p_failures_restore_and_too_many_raise(self):
        leaves = _leaves(4)[:1]
        jck, tck = _pair()
        jman, _ = _save_both(jck, tck, leaves)
        g = jman["leaves"][0]["groups"][0]
        for node in g["node_ids"][: g["p"]]:
            tck.fabric.fail_node(node)
        _assert_restores(tck.restore(1), leaves)
        for node in range(9):
            tck.fabric.fail_node(node)
        with pytest.raises(IOError, match="unrecoverable"):
            tck.restore(1)


class TestDtypes:
    def test_bf16_and_odd_dtypes_round_trip(self):
        gen = torch.Generator().manual_seed(0)
        state = {
            "bf16": torch.randn((123, 77), generator=gen).to(torch.bfloat16),
            "f16": torch.randn((5, 3), generator=gen).to(torch.float16),
            "i64": torch.arange(-50, 50, dtype=torch.int64),
            "flag": torch.tensor([True, False, True]),
            "scalar": torch.tensor(2.5, dtype=torch.bfloat16),
        }
        tfab = TFabric(t_node_set("most_used", capacity_scale=SCALE))
        tck = TCheckpointer(tfab, "drex_sc", TPolicy(item_mb=0.01), device="cpu")
        tck.save(state, 1)
        tfab.fail_node(tck._manifests[1]["leaves"][0]["groups"][0]["node_ids"][0])
        got, _ = tck.restore_latest(state)
        assert list(got) == list(state)
        for name, t in state.items():
            assert got[name].dtype == t.dtype and got[name].shape == t.shape
            assert torch.equal(got[name], t)

    def test_jax_written_checkpoint_restores_in_port(self, tmp_path):
        import ml_dtypes

        leaves = _leaves(5)[:3] + [
            ("bf16", np.random.default_rng(6).standard_normal((40, 60)).astype(ml_dtypes.bfloat16)),
        ]
        jck, _ = _pair(persist_dir=str(tmp_path))
        jman = jck.save([a for _, a in leaves], 7)
        # the port's fabric reads the same persist_dir; one node is lost
        tfab = TFabric(t_node_set("most_used", capacity_scale=SCALE), persist_dir=str(tmp_path))
        assert tfab._blobs == jck.fabric._blobs
        tfab.fail_node(jman["leaves"][0]["groups"][0]["node_ids"][0])
        tck = TCheckpointer(tfab, "drex_sc", TPolicy(item_mb=ITEM_MB), device="cpu")
        port_man = import_manifest(tck, 7, jman, names=[n for n, _ in leaves])
        assert [m["dtype"] for m in port_man["leaves"]] == ["float32", "int32", "uint8", "bfloat16"]
        state, step = tck.restore_latest()
        assert step == 7
        assert state["bf16"].dtype == torch.bfloat16
        for name, arr in leaves:
            got = state[name]
            assert tuple(got.shape) == arr.shape
            assert got.contiguous().view(torch.uint8).numpy().tobytes() == arr.tobytes()
