"""The port's spans (``repro_torch.telemetry.span``): free while tracing
is off; with it on, nesting, parents and operation ids across threads
(an async save's caller and its pool worker), stamps on ``time.time_ns``, the span names each
checkpoint operation records, and the same manifests and bytes as an
untraced run and as the JAX package's.  Leaves are small and live on
the CPU; comparisons are exact.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.checkpoint import DRexCheckpointer as JCheckpointer
from repro.checkpoint import StorageFabric as JFabric
from repro.storage import make_node_set as j_node_set
from repro_torch import telemetry
from repro_torch.checkpoint import CheckpointPolicy as TPolicy
from repro_torch.checkpoint import DRexCheckpointer as TCheckpointer
from repro_torch.checkpoint import StorageFabric as TFabric
from repro_torch.checkpoint import manager
from repro_torch.checkpoint.interop import state_dict_from_numpy
from repro_torch.ec import plan_cohorts
from repro_torch.storage import make_node_set as t_node_set

SCALE = 1e-5
ITEM_MB = 0.25
ROOTS = ("ckpt.save", "ckpt.restore")


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return [
        ("w", rng.standard_normal((300, 1000)).astype(np.float32)),  # 5 groups
        ("ids", rng.integers(-2**31, 2**31 - 1, size=(50_000,), dtype=np.int32)),
        ("bytes", rng.integers(0, 256, size=(70_001,), dtype=np.uint8)),
        ("empty", np.zeros((0, 4), dtype=np.float32)),
        ("scalar", np.array(3.5, dtype=np.float32)),
    ]


def _port(workers=2, wave=2):
    return TCheckpointer(TFabric(t_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                         TPolicy(item_mb=ITEM_MB, pipeline_workers=workers,
                                 encode_wave_groups=wave), device="cpu")


def _by_op(spans) -> dict:
    ops: dict = {}
    for s in spans:
        ops.setdefault(s.op, []).append(s)
    return ops


def _root(op_spans):
    roots = [s for s in op_spans if s.name in ROOTS]
    assert len(roots) == 1, [s.name for s in op_spans]
    return roots[0]


def _count(op_spans, name) -> int:
    return sum(1 for s in op_spans if s.name == name)


def _waves(manifest, wave_size) -> int:
    """Encode waves of a save: each (K, P) cohort in slices of the wave size."""
    kp = [(g["k"], g["p"]) for m in manifest["leaves"] for g in m["groups"]]
    return sum(-(-len(idxs) // wave_size) for _, idxs in plan_cohorts(kp))


# -- the recorder --------------------------------------------------------------


def test_off_span_is_one_shared_object_and_records_nothing(monkeypatch):
    with telemetry.tracing() as rec:
        pass
    assert telemetry.span("a") is telemetry.span("b", op=3)

    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    with telemetry.span("x"):
        pass
    ck = _port()
    state = state_dict_from_numpy(_leaves(1)[1:3], "cpu")
    ck.save(state, 1)
    ck.restore(1)
    ck.close()
    assert rec.spans == []


def test_off_span_makes_no_object():
    """Every call, entered or not, hands back the one shared span."""
    shared = telemetry.span("ckpt.save")
    for name in ("ckpt.save.encode", "ec.stage", "engine.place_many") * 100:
        with telemetry.span(name) as sp:
            assert sp is shared
        assert telemetry.span(name, op=1) is shared


def test_one_tracing_block_at_a_time():
    with telemetry.tracing():
        with pytest.raises(RuntimeError):
            with telemetry.tracing():
                pass
    with telemetry.tracing() as rec:
        with telemetry.span("x"):
            pass
    assert [s.name for s in rec.spans] == ["x"]


def test_nesting_parents_ops_and_the_wall_clock():
    t0 = time.time_ns()
    with telemetry.tracing() as rec:
        with telemetry.span("a") as a:
            with telemetry.span("b"):
                with telemetry.span("c"):
                    pass
            with telemetry.span("f"):
                pass
        with telemetry.span("d"):
            pass
        with telemetry.span("e", op=a.op):
            pass
    t1 = time.time_ns()
    got = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["c", "b", "f", "a", "d", "e"]
    assert got["a"].parent_id is None and got["b"].parent_id == got["a"].span_id
    assert got["c"].parent_id == got["b"].span_id and got["f"].parent_id == got["a"].span_id
    assert got["a"].op == got["b"].op == got["c"].op == got["f"].op == got["e"].op != got["d"].op
    assert got["e"].parent_id is None
    me = threading.get_ident()
    for s in rec.spans:
        assert s.thread == me
        assert t0 <= s.start_ns <= s.end_ns <= t1
    assert got["a"].start_ns <= got["b"].start_ns <= got["c"].start_ns
    assert got["c"].end_ns <= got["b"].end_ns <= got["a"].end_ns
    # the wall clock, not a monotonic one
    assert abs(got["a"].start_ns / 1e9 - time.time()) < 60


def test_a_root_on_a_pool_thread_joins_the_operation_it_is_given():
    """A pool worker's spans are its own thread's: a root given ``op``
    joins that operation, one without starts its own, and the worker's
    children take the worker's root as parent."""
    with telemetry.tracing() as rec, ThreadPoolExecutor(2) as pool:
        def work(name, op):
            with telemetry.span(name, op=op):
                with telemetry.span(name + ".child"):
                    pass
            return threading.get_ident()

        with telemetry.span("caller") as caller:
            joined = pool.submit(work, "joined", caller.op).result(timeout=30)
        free = pool.submit(work, "free", None).result(timeout=30)
    got = {s.name: s for s in rec.spans}
    assert len(rec.spans) == 5
    assert threading.get_ident() not in (joined, free)
    assert (got["joined"].thread, got["free"].thread) == (joined, free)
    assert got["joined"].parent_id is None and got["joined"].op == caller.op
    assert got["free"].parent_id is None and got["free"].op != caller.op
    for name in ("joined", "free"):
        child = got[name + ".child"]
        assert (child.parent_id, child.op, child.thread) == (
            got[name].span_id, got[name].op, got[name].thread)


def test_many_threads_lose_no_span_and_share_no_id():
    """More threads than cores, a short switch interval: every span is
    recorded once, ids are unique, and each child keeps its thread's
    parent and operation."""
    threads, n = 16, 300
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with telemetry.tracing() as rec, ThreadPoolExecutor(threads) as pool:
            def work(k):
                for _ in range(n):
                    with telemetry.span("outer"):
                        with telemetry.span("inner"):
                            pass

            for f in [pool.submit(work, k) for k in range(threads)]:
                f.result(timeout=120)
    finally:
        sys.setswitchinterval(before)
    assert len(rec.spans) == 2 * threads * n
    assert len({s.span_id for s in rec.spans}) == len(rec.spans)
    outer = {s.span_id: s for s in rec.spans if s.name == "outer"}
    assert len({s.op for s in outer.values()}) == threads * n
    for s in rec.spans:
        if s.name == "inner":
            parent = outer[s.parent_id]
            assert (parent.thread, parent.op) == (s.thread, s.op)


def test_spans_ending_after_the_block_are_dropped():
    with telemetry.tracing() as rec:
        sp = telemetry.span("late")
        sp.__enter__()
    sp.__exit__(None, None, None)
    assert rec.spans == []


# -- the checkpoint plane ------------------------------------------------------


def _save_lose_restore_repair(ck, leaves):
    """(manifest, restored bytes, repaired chunks) of a save, the loss of
    the node holding the first group's row 0, a restore and a repair."""
    man = ck.save(state_dict_from_numpy(leaves, "cpu"), 1)
    ck.on_node_failure(man["leaves"][0]["groups"][0]["node_ids"][0])
    restored = {k: v.numpy().tobytes() for k, v in ck.restore(1).items()}
    return man, restored, ck.repair()


@pytest.mark.parametrize("workers", [0, 2])
def test_traced_operations_equal_untraced_and_the_references(workers):
    leaves = _leaves(3)
    plain = _port(workers)
    want = _save_lose_restore_repair(plain, leaves)
    traced = _port(workers)
    with telemetry.tracing() as rec:
        got = _save_lose_restore_repair(traced, leaves)
    assert rec.spans
    assert got == want
    assert traced.fabric._blobs == plain.fabric._blobs
    np.testing.assert_array_equal(traced.fabric.cluster.used_mb, plain.fabric.cluster.used_mb)
    # the JAX package's checkpointer, untraced, on the same leaves
    ref = JCheckpointer(JFabric(j_node_set("most_used", capacity_scale=SCALE)), "drex_sc",
                        JPolicy(item_mb=ITEM_MB, pipeline_workers=workers, encode_wave_groups=2))
    jman = ref.save([a for _, a in leaves], 1)
    ref.fabric.fail_node(jman["leaves"][0]["groups"][0]["node_ids"][0])
    jrest = ref.restore(1, [a for _, a in leaves])
    assert [np.asarray(a).tobytes() for a in jrest] == list(got[1].values())
    assert ref.repair() == got[2]
    assert traced.fabric._blobs == ref.fabric._blobs
    for ck in (plain, traced):
        ck.close()


@pytest.mark.parametrize("batch_bytes, batches", [(None, 1), (300_000, 3)])
@pytest.mark.parametrize("workers", [0, 2])
def test_each_operation_records_its_spans(workers, batch_bytes, batches, monkeypatch):
    """A restore's gather and decode are one a batch of leaves (all five
    leaves in one batch at the default size; at 300,000 staged bytes ``w``
    alone, ``ids`` alone, the three small leaves together), its copies to
    the device one ``ec.stage`` a batch too, and its assembly one a leaf."""
    if batch_bytes is not None:
        monkeypatch.setattr(manager, "_RESTORE_BATCH_BYTES", batch_bytes)
    leaves = _leaves(4)
    n_leaves = len(leaves)
    ck = _port(workers, wave=2)
    with telemetry.tracing() as rec:
        man, _, rebuilt = _save_lose_restore_repair(ck, leaves)
    ck.close()
    assert rebuilt > 0
    ops = [s for s in _by_op(rec.spans).values() if any(x.name in ROOTS for x in s)]
    assert sorted(_root(s).name for s in ops) == sorted(ROOTS)
    by_root = {_root(s).name: s for s in ops}
    me = threading.get_ident()

    save = by_root["ckpt.save"]
    root = _root(save)
    waves = _waves(man, 1 if workers == 0 else 2)
    assert waves > 1
    for name in ("ckpt.save.encode", "ckpt.save.d2h"):
        assert _count(save, name) == waves, name
    for name in ("ckpt.save.snapshot", "ckpt.save.place", "engine.place_many",
                 "ckpt.save.finish"):
        assert _count(save, name) == 1, name
    assert _count(save, "ckpt.save.put_wait") >= 1
    for s in save:
        assert s.thread == me, s.name
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, s.name

    restore = by_root["ckpt.restore"]
    assert ck.stats["restore_batches"] == batches
    for name in ("ckpt.restore.gather", "ec.stage", "ckpt.restore.decode"):
        assert _count(restore, name) == batches, name
    assert _count(restore, "ckpt.restore.assemble") == n_leaves
    assert _count(restore, "ec.decode_kernel") >= 1  # row 0 of a group is lost
    assert all(s.thread == me for s in restore)


def test_async_save_shares_one_operation_across_threads():
    leaves = _leaves(5)
    ck = _port(workers=2, wave=2)
    with telemetry.tracing() as rec:
        man = ck.save_async(state_dict_from_numpy(leaves, "cpu"), 1).result(timeout=120)
    ck.close()
    (op,) = _by_op(rec.spans).values()
    root = _root(op)
    (snap,) = [s for s in op if s.name == "ckpt.save.snapshot"]
    me = threading.get_ident()
    assert snap.thread == me and snap.parent_id is None
    assert root.thread != me and snap.end_ns <= root.start_ns
    assert _count(op, "ckpt.save.encode") == _count(op, "ckpt.save.d2h") == _waves(man, 2)
    for s in op:
        if s is not snap:
            assert s.thread == root.thread, s.name
