"""The port's decision path held against the JAX package's, exactly.

Reliability frontiers, cluster state, the incremental candidate order,
``drex_sc`` / ``ec(K,P)`` placements through ``PlacementEngine`` and
repair plans must be *equal* — integers equal, floats bit-equal — when
both packages see the same inputs.  The JAX side's ``drex_sc`` is driven
both ways it decides: its default (the jitted scorer wherever its
dispatch rule picks it, e.g. non-committing batches) and
``use_kernel=False`` (its numpy oracle).  The port runs on the CPU
(``device="cpu"``) under the same dispatch rule, so its batches go
through its torch scorer and the parity-frontier kernel's plain version.
"""

import dataclasses
import itertools

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # dev-only dep (requirements-dev.txt)
    from _hypothesis_stub import given, settings, strategies as st

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import reliability as jrel
from repro.core.candidates import CandidateTracker as JTracker
from repro.storage import make_node_set as j_node_set
from repro_torch.core import reliability as trel
from repro_torch.core.candidates import CandidateTracker as TTracker
from repro_torch.storage import make_node_set as t_node_set

NODE_SETS = ["most_used", "most_unreliable", "most_reliable", "homogeneous"]
TARGETS = [0.9, 0.99, 0.999, 0.99999, 0.9999999]


# -- reliability --------------------------------------------------------------


class TestReliability:
    @given(
        probs=st.lists(st.floats(0.0, 1.0), min_size=1, max_size=10),
        target=st.floats(0.5, 0.9999999),
    )
    @settings(max_examples=40, deadline=None)
    def test_frontiers_equal(self, probs, target):
        p = np.array(probs)
        jf, tf = jrel.ParityFrontier(p, target), trel.ParityFrontier(p, target)
        for n in range(1, len(p) + 1):  # resumed, incremental extension
            np.testing.assert_array_equal(tf.upto(n), jf.upto(n))
        np.testing.assert_array_equal(tf.upto_many(), jf.upto_many())
        np.testing.assert_array_equal(
            tf.upto_many(n_starts=3, nmax=4), jf.upto_many(n_starts=3, nmax=4)
        )
        assert trel.min_parity_for_target(p, target) == jrel.min_parity_for_target(p, target)

    @pytest.mark.parametrize("target", TARGETS)
    @pytest.mark.parametrize("n", [3, 10, 64, 65, 120])
    def test_many_nines_and_rna_regime_equal(self, target, n):
        rng = np.random.default_rng(n)
        p = rng.uniform(0.0001, 0.2, size=n)
        assert trel.min_parity_for_target(p, target) == jrel.min_parity_for_target(p, target)
        for method in ("exact", "rna", "auto"):
            for k in (0, 1, n // 3, n - 1):
                assert trel.poisson_binomial_cdf(p, k, method) == jrel.poisson_binomial_cdf(
                    p, k, method
                )
        np.testing.assert_array_equal(
            trel.rna_parity_frontier(p, target, 2, n),
            jrel.rna_parity_frontier(p, target, 2, n),
        )
        np.testing.assert_array_equal(
            trel.parity_frontier(p, target), jrel.parity_frontier(p, target)
        )

    @pytest.mark.parametrize(
        "probs", [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0, 1.0], [0.3] * 4, [1.0]]
    )
    @pytest.mark.parametrize("target", [0.5, 0.99, 0.999999])
    def test_degenerate_equal(self, probs, target):
        p = np.array(probs)
        np.testing.assert_array_equal(
            trel.ParityFrontier(p, target).upto_many(),
            jrel.ParityFrontier(p, target).upto_many(),
        )


# -- cluster state ------------------------------------------------------------


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return [
        dict(
            node_id=i,
            capacity_mb=float(rng.uniform(2e3, 1e5)),
            write_bw=float(rng.uniform(50, 400)),
            read_bw=float(rng.uniform(50, 450)),
            annual_failure_rate=float(rng.uniform(0.001, 0.2)),
            used_mb=float(rng.uniform(0.0, 1e3)),
        )
        for i in range(n)
    ]


def _views(rows):
    return (
        jcore.ClusterView.from_nodes([jcore.StorageNode(**r) for r in rows]),
        tcore.ClusterView.from_nodes([tcore.StorageNode(**r) for r in rows]),
    )


def _assert_views_equal(jv, tv):
    for name in ("capacity_mb", "used_mb", "write_bw", "read_bw", "afr", "alive",
                 "rack", "zone"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name))
    for dt in (1.0, 30.0, 365.0):
        a, b = tv.fail_probs(dt), jv.fail_probs(dt)
        assert a.tobytes() == b.tobytes()


def _op_tape(seed, n_ops=40):
    """Seeded join/fail/heal/commit/release tape shared by both packages."""
    rng = np.random.default_rng(seed)
    tape = []
    n = 8
    for _ in range(n_ops):
        op = ["commit", "release", "fail", "heal", "join"][int(rng.integers(5))]
        if op == "join":
            tape.append((op, _rows(int(rng.integers(1 << 30)), 1)[0] | {"node_id": n}))
            n += 1
        elif op in ("commit", "release"):
            k = int(rng.integers(1, 4))
            ids = sorted(int(x) for x in rng.choice(n, size=k, replace=False))
            tape.append((op, (ids, float(rng.uniform(1.0, 500.0)))))
        else:
            tape.append((op, int(rng.integers(n))))
    return tape


def _apply(view, tracker, op, arg, core):
    if op == "join":
        ids = [view.add_node(core.StorageNode(**arg))]
        kind = "join"
    elif op == "commit":
        view.charge(arg[0], arg[1])
        tracker.observe_commit(arg[0], arg[1], view)
        return
    elif op == "release":
        view.release(arg[0], arg[1])
        tracker.observe_release(arg[0], arg[1], view)
        return
    elif op == "fail":
        view.fail_node(arg)
        ids, kind = [arg], "fail"
    else:
        view.heal_node(arg)
        ids, kind = [arg], "heal"
    tracker.observe_churn(kind, ids, view)


class TestClusterState:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_fail_probs_and_candidate_order_equal_under_churn(self, seed):
        jv, tv = _views(_rows(seed, 8))
        jt, tt = JTracker(), TTracker()
        for op, arg in _op_tape(seed):
            _apply(jv, jt, op, arg, jcore)
            _apply(tv, tt, op, arg, tcore)
            _assert_views_equal(jv, tv)
            np.testing.assert_array_equal(tt.order(tv), jt.order(jv))
            np.testing.assert_array_equal(tt.topm(tv, 3), jt.topm(jv, 3))


# -- placement ----------------------------------------------------------------


def _items(core, seed, count=12, size_lo=1.0, size_hi=500.0):
    rng = np.random.default_rng(seed + 10_000)
    return [
        core.DataItem(
            item_id=i,
            size_mb=float(rng.uniform(size_lo, size_hi)),
            arrival_time=float(i),
            delta_t_days=float(rng.uniform(30.0, 730.0)),
            reliability_target=TARGETS[int(rng.integers(4))],
        )
        for i in range(count)
    ]


def _random_view(core, seed):
    """The invariant harness's randomized cluster (tests/test_invariants.py)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 15))
    view = core.ClusterView.from_nodes([
        core.StorageNode(
            node_id=i,
            capacity_mb=float(rng.uniform(2e3, 1e5)),
            write_bw=float(rng.uniform(50, 400)),
            read_bw=float(rng.uniform(50, 450)),
            annual_failure_rate=float(rng.uniform(0.001, 0.2)),
            used_mb=float(rng.uniform(0.0, 1e3)),
        )
        for i in range(n)
    ])
    for dead in rng.choice(n, size=int(rng.integers(0, 3)), replace=False):
        view.fail_node(int(dead))
    return view


def _pl(pl):
    """Placement as plain values (the two packages' classes differ)."""
    return None if pl is None else (pl.k, pl.p, tuple(pl.node_ids))


def _plan_key(plan):
    return (
        _pl(plan.placement), plan.survivors, plan.new_nodes, plan.added_parity,
        plan.chunk_mb, plan.candidates_considered, plan.reason, plan.committed,
    )


def _record_key(r):
    return (
        r.item_id,
        _pl(r.placement),
        r.chunk_mb,
        r.candidates_considered,
        r.reason,
        r.committed,
    )


def _engines(name, jview, tview, auto_commit, ref_kernel):
    je = jcore.PlacementEngine(jview, name, auto_commit=auto_commit)
    te = tcore.PlacementEngine(tview, name, auto_commit=auto_commit, device="cpu")
    if not ref_kernel:
        je.scheduler.use_kernel = False
    return je, te


def _compare_place_many(je, te, seed, **item_kw):
    jr = je.place_many(_items(jcore, seed, **item_kw))
    tr = te.place_many(_items(tcore, seed, **item_kw))
    assert [_record_key(r) for r in tr] == [_record_key(r) for r in jr]
    assert tr  # non-empty batch
    np.testing.assert_array_equal(te.cluster.used_mb, je.cluster.used_mb)
    assert te.scheduler.smin_mb == je.scheduler.smin_mb
    assert te.mutation_seq == je.mutation_seq
    return jr, tr


class TestPlacement:
    @pytest.mark.parametrize("ref_kernel", [True, False])
    @pytest.mark.parametrize("auto_commit", [True, False])
    @pytest.mark.parametrize("node_set", NODE_SETS)
    def test_drex_sc_on_paper_node_sets(self, node_set, auto_commit, ref_kernel):
        # Full capacity with checkpoint-sized groups, then a tight scale
        # where capacity and reliability both reject some items.
        for scale, lo, hi in ((1.0, 1.0, 500.0), (2e-6, 1.0, 120.0)):
            je, te = _engines(
                "drex_sc",
                jcore.ClusterView.from_nodes(j_node_set(node_set, scale)),
                tcore.ClusterView.from_nodes(t_node_set(node_set, scale)),
                auto_commit, ref_kernel,
            )
            jr, _ = _compare_place_many(je, te, seed=7, count=16, size_lo=lo, size_hi=hi)
            if scale < 1 and auto_commit:
                assert any(not r.ok for r in jr)  # the rejection path ran

    @pytest.mark.parametrize("ref_kernel", [True, False])
    @pytest.mark.parametrize("auto_commit", [True, False])
    @pytest.mark.parametrize("seed", range(6))
    def test_drex_sc_on_randomized_clusters(self, seed, auto_commit, ref_kernel):
        je, te = _engines(
            "drex_sc", _random_view(jcore, seed), _random_view(tcore, seed),
            auto_commit, ref_kernel,
        )
        _compare_place_many(je, te, seed)
        # single-item place after the batch, on the mutated cluster
        jit, tit = _items(jcore, seed + 99, 3), _items(tcore, seed + 99, 3)
        for a, b in zip(jit, tit):
            assert _record_key(te.place(b)) == _record_key(je.place(a))

    @pytest.mark.parametrize("name", ["ec(3,2)", "ec(4,2)", "ec(6,3)"])
    @pytest.mark.parametrize("seed", range(3))
    def test_static_ec_equal(self, name, seed):
        je, te = _engines(
            name, _random_view(jcore, seed), _random_view(tcore, seed), True, True
        )
        _compare_place_many(je, te, seed)
        je, te = _engines(
            name,
            jcore.ClusterView.from_nodes(j_node_set("most_used")),
            tcore.ClusterView.from_nodes(t_node_set("most_used")),
            True, True,
        )
        _compare_place_many(je, te, seed)

    def test_chip_smoke_groups_equal(self):
        """The 72 group sizes the chip smoke saves (RWKV6-1.6B's bf16
        leaves cut into 64 MB groups, bucket-padded) on the full-capacity
        ``most_used`` set: equal decisions, both JAX paths."""
        import importlib.util
        import pathlib

        path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        sizes = []
        for _, shape in smoke.RWKV6_1_6B:
            nbytes = 2 * int(np.prod(shape))
            for off in range(0, nbytes, 64_000_000):
                n, bucket = min(64_000_000, nbytes - off), 4096
                while bucket < n:
                    bucket <<= 1
                sizes.append(bucket)
        assert len(sizes) == 72

        def run(core, node_set, kernel=True):
            eng = core.PlacementEngine(
                core.ClusterView.from_nodes(node_set("most_used")), "drex_sc",
                auto_commit=False, **({"device": "cpu"} if core is tcore else {}),
            )
            if not kernel:
                eng.scheduler.use_kernel = False
            items = [
                core.DataItem(item_id=i + 1, size_mb=s / 1e6, arrival_time=1.0,
                              delta_t_days=30.0, reliability_target=0.999)
                for i, s in enumerate(sizes)
            ]
            return [_record_key(r) for r in eng.place_many(items, ctx=core.BatchContext())]

        got = run(tcore, t_node_set)
        assert got == run(jcore, j_node_set) == run(jcore, j_node_set, kernel=False)
        kp = sorted({(key[1][0], key[1][1], key[1][2]) for key in got})
        assert kp == [(3, 1, (3, 9, 0, 2)), (4, 1, (3, 9, 0, 2, 8))]

    def test_registry_names_and_capabilities(self):
        for name in tcore.SCHEDULER_NAMES:
            assert name in jcore.SCHEDULER_NAMES
            assert dataclasses.asdict(tcore.get_spec(name).capabilities) == (
                dataclasses.asdict(jcore.get_spec(name).capabilities)
            )

    def test_constrained_placements_equal(self):
        rows = _rows(5, 12)
        for i, r in enumerate(rows):
            r["rack"] = i % 4
            r["zone"] = i % 2
        jv = jcore.ClusterView.from_nodes([jcore.StorageNode(**r) for r in rows])
        tv = tcore.ClusterView.from_nodes([tcore.StorageNode(**r) for r in rows])
        je = jcore.PlacementEngine(
            jv, "drex_sc", constraints=jcore.PlacementConstraints(max_per_rack=2)
        )
        te = tcore.PlacementEngine(
            tv, "drex_sc", constraints=tcore.PlacementConstraints(max_per_rack=2),
            device="cpu",
        )
        _compare_place_many(je, te, seed=11)


class TestRepair:
    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("grow,require", [(True, True), (False, False), (False, True)])
    def test_plan_repair_equal(self, seed, grow, require):
        je, te = _engines(
            "drex_sc",
            jcore.ClusterView.from_nodes(j_node_set("most_used", 1e-4)),
            tcore.ClusterView.from_nodes(t_node_set("most_used", 1e-4)),
            True, False,
        )
        jr, tr = _compare_place_many(je, te, seed, count=10, size_lo=1.0, size_hi=200.0)
        victims = sorted({r.placement.node_ids[0] for r in jr if r.ok})[:2]
        for v in victims:
            je.cluster.fail_node(v)
            te.cluster.fail_node(v)
        ji, ti = _items(jcore, seed, 10, 1.0, 200.0), _items(tcore, seed, 10, 1.0, 200.0)
        for a, b, ra, rb in zip(ji, ti, jr, tr):
            if not ra.ok:
                continue
            pa = je.plan_repair(a, ra.placement, allow_parity_growth=grow,
                                require_target=require)
            pb = te.plan_repair(b, rb.placement, allow_parity_growth=grow,
                                require_target=require)
            assert _plan_key(pb) == _plan_key(pa)
        np.testing.assert_array_equal(te.cluster.used_mb, je.cluster.used_mb)
        assert te.mutation_seq == je.mutation_seq

    @pytest.mark.parametrize("seed", range(4))
    def test_replacement_order_equal_with_ties(self, seed):
        """Freest-first replacements where many nodes tie on free space
        (capacities from four values, a few used, some dead): the same
        candidates in the same order, ties by ascending id, as Python ints."""
        rng = np.random.default_rng(seed)
        rows = [dict(node_id=i, capacity_mb=float(rng.choice([50.0, 80.0, 120.0, 200.0])),
                     write_bw=100.0, read_bw=150.0,
                     annual_failure_rate=float(rng.uniform(0.01, 0.3)),
                     used_mb=float(rng.choice([0.0, 0.0, 0.0, 30.0])))
                for i in range(300)]
        jv = jcore.ClusterView.from_nodes([jcore.StorageNode(**r) for r in rows])
        tv = tcore.ClusterView.from_nodes([tcore.StorageNode(**r) for r in rows])
        for v in rng.choice(300, 40, replace=False):
            jv.fail_node(int(v))
            tv.fail_node(int(v))
        jp, tp = jcore.RepairPlanner(jv), tcore.RepairPlanner(tv)
        for i in range(12):
            ids = tuple(int(x) for x in rng.choice(300, 8, replace=False))
            k = int(rng.integers(2, 6))
            args = dict(chunk_mb=float(rng.choice([10.0, 60.0, 100.0])),
                        allow_parity_growth=True, require_target=bool(i % 2))
            item = dict(item_id=i, size_mb=40.0, arrival_time=0.0,
                        delta_t_days=365.0, reliability_target=0.999)
            pa = jp.plan(jcore.DataItem(**item), jcore.Placement(k, 8 - k, ids), **args)
            pb = tp.plan(tcore.DataItem(**item), tcore.Placement(k, 8 - k, ids), **args)
            assert _plan_key(pb) == _plan_key(pa)
            if pb.placement is not None:
                assert all(type(n) is int for n in pb.placement.node_ids)

    def test_repair_with_explicit_survivors_equal(self):
        jv = jcore.ClusterView.from_nodes(j_node_set("most_unreliable"))
        tv = tcore.ClusterView.from_nodes(t_node_set("most_unreliable"))
        je, te = _engines("drex_sc", jv, tv, False, True)
        jr, tr = _compare_place_many(je, te, seed=4, count=6)
        for combo in itertools.islice(itertools.combinations(range(10), 2), 6):
            for a, ra, rb in zip(_items(jcore, 4, 6), jr, tr):
                if not ra.ok:
                    continue
                surv = [n for n in ra.placement.node_ids if n not in combo]
                args = dict(chunk_mb=ra.chunk_mb, survivors=surv,
                            allow_parity_growth=False, require_target=False,
                            commit=False)
                pa = je.plan_repair(a, ra.placement, **args)
                pb = te.plan_repair(
                    tcore.DataItem(**{f: getattr(a, f) for f in
                                      ("item_id", "size_mb", "arrival_time",
                                       "delta_t_days", "reliability_target")}),
                    rb.placement, **args,
                )
                assert _plan_key(pb) == _plan_key(pa)
