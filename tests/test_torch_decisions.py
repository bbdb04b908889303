"""The port's device decision path held against the JAX package's, exactly.

On identical numpy inputs the port's batch scorers
(``sc_kernel.score_windows_batch``, ``lb_kernel.lb_batch``,
``greedy_kernel.least_used_batch`` and ``min_storage_batch``) must return
what the JAX package's jitted programs return: integer outputs equal and
``min_storage``'s float64 ``cost`` bitwise equal.  All nine
``SCHEDULER_NAMES`` must give equal ``Decision``s (placement, candidates
considered, reject reason) with the device scorer forced and with the
numpy oracle, on paper node sets, random views with dead nodes,
capacity-tight clusters, the RNA regime (mappings above 64 nodes) and
low reliability; on the pinned goldens of the JAX package's own suites;
at the ``KERNEL_MIN_NODES`` dispatch boundary (N-1 / N / N+1); and at the
top-M pre-filter boundaries, counters included.  The port runs on the
CPU (``device="cpu"``), where the parity-frontier kernel takes its plain
version.

**The JAX side's jitted programs.**  The JAX package defines its decision
programs only when ``jax.experimental.enable_x64`` imports; this jax
names that scoped switch ``jax.enable_x64``, so its own suites skip them
and its schedulers fall back to their oracles.  :func:`load_jax_x64`
executes the package's unchanged module source as a separate module
object with the old name supplied for the duration of the import, and
the ``jax_kernels`` fixture points the JAX schedulers at those modules
for one test (restored afterwards), so "the JAX package with its kernel"
means its jitted programs here too.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import jax
import jax.experimental

import repro.core as jcore
import repro.core.algorithms as jalg
import repro_torch.core as tcore
from repro.core import prefilter as jpre
from repro.storage import make_node_set as j_node_set
from repro.storage import make_trace
from repro_torch.core import greedy_kernel as tgreedy
from repro_torch.core import lb_kernel as tlb
from repro_torch.core import prefilter as tpre
from repro_torch.core import sc_kernel as tsc
from repro_torch.storage import make_node_set as t_node_set

import test_greedy_vectorized as greedy_gold
import test_kernel_dispatch_boundary as dispatch_cases
import test_lb_vectorized as lb_gold
import test_prefilter as pre_cases
import test_sc_vectorized as sc_gold

CPU = "cpu"
KERNEL_BACKED = ("drex_sc", "drex_lb", "greedy_min_storage", "greedy_least_used")

_X64_MODULES: dict = {}


def load_jax_x64(name: str):
    """``repro.core.<name>`` (a decision-program module) executed as a
    separate module object with its jitted programs defined."""
    mod = _X64_MODULES.get(name)
    if mod is None:
        had = hasattr(jax.experimental, "enable_x64")
        if not had:
            jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
        try:
            path = pathlib.Path(jcore.__file__).parent / f"{name}.py"
            spec = importlib.util.spec_from_file_location(f"repro.core._x64_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        finally:
            if not had:
                del jax.experimental.enable_x64
        assert mod.kernel_available()
        _X64_MODULES[name] = mod
    return mod


@pytest.fixture
def jax_kernels(monkeypatch):
    """Point the JAX package's schedulers at its jitted programs."""
    mods = {n: load_jax_x64(n) for n in ("sc_kernel", "lb_kernel", "greedy_kernel")}
    for n, m in mods.items():
        monkeypatch.setattr(jalg, n, m)
    monkeypatch.setattr(jalg.GreedyMinStorage, "KERNEL_MODULE", mods["greedy_kernel"])
    monkeypatch.setattr(jalg.GreedyLeastUsed, "KERNEL_MODULE", mods["greedy_kernel"])
    monkeypatch.setattr(jalg.DRexLB, "KERNEL_MODULE", mods["lb_kernel"])
    return mods


# -- helpers ------------------------------------------------------------------


def _pair(name: str, mode: str, **tuning):
    """(JAX scheduler, port scheduler on the CPU) tuned alike; ``mode`` is
    ``kernel`` (crossovers 0), ``oracle`` (``use_kernel=False``) or
    ``auto`` (the reference's dispatch rule)."""
    out = []
    for core, kw in ((jcore, {}), (tcore, {"device": CPU})):
        s = core.create_scheduler(name, **kw)
        for attr, val in tuning.items():
            if hasattr(type(s), attr):
                setattr(s, attr, val)
        if mode == "kernel":
            for attr in ("KERNEL_MIN_NODES", "KERNEL_MIN_NODES_BATCH"):
                if hasattr(type(s), attr):
                    setattr(s, attr, 0)
        elif mode == "oracle" and hasattr(s, "use_kernel"):
            s.use_kernel = False
        out.append(s)
    return out


def _key(d):
    pl = d.placement
    return (
        None if pl is None else (pl.k, pl.p, tuple(int(x) for x in pl.node_ids)),
        d.candidates_considered,
        d.reason,
    )


def _t_items(items):
    return [
        tcore.DataItem(it.item_id, it.size_mb, it.arrival_time, it.delta_t_days,
                       it.reliability_target)
        for it in items
    ]


def _clusters(n, seed, *, tight=False, afr_hi=0.2, dead=()):
    views = []
    for core in (jcore, tcore):
        rng = np.random.default_rng(seed)
        cap_lo, cap_hi, used_hi = (50.0, 800.0, 300.0) if tight else (2e3, 1e5, 1e3)
        view = core.ClusterView.from_nodes([
            core.StorageNode(
                node_id=i,
                capacity_mb=float(rng.uniform(cap_lo, cap_hi)),
                write_bw=float(rng.uniform(50, 400)),
                read_bw=float(rng.uniform(50, 450)),
                annual_failure_rate=float(rng.uniform(0.001, afr_hi)),
                used_mb=float(rng.uniform(0.0, used_hi)),
                rack=i % 4,
                zone=i % 2,
            )
            for i in range(n)
        ])
        for d in dead:
            view.fail_node(d)
        views.append(view)
    return views


def _items(seed, count=6, size_hi=500.0, targets=(0.9, 0.99, 0.999, 0.99999)):
    rng = np.random.default_rng(seed + 1)
    items = [
        jcore.DataItem(
            i, float(rng.uniform(1.0, size_hi)), float(i),
            float(rng.uniform(30.0, 730.0)), targets[int(rng.integers(len(targets)))],
        )
        for i in range(count)
    ]
    return items, _t_items(items)


def _assert_same(js, ts, jc, tc, jitems, titems, batch=True):
    """Sequential ``place`` and (where offered) ``place_batch`` on one
    snapshot: equal decisions, and equal smin state afterwards."""
    if batch and hasattr(ts, "place_batch"):
        got = [_key(d) for d in ts.place_batch(titems, tc)]
        want = [_key(d) for d in js.place_batch(jitems, jc)]
        assert got == want
    for a, b in zip(jitems, titems):
        assert _key(ts.place(b, tc)) == _key(js.place(a, jc)), a.item_id
    assert ts.smin_mb == js.smin_mb


# -- the batch scorers on identical inputs ------------------------------------


def _snapshot(rng, L):
    free = np.sort(rng.uniform(50.0, 5e3, L))[::-1].copy()
    return dict(
        free=free,
        wb=rng.uniform(50, 400, L),
        rb=rng.uniform(50, 450, L),
        used=rng.uniform(0.0, 1e3, L),
        cap=rng.uniform(2e3, 1e5, L),
    )


class TestBatchScorers:
    TM = (0.05, 2e-4, 3e-5, 0.04, 1.5e-4, 2.5e-5)

    @pytest.mark.parametrize("L,budget", [(2, 1024), (10, 1024), (40, 1024), (90, 1024), (60, 24)])
    def test_score_windows_batch(self, jax_kernels, L, budget):
        rng = np.random.default_rng(L * 7 + budget)
        B = 5
        snap = _snapshot(rng, L)
        args = (
            rng.uniform(0.0, 0.3, (B, L)),
            rng.uniform(1.0, 800.0, B),
            np.array([0.9, 0.99, 0.999, 0.9999999, 0.5]),
            rng.uniform(0.5, 20.0, B),
            rng.uniform(0.5, 2.0, B),
            rng.uniform(0.0, 0.4, B),
            snap["free"], snap["wb"], snap["rb"], snap["used"], snap["cap"],
            budget, self.TM,
        )
        for n_live in (None, L + 500):
            got = tsc.score_windows_batch(*args, n_live=n_live, device=CPU)
            want = jax_kernels["sc_kernel"].score_windows_batch(*args, n_live=n_live)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            assert got[0].any()

    @pytest.mark.parametrize("L", [3, 12, 70])
    def test_lb_batch(self, jax_kernels, L):
        rng = np.random.default_rng(L)
        free = np.sort(rng.uniform(50.0, 2e3, L))[::-1].copy()
        targets = [0.9, 0.999, 0.9999999, 0.99]
        mp_rows = np.stack([
            jcore.ParityFrontier(rng.uniform(0.0, 0.4, L), t).upto(L) for t in targets
        ])
        sizes = rng.uniform(1.0, 1500.0, len(targets))
        f_avg = float(free.mean())
        dev = np.abs(free - f_avg)
        suffix = np.concatenate([np.cumsum(dev[::-1])[::-1], [0.0]])
        got = tlb.lb_batch(mp_rows, sizes, free, f_avg, suffix, device=CPU)
        want = jax_kernels["lb_kernel"].lb_batch(mp_rows, sizes, free, f_avg, suffix)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("L", [2, 9, 33, 100])
    def test_least_used_batch(self, jax_kernels, L):
        rng = np.random.default_rng(L + 1)
        probs = rng.uniform(0.0, 0.5, (5, L))
        sizes = rng.uniform(1.0, 3000.0, 5)
        targets = np.array([0.9, 0.99, 0.999, 0.9999999, 0.5])
        free = np.sort(rng.uniform(10.0, 2e3, L))[::-1].copy()
        got = tgreedy.least_used_batch(probs, sizes, targets, free, device=CPU)
        want = jax_kernels["greedy_kernel"].least_used_batch(probs, sizes, targets, free)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("L,tight", [(2, False), (12, False), (40, True), (90, False)])
    def test_min_storage_batch(self, jax_kernels, L, tight):
        rng = np.random.default_rng(L + 2)
        probs = rng.uniform(0.0, 0.3, (4, L))
        sizes = rng.uniform(1.0, 900.0, 4)
        targets = np.array([0.9, 0.999, 0.9999999, 0.99])
        free = rng.uniform(20.0, 300.0 if tight else 5e4, L)
        rna = np.stack([
            tgreedy.rna_frontier_row(probs[b], targets[b], L) for b in range(4)
        ])
        got = tgreedy.min_storage_batch(probs, sizes, targets, rna, free, device=CPU)
        want = jax_kernels["greedy_kernel"].min_storage_batch(probs, sizes, targets, rna, free)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
        assert got[4].dtype == want[4].dtype == np.float64
        assert got[4].tobytes() == want[4].tobytes()  # cost, bitwise
        if tight:
            assert got[1].any()  # the capacity filter engaged

    def test_rna_frontier_row_equal(self):
        rng = np.random.default_rng(11)
        probs = rng.uniform(0.0, 0.4, 130)
        for t in (0.9, 0.9999999):
            np.testing.assert_array_equal(
                tgreedy.rna_frontier_row(probs, t, 130),
                jcore.greedy_kernel.rna_frontier_row(probs, t, 130),
            )


# -- the nine schedulers ------------------------------------------------------

SCENARIOS = {
    # name -> (cluster kwargs, items kwargs)
    "random_dead": (dict(n=12, seed=3, dead=(0, 7)), dict(seed=3, count=8)),
    "capacity_tight": (dict(n=40, seed=1, tight=True), dict(seed=1, size_hi=900.0)),
    "rna_regime": (dict(n=80, seed=2), dict(seed=2, count=5)),
    "low_reliability": (
        dict(n=30, seed=50, afr_hi=3.0),
        dict(seed=50, count=4, targets=(0.9, 0.999, 0.9999999, 0.99)),
    ),
}
MODES = [(n, m) for n in jcore.SCHEDULER_NAMES
         for m in (("kernel", "oracle") if n in KERNEL_BACKED else ("auto",))]


class TestSchedulers:
    def test_names_and_capabilities(self):
        assert tcore.SCHEDULER_NAMES == jcore.SCHEDULER_NAMES
        for name in jcore.SCHEDULER_NAMES:
            assert (tcore.get_spec(name).capabilities
                    == tcore.SchedulerCapabilities(**vars(jcore.get_spec(name).capabilities)))

    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    @pytest.mark.parametrize("name,mode", MODES)
    def test_decisions_equal(self, jax_kernels, name, mode, scenario):
        ckw, ikw = SCENARIOS[scenario]
        jc, tc = _clusters(**ckw)
        js, ts = _pair(name, mode)
        _assert_same(js, ts, jc, tc, *_items(**ikw))

    @pytest.mark.parametrize("node_set", ["most_used", "most_unreliable", "most_reliable",
                                          "homogeneous"])
    @pytest.mark.parametrize("name,mode", MODES)
    def test_committed_place_many_on_node_sets(self, jax_kernels, name, mode, node_set):
        js, ts = _pair(name, mode)
        je = jcore.PlacementEngine(j_node_set(node_set, 0.001), js)
        te = tcore.PlacementEngine(t_node_set(node_set, 0.001), ts)
        items = make_trace("sentinel2", seed=5, n_items=10, reliability=0.95)
        jr, tr = je.place_many(items), te.place_many(_t_items(items))
        assert [(r.item_id, r.placement and (r.placement.k, r.placement.p,
                 tuple(r.placement.node_ids)), r.reason) for r in tr] == [
            (r.item_id, r.placement and (r.placement.k, r.placement.p,
             tuple(r.placement.node_ids)), r.reason) for r in jr]
        np.testing.assert_array_equal(te.cluster.used_mb, je.cluster.used_mb)

    def test_random_spread_generator_keyed_by_seed_and_item(self):
        jc, tc = _clusters(20, 4)
        for seed in (0, 7, -3):
            js = jcore.create_scheduler("random_spread", seed=seed)
            ts = tcore.create_scheduler("random_spread", seed=seed, device=CPU)
            for item_id in (0, 5, -1, 2**70):
                a = jcore.DataItem(item_id, 10.0, 0.0, 365.0, 0.9)
                b = tcore.DataItem(item_id, 10.0, 0.0, 365.0, 0.9)
                assert _key(ts.place(b, tc)) == _key(js.place(a, jc))

    def test_device_none_means_cuda(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        for name in KERNEL_BACKED:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tcore.create_scheduler(name)
        assert tcore.create_scheduler("daos").name == "daos"  # host-only


# -- the JAX package's pinned goldens -----------------------------------------

GOLDENS = (
    [("drex_sc", k, v) for k, v in sorted(sc_gold.TestGoldenPlacements.GOLDEN.items())]
    + [("drex_lb", k, v) for k, v in sorted(lb_gold.GOLDEN.items())]
    + [(n, k, v) for n in greedy_gold.GREEDY for k, v in sorted(greedy_gold.GOLDEN[n].items())]
)


@pytest.mark.parametrize("mode", ["kernel", "oracle"])
@pytest.mark.parametrize(
    "name,key,golden", GOLDENS, ids=[f"{n}-{k[0]}-{k[1]}" for n, k, _ in GOLDENS]
)
def test_pinned_goldens(name, key, golden, mode):
    nodeset, seed = key
    items = _t_items(make_trace("meva", seed=seed, n_items=8, reliability=0.99))
    want = [(k, p, tuple(ids)) for k, p, ids in golden]
    _, ts = _pair(name, mode)
    eng = tcore.PlacementEngine(t_node_set(nodeset, 0.001), ts)
    assert [(r.placement.k, r.placement.p, r.placement.node_ids)
            for r in (eng.place(it) for it in items)] == want
    _, ts = _pair(name, mode)
    eng = tcore.PlacementEngine(t_node_set(nodeset, 0.001), ts)
    assert [(r.placement.k, r.placement.p, r.placement.node_ids)
            for r in eng.place_many(items)] == want


# -- the dispatch boundary ----------------------------------------------------


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize(
    "name,override,entry",
    [(n, o, e) for n, o, _, e in dispatch_cases.CASES],
)
def test_dispatch_boundary(jax_kernels, monkeypatch, name, override, entry, delta):
    """The reference's N-1 / N / N+1 cases: auto, forced and oracle
    decisions equal the JAX package's, and the port's dispatch flips to
    its device scorer exactly at the boundary."""
    tuning = {} if override is None else {"KERNEL_MIN_NODES": override}
    boundary = jcore.create_scheduler(name).KERNEL_MIN_NODES if override is None else override
    n_nodes = boundary + delta
    jitems = dispatch_cases.boundary_items()
    titems = _t_items(jitems)
    for mode in ("auto", "kernel", "oracle"):
        js, ts = _pair(name, mode, **tuning)
        jc = dispatch_cases.boundary_cluster(n_nodes)
        tc = tcore.ClusterView.from_nodes([
            tcore.StorageNode(int(i), float(jc.capacity_mb[i]), float(jc.write_bw[i]),
                              float(jc.read_bw[i]), float(jc.afr[i]),
                              used_mb=float(jc.used_mb[i]))
            for i in range(n_nodes)
        ])
        got = [_key(ts.place(b, tc)) for b in titems]
        assert got == [_key(js.place(a, jc)) for a in jitems], (mode, n_nodes)
    module = {"sc_kernel": tsc, "lb_kernel": tlb, "greedy_kernel": tgreedy}[
        {"score_windows_batch": "sc_kernel", "lb_batch": "lb_kernel"}.get(entry, "greedy_kernel")
    ]
    calls = []
    orig = getattr(module, entry)
    monkeypatch.setattr(module, entry, lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    _, ts = _pair(name, "auto", **tuning)
    ts.place(titems[0], tc)
    assert bool(calls) == (n_nodes >= boundary)


# -- the top-M pre-filter boundaries ------------------------------------------


def _pre_clusters(n, **kw):
    jc = pre_cases.make_cluster(n, **kw)
    tc = tcore.ClusterView.from_nodes([
        tcore.StorageNode(int(i), float(jc.capacity_mb[i]), float(jc.write_bw[i]),
                          float(jc.read_bw[i]), float(jc.afr[i]),
                          used_mb=float(jc.used_mb[i]))
        for i in range(n)
    ])
    return jc, tc


def _filtered_equal(name, tuning, jc, tc, jitems):
    """Filtered batch decisions and pre-filter counters equal the JAX
    package's, and equal the port's own scalar oracle."""
    titems = _t_items(jitems)
    js, ts = _pair(name, "kernel", **tuning)
    _, to = _pair(name, "oracle", **tuning)
    jpre.reset_stats()
    tpre.reset_stats()
    got = [_key(d) for d in ts.place_batch(titems, tc)]
    assert got == [_key(d) for d in js.place_batch(jitems, jc)]
    assert got == [_key(to.place_scalar(it, tc)) for it in titems]
    assert tpre.stats() == jpre.stats()
    return tpre.stats().get(name, {})


@pytest.mark.parametrize("delta", [-1, 0, 1])
class TestPrefilterBoundaries:
    @pytest.mark.parametrize("ties", [False, True])
    def test_lb_cut(self, jax_kernels, delta, ties):
        jc, tc = _pre_clusters(pre_cases.LB_CAP + delta, ties=ties)
        st = _filtered_equal("drex_lb", {"PREFILTER_CAP": pre_cases.LB_CAP}, jc, tc,
                             pre_cases.make_items())
        if delta > 0:
            assert st["engaged"] == st["accepted"] + st["fallback"] == 6
        else:
            assert st.get("engaged", 0) == 0

    @pytest.mark.parametrize("ties", [False, True])
    def test_sc_cut(self, jax_kernels, delta, ties):
        jc, tc = _pre_clusters(pre_cases.SC_CAP + delta, ties=ties)
        st = _filtered_equal("drex_sc", {"MAX_MAPPINGS": pre_cases.SC_BUDGET}, jc, tc,
                             pre_cases.make_items())
        assert st.get("engaged", 0) == (6 if delta > 0 else 0)

    def test_least_used_cut_and_capped_fallback(self, jax_kernels, delta):
        tuning = {"SCAN_CAP": pre_cases.LU_CAP}
        jc, tc = _pre_clusters(pre_cases.LU_CAP + delta)
        _filtered_equal("greedy_least_used", tuning, jc, tc, pre_cases.make_items())
        jc, tc = _pre_clusters(pre_cases.LU_CAP + delta, afr_hi=0.9, seed=5)
        _filtered_equal("greedy_least_used", tuning, jc, tc,
                        pre_cases.make_items(4, target=0.9999999))


def test_lb_fallback_lane(jax_kernels):
    rng = np.random.default_rng(3)
    rows = [
        dict(node_id=i, capacity_mb=5e4, write_bw=float(rng.uniform(50, 400)),
             read_bw=float(rng.uniform(50, 450)),
             annual_failure_rate=float(rng.uniform(0.6, 0.95)))
        for i in range(pre_cases.LB_CAP + 6)
    ]
    jc = jcore.ClusterView.from_nodes([jcore.StorageNode(**r) for r in rows])
    tc = tcore.ClusterView.from_nodes([tcore.StorageNode(**r) for r in rows])
    st = _filtered_equal("drex_lb", {"PREFILTER_CAP": pre_cases.LB_CAP}, jc, tc,
                         pre_cases.make_items(4, target=0.999999))
    assert st["fallback"] > 0


def test_prefilter_helpers_equal():
    assert tpre.sc_cap(1024) == jpre.sc_cap(1024)
    assert tpre.lb_cap() == jpre.lb_cap()
    order = np.arange(40)[::-1].copy()
    rack, zone = np.arange(40) % 7, np.arange(40) % 3
    c_t = tcore.PlacementConstraints(min_racks=5, min_zones=3)
    c_j = jcore.PlacementConstraints(min_racks=5, min_zones=3)
    tpre.reset_stats()
    jpre.reset_stats()
    for m in (3, 8, 40):
        np.testing.assert_array_equal(
            tpre.domain_slice(order, rack, zone, m, c_t, "x"),
            jpre.domain_slice(order, rack, zone, m, c_j, "x"),
        )
    assert tpre.stats() == jpre.stats()


def test_kernel_available_means_built():
    """Each device scorer module has the reference's ``kernel_available``;
    True means its device scorer is built for this process: D-Rex SC's and
    the greedy ones once ``pb_frontier`` is loaded (never here, with no
    card), D-Rex LB's (torch ops alone) wherever a card is."""
    import torch

    from repro_torch.kernels import pb_frontier

    for mod in (tsc, tgreedy):
        assert mod.kernel_available() is pb_frontier.loaded()
    assert tlb.kernel_available() is torch.cuda.is_available()
    if not torch.cuda.is_available():
        assert not any(m.kernel_available() for m in (tsc, tgreedy, tlb))
