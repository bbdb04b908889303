"""The port's workload traces and event-driven simulator held against the
JAX package's, exactly.

Traces must be bit-equal to the reference's for every dataset and
argument form.  Simulations on the same inputs must give equal
``SimResult`` fields (floats compared with ``==``, ``per_node_used_mb`` by
its bytes), equal ``(k, p, node_ids)`` and I/O times for every stored
item, and an equal ``repair_log`` — for all nine ``SCHEDULER_NAMES`` on
Fig. 12's configuration with finite repair bandwidth and a rack event,
through joins, heals and a zone event, and on the JAX package's own
simulator goldens.  Only the measured wall times (``sched_overhead_s``)
are left out of the comparison.

The port runs on the CPU (``device="cpu"``).  The four kernel-backed
schedulers run twice: under the reference's dispatch rule (at these ten
nodes every single-item decision takes the numpy oracle) and with
``KERNEL_MIN_NODES = KERNEL_MIN_NODES_BATCH = 0``, which sends every
decision through the port's device path, here over the plain
``pb_frontier``.  The JAX package's schedulers decide through their
oracles in this environment (see ``test_torch_decisions``), which the
port's rules name as the reference.
"""

import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.storage as jstorage
import repro_torch.core as tcore
import repro_torch.storage as tstorage
from repro.storage import traces as jtraces
from repro_torch.storage import traces as ttraces

import test_simulator as sim_gold

CPU = "cpu"
KERNEL_BACKED = ("drex_sc", "drex_lb", "greedy_min_storage", "greedy_least_used")
#: (scheduler, forced device path) — each kernel-backed scheduler twice.
RUNS = [(n, False) for n in tcore.SCHEDULER_NAMES] + [(n, True) for n in KERNEL_BACKED]
RUN_IDS = [f"{n}-{'forced' if f else 'dispatch'}" for n, f in RUNS]


def _trace_rows(items) -> list[tuple]:
    return [dataclasses.astuple(it) for it in items]


TRACE_FORMS = {
    "n_items": dict(n_items=300),
    "total_mb": None,  # filled per dataset: ~60 mean items of volume
    "fixed_rt": dict(n_items=200, reliability=0.999, delta_t_days=30.0),
    "size_scale": dict(n_items=200, size_scale=1e-3, duration_days=7.0),
    "above_batch": dict(n_items=1500),  # two lognormal batches
}


class TestTraces:
    @pytest.mark.parametrize("form", sorted(TRACE_FORMS))
    @pytest.mark.parametrize("name", jtraces.DATASET_NAMES)
    @pytest.mark.parametrize("seed", [0, 5])
    def test_bit_equal(self, name, form, seed):
        kw = TRACE_FORMS[form]
        if kw is None:
            kw = dict(total_mb=60.0 * jtraces._SPECS[name].mean_mb)
        got = _trace_rows(ttraces.make_trace(name, seed=seed, **kw))
        want = _trace_rows(jtraces.make_trace(name, seed=seed, **kw))
        assert got == want

    def test_specs_and_targets_equal(self):
        assert ttraces.DATASET_NAMES == jtraces.DATASET_NAMES
        for name in jtraces.DATASET_NAMES:
            assert dataclasses.astuple(ttraces._SPECS[name]) == dataclasses.astuple(
                jtraces._SPECS[name]
            )
            assert ttraces._SPECS[name].lognormal_params == jtraces._SPECS[name].lognormal_params
        got = ttraces.random_reliability_targets(5000, np.random.default_rng(9))
        want = jtraces.random_reliability_targets(5000, np.random.default_rng(9))
        assert got.tobytes() == want.tobytes()

    def test_unknown_inputs_raise(self):
        with pytest.raises(ValueError, match="unknown dataset"):
            ttraces.make_trace("nope")
        with pytest.raises(ValueError, match="unknown reliability"):
            ttraces.make_trace("meva", n_items=4, reliability="bogus")


# -- simulations --------------------------------------------------------------


SCORERS = {
    "drex_sc": (tcore.sc_kernel, "score_windows_batch"),
    "drex_lb": (tcore.lb_kernel, "lb_batch"),
    "greedy_least_used": (tcore.greedy_kernel, "least_used_batch"),
    "greedy_min_storage": (tcore.greedy_kernel, "min_storage_batch"),
}


@pytest.fixture
def scorer_calls(monkeypatch):
    """Counts calls of each kernel-backed scheduler's device scorer."""
    calls = dict.fromkeys(SCORERS, 0)
    for name, (mod, attr) in SCORERS.items():
        def counted(*a, _name=name, _fn=getattr(mod, attr), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, attr, counted)
    return calls


def _port_scheduler(name: str, forced: bool):
    sched = tcore.create_scheduler(name, device=CPU)
    if forced:
        sched.KERNEL_MIN_NODES = 0
        sched.KERNEL_MIN_NODES_BATCH = 0
    return sched


def _nodes(storage, set_name: str, *, rack_of=None, zone_of=None):
    nodes = storage.make_node_set(set_name, 0.001)
    for i, node in enumerate(nodes):
        if rack_of is not None:
            node.rack = rack_of(i)
        if zone_of is not None:
            node.zone = zone_of(i)
    return nodes


def _si_key(si) -> tuple:
    pl = si.placement
    return (
        si.item.item_id, pl.k, pl.p, tuple(int(n) for n in pl.node_ids),
        si.chunk_mb, si.t_encode, si.t_decode, si.t_write, si.t_read,
    )


def _log_digest(sim) -> str:
    """The replay digest of ``test_simulator.TestRepairPriority``."""
    payload = repr([(round(d, 9), i, m) for d, i, m in sim.repair_log]).encode()
    return hashlib.sha256(payload).hexdigest()


def assert_same_run(got_sim, got, want_sim, want):
    """Every ``SimResult`` field equal but the measured wall times, every
    stored item's placement and I/O times equal, the repair log equal."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "sched_overhead_s":
            assert len(a) == len(b)
        elif f.name == "per_node_used_mb":
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        elif f.name == "stored_items":
            assert [_si_key(s) for s in a] == [_si_key(s) for s in b]
        else:
            assert a == b, f.name
    assert got_sim.repair_log == want_sim.repair_log
    assert _log_digest(got_sim) == _log_digest(want_sim)
    assert sorted(got_sim.live_items) == sorted(want_sim.live_items)


def _run_pair(name: str, forced: bool, nodes_of, items_of, cfg_of):
    """The same run through the JAX package and the port; returns both
    simulators and results."""
    jsim = jstorage.Simulator(nodes_of(jstorage), jcore.create_scheduler(name), cfg_of(jstorage, jcore))
    jres = jsim.run(items_of(jstorage))
    tsim = tstorage.Simulator(nodes_of(tstorage), _port_scheduler(name, forced), cfg_of(tstorage, tcore))
    tres = tsim.run(items_of(tstorage))
    return tsim, tres, jsim, jres


def _fig12_items(storage, rt=0.9, frac=0.15):
    nodes = storage.make_node_set("most_unreliable", 0.001)
    cap = sum(n.capacity_mb for n in nodes)
    return storage.make_trace("meva", seed=1, total_mb=cap * frac, reliability=rt)


class TestLegacyGoldens:
    """``test_simulator.TestLegacyEquivalence``'s 24 Fig. 12 runs: the
    port equals the JAX package field by field, and both are within the
    goldens' own tolerance."""

    GOLDEN = sim_gold.TestLegacyEquivalence.GOLDEN

    @pytest.mark.parametrize("key", sorted(GOLDEN, key=str), ids=str)
    def test_fig12_golden(self, key):
        rt, algo, nf = key
        schedule = tuple((70.0 * (i + 1) / (nf + 1), -1) for i in range(nf))
        tsim, tres, jsim, jres = _run_pair(
            algo, False,
            lambda st: st.make_node_set("most_unreliable", 0.001),
            lambda st: _fig12_items(st, rt),
            lambda st, core: st.SimConfig(failure_schedule=schedule, seed=1,
                                          repair_priority="fifo"),
        )
        assert_same_run(tsim, tres, jsim, jres)
        want_retained, want_stored = self.GOLDEN[key]
        assert tres.retained_fraction == pytest.approx(want_retained, abs=1e-9)
        assert tres.stored_mb == pytest.approx(want_stored, abs=1e-6)

    def test_replay_digest(self):
        """``TestRepairPriority``'s same-seed replay, pinned by its digest."""
        schedule = tuple((20.0 + 7.0 * i, -1) for i in range(5))
        tsim, tres, jsim, jres = _run_pair(
            "drex_lb", False,
            lambda st: st.make_node_set("most_unreliable", 0.001),
            lambda st: _fig12_items(st, 0.9, 0.1),
            lambda st, core: st.SimConfig(failure_schedule=schedule, seed=3,
                                          repair_bw_mbps=0.05),
        )
        assert _log_digest(tsim) == sim_gold.TestRepairPriority.REPLAY_DIGEST
        assert_same_run(tsim, tres, jsim, jres)


class TestSchedulers:
    @pytest.mark.parametrize("name,forced", RUNS, ids=RUN_IDS)
    def test_fig12_finite_bandwidth_rack_event(self, name, forced, scorer_calls):
        """Fig. 12's nodes and trace with 0.01 MB/s repair lanes, four
        weighted-random failures and a rack kill (five racks of two) in
        between: repairs queue, are voided in flight and re-planned."""
        tsim, tres, jsim, jres = _run_pair(
            name, forced,
            lambda st: _nodes(st, "most_unreliable", rack_of=lambda i: i % 5),
            lambda st: _fig12_items(st, 0.99),
            lambda st, core: st.SimConfig(
                failure_schedule=((14.0, -1), (28.0, -1), (47.0, -1), (56.0, -1)),
                rack_failure_schedule=((35.0, 2),),
                repair_bw_mbps=0.01, seed=1, measure_overhead=True,
            ),
        )
        assert_same_run(tsim, tres, jsim, jres)
        assert tres.n_node_failures >= 5 and tres.n_repairs_planned > 0
        if forced:
            assert scorer_calls[name] > 0
        assert len(tres.sched_overhead_s) == len(_fig12_items(tstorage, 0.99))

    @pytest.mark.parametrize(
        "name,forced",
        [("drex_sc", True), ("drex_sc", False), ("drex_lb", True),
         ("greedy_least_used", True), ("greedy_min_storage", True), ("daos", False)],
        ids=lambda v: str(v),
    )
    def test_join_heal_zone_event(self, name, forced, scorer_calls):
        """A named failure, a late join, a zone kill, a heal of the first
        victim and a finite shared repair lane, on the most_used set in
        two zones (nodes 0-4 and 5-9), two nodes a rack."""
        def cfg(st, core):
            joiner = core.StorageNode(node_id=10, capacity_mb=1.2e4, write_bw=210.0,
                                      read_bw=260.0, annual_failure_rate=0.02,
                                      rack=5, zone=0)
            return st.SimConfig(
                failure_schedule=((12.0, 3), (33.0, -1)),
                node_join_schedule=((20.0, joiner),),
                zone_failure_schedule=((40.0, 1),),
                node_heal_schedule=((48.0, 3), (55.0, 7)),
                repair_bw_mbps=0.2, cluster_repair_bw_mbps=0.5, seed=4,
            )

        tsim, tres, jsim, jres = _run_pair(
            name, forced,
            lambda st: _nodes(st, "most_used", rack_of=lambda i: i // 2,
                              zone_of=lambda i: i // 5),
            lambda st: st.make_trace("meva", seed=2, n_items=160, reliability=0.95),
            cfg,
        )
        assert_same_run(tsim, tres, jsim, jres)
        assert tsim.cluster.n_nodes == 11
        assert tsim.cluster.alive[3] and tsim.cluster.alive[7]
        assert tres.n_node_failures >= 6
        if forced:
            assert scorer_calls[name] > 0

    def test_default_device_is_the_card(self, monkeypatch):
        """A port ``Simulator`` given a scheduler by name decides on CUDA
        unless told otherwise: with no card, ``device=None`` raises."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        nodes = tstorage.make_node_set("most_used", 0.001)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstorage.Simulator(nodes, "drex_sc")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstorage.run_simulation(nodes, "drex_lb", [])
        sim = tstorage.Simulator(nodes, "drex_sc", device=CPU)
        assert sim.scheduler.device == torch.device(CPU)

    def test_invalid_priority_rejected(self):
        with pytest.raises(ValueError, match="repair_priority"):
            tstorage.SimConfig(repair_priority="lifo")

    def test_instant_repairs_never_linger(self):
        schedule = tuple((70.0 * (i + 1) / 5, -1) for i in range(4))
        tsim, tres, jsim, jres = _run_pair(
            "drex_lb", True,
            lambda st: st.make_node_set("most_unreliable", 0.001),
            lambda st: _fig12_items(st, 0.9),
            lambda st, core: st.SimConfig(failure_schedule=schedule, seed=1),
        )
        assert_same_run(tsim, tres, jsim, jres)
        assert tres.n_repairs_planned == tres.n_repairs_completed
        assert tres.n_repairs_aborted == 0 and math.isinf(tsim.config.repair_bw_mbps)
