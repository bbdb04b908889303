"""The port's streaming placement service and telemetry facade held
against the JAX package's, exactly.

On the JAX package's pinned scenario (``test_serve_placement``: a seeded
12-node cluster, 40 MEVA arrivals at 200 items/s, windows of 8) the
port's ``PlacementFrontier`` must give the four ``GOLDEN`` digests and
``GOLDEN_CHURN_SC``; every ``batch_scoring`` scheduler, with and without
churn, must give the reference's outcomes and deterministic summary
fields; the backpressure, epoch-consistency and interactive properties
hold at the reference tests' size; and ``repro_torch.telemetry.snapshot``
has the reference's schema.

The port runs on the CPU (``device="cpu"``).  Each kernel-backed
scheduler runs three ways: under the reference's dispatch rule (windows
of D-Rex SC, D-Rex LB and GreedyMinStorage go through the port's device
path, here over the plain ``pb_frontier``; GreedyLeastUsed's stay on the
host below 192 nodes), with the device path forced for every decision,
and on the numpy oracle alone (the path the JAX package takes here).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.serve.placement as jserve
import repro.telemetry as jtelemetry
import repro_torch.core as tcore
import repro_torch.serve.placement as tserve
from repro.storage import traces as jtraces
from repro_torch import telemetry as ttelemetry
from repro_torch.storage import traces as ttraces

import test_serve_placement as serve_gold

CPU = "cpu"
BATCHED = [
    n
    for n in sorted(set(tcore.scheduler_names()) | set(tcore.SCHEDULER_NAMES))
    if tcore.get_spec(n).capabilities.batch_scoring
]
#: how the port's scheduler decides: the reference's dispatch rule, the
#: device path forced, or the numpy oracle only.
MODES = ("dispatch", "forced", "oracle")
#: summary fields measured on the wall clock; every other one is a
#: function of the trace and configuration.
WALL_FIELDS = ("decision_wall", "decision_wall_total_s")


def _port_scheduler(name: str, mode: str = "dispatch"):
    sched = tcore.create_scheduler(name, device=CPU)
    if mode == "forced":
        sched.KERNEL_MIN_NODES = 0
        sched.KERNEL_MIN_NODES_BATCH = 0
    elif mode == "oracle":
        sched.use_kernel = False
    return sched


def _cluster(core, n: int = 12, seed: int = 7):
    """``test_serve_placement._cluster`` for either package."""
    rng = np.random.default_rng(seed)
    nodes = [
        core.StorageNode(
            node_id=i,
            capacity_mb=float(rng.uniform(5e5, 2e6)),
            write_bw=float(rng.uniform(100, 250)),
            read_bw=float(rng.uniform(100, 400)),
            annual_failure_rate=float(rng.uniform(0.003, 0.05)),
        )
        for i in range(n)
    ]
    return core.ClusterView.from_nodes(nodes)


def _trace(traces, n_items: int = 40, rate: float = 200.0, seed: int = 3):
    """``test_serve_placement._trace`` for either package."""
    base = traces.make_trace("meva", seed=seed, n_items=n_items)
    rng = np.random.default_rng(seed)
    at = np.cumsum(rng.exponential(1.0 / rate, size=n_items))
    return [dataclasses.replace(it, arrival_time=float(at[i])) for i, it in enumerate(base)]


def _churn(serve, core, traces):
    """``test_serve_placement._churn`` for either package."""
    return serve.arrival_events(_trace(traces)) + serve.churn_events(
        failure_schedule=((0.05, 3), (0.12, 7)),
        node_join_schedule=(
            (0.15, core.StorageNode(node_id=12, capacity_mb=1.5e6, write_bw=200.0,
                                    read_bw=300.0, annual_failure_rate=0.01)),
        ),
        node_heal_schedule=((0.18, 3),),
        unit="seconds",
    )


_CFG = dict(max_batch=8, max_wait_s=0.02)


def _port_run(sched, events=None, cfg=None, n: int = 12):
    frontier = tserve.PlacementFrontier(
        tcore.PlacementEngine(_cluster(tcore, n), sched),
        cfg or tserve.FrontierConfig(**_CFG),
    )
    report = frontier.run(
        events if events is not None else tserve.arrival_events(_trace(ttraces))
    )
    return frontier, report


def _ref_run(name: str, churn: bool):
    frontier = jserve.PlacementFrontier(
        jcore.PlacementEngine(_cluster(jcore), name), jserve.FrontierConfig(**_CFG)
    )
    events = (
        _churn(jserve, jcore, jtraces) if churn
        else jserve.arrival_events(_trace(jtraces))
    )
    return frontier, frontier.run(events)


def _outcome_rows(report) -> list[tuple]:
    rows = []
    for o in report.outcomes:
        pl = o.placement
        key = None if pl is None else (pl.k, pl.p, pl.node_ids)
        rows.append((o.item_id, o.status, key, o.reason, o.submit_t, o.decide_t, o.epoch_id))
    return rows


def _summary(report, with_ctx: bool = True) -> dict:
    """The summary's deterministic fields.  ``ctx`` counts the shared
    ``BatchContext``'s cache hits, which depend on the decision path: the
    JAX package decides through its oracles here, so the counts are held
    equal only when the port's scheduler does too."""
    drop = WALL_FIELDS + (() if with_ctx else ("ctx",))
    return {k: v for k, v in report.summary.items() if k not in drop}


def _stats(epoch) -> dict:
    """An epoch's engine counters without the measured ``overhead_s``."""
    return {k: v for k, v in epoch.stats.items() if k != "overhead_s"}


class TestGoldens:
    GOLDEN = serve_gold.TestGoldenTraces.GOLDEN

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("algo", sorted(GOLDEN))
    def test_pinned_digest(self, algo, mode):
        _, report = _port_run(_port_scheduler(algo, mode))
        assert report.digest() == self.GOLDEN[algo]

    @pytest.mark.parametrize("mode", MODES)
    def test_pinned_churn_digest(self, mode):
        _, report = _port_run(
            _port_scheduler("drex_sc", mode), events=_churn(tserve, tcore, ttraces)
        )
        assert report.digest() == serve_gold.TestGoldenTraces.GOLDEN_CHURN_SC

    def test_digest_text_is_the_references(self):
        """The digest hashes ``f"{node_ids}"``: the port's placements hold
        Python ints, as the reference's do, so the text is the same."""
        _, report = _port_run(_port_scheduler("drex_sc", "forced"))
        for o in report.outcomes:
            if o.placement is not None:
                assert all(type(n) is int for n in o.placement.node_ids)
        assert tserve.placements_digest(report.outcomes) == report.digest()


class TestEqualToReference:
    @pytest.mark.parametrize("churn", [False, True], ids=["arrivals", "churn"])
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("name", BATCHED)
    def test_outcomes_and_summary(self, name, mode, churn):
        jfront, jrep = _ref_run(name, churn)
        events = _churn(tserve, tcore, ttraces) if churn else None
        tfront, trep = _port_run(_port_scheduler(name, mode), events=events)
        assert _outcome_rows(trep) == _outcome_rows(jrep)
        assert trep.digest() == jrep.digest()
        assert trep.makespan_virtual_s == jrep.makespan_virtual_s
        with_ctx = mode == "oracle"
        assert _summary(trep, with_ctx) == _summary(jrep, with_ctx)
        assert trep.summary["decision_wall"]["count"] == jrep.summary["decision_wall"]["count"]
        tl, jl = tfront.read(), jfront.read()
        assert (tl.epoch_id, tl.mutation_seq, _stats(tl)) == (jl.epoch_id, jl.mutation_seq, _stats(jl))
        assert tl.cluster.used_mb.tobytes() == jl.cluster.used_mb.tobytes()
        assert tl.cluster.alive.tobytes() == jl.cluster.alive.tobytes()

    @pytest.mark.parametrize("name", BATCHED)
    def test_frontier_matches_sequential(self, name):
        """Windows are a batching construct: the port's frontier gives the
        placements of a per-item ``place`` loop on the port's engine."""
        _, report = _port_run(_port_scheduler(name))
        assert report.summary["n_rejected_admission"] == 0
        engine = tcore.PlacementEngine(_cluster(tcore), _port_scheduler(name))
        seq = {}
        for it in _trace(ttraces):
            r = engine.place(it)
            seq[r.item_id] = (tserve.PLACED if r.ok else tserve.REJECTED, r.placement)
        for o in report.outcomes:
            assert (o.status, o.placement) == seq[o.item_id], o.item_id

    def test_service_model_and_events(self):
        cfg = tserve.FrontierConfig()
        ref = jserve.FrontierConfig()
        assert dataclasses.astuple(cfg) == dataclasses.astuple(ref)
        assert cfg.service_s(17) == ref.service_s(17)
        with pytest.raises(ValueError, match="unit"):
            tserve.churn_events(unit="hours")
        days = tserve.churn_events(failure_schedule=((0.5, 2),))
        assert days == [tserve.ServiceEvent(43200.0, "fail", 2)]


class TestBackpressure:
    """``test_serve_placement.TestBackpressure`` on the port: 60 arrivals
    at 5,000 items/s into a queue of four."""

    CFG = dict(max_batch=4, max_wait_s=0.01, queue_capacity=4)

    def _overload(self, mode="dispatch"):
        return _port_run(
            _port_scheduler("greedy_least_used", mode),
            events=tserve.arrival_events(_trace(ttraces, n_items=60, rate=5000.0)),
            cfg=tserve.FrontierConfig(**self.CFG),
        )

    def test_no_silent_drops(self):
        _, report = self._overload()
        s = report.summary
        assert s["n_offered"] == 60 == len(report.outcomes)
        assert s["n_offered"] == (
            s["n_placed"] + s["n_rejected_placement"] + s["n_rejected_admission"]
        )
        assert {o.item_id for o in report.outcomes} == set(range(60))
        assert s["offered"] == s["admitted"] + s["admission_rejected"]

    def test_rejects_are_explicit_and_equal_to_reference(self):
        _, report = self._overload("oracle")
        rejected = [o for o in report.outcomes if o.status == tserve.ADMISSION_REJECT]
        assert rejected and len(rejected) == report.summary["n_rejected_admission"]
        for o in rejected:
            assert o.placement is None
            assert "queue full" in o.reason
            assert o.decide_t == o.submit_t
        jfront = jserve.PlacementFrontier(
            jcore.PlacementEngine(_cluster(jcore), "greedy_least_used"),
            jserve.FrontierConfig(**self.CFG),
        )
        jrep = jfront.run(jserve.arrival_events(_trace(jtraces, n_items=60, rate=5000.0)))
        assert _outcome_rows(report) == _outcome_rows(jrep)
        assert _summary(report) == _summary(jrep)

    def test_depth_bounded_and_deterministic(self):
        _, a = self._overload()
        _, b = self._overload()
        assert a.summary["max_queue_depth"] <= self.CFG["queue_capacity"]
        assert a.summary["max_queue_depth"] == b.summary["max_queue_depth"]
        assert a.digest() == b.digest()

    def test_queue_rejects_bad_capacity(self):
        with pytest.raises(ValueError, match="capacity"):
            tserve.AdmissionQueue(0)


class TestEpochConsistency:
    def test_epochs_monotonic_and_immutable(self):
        frontier, _ = _port_run(_port_scheduler("drex_sc"), events=_churn(tserve, tcore, ttraces))
        history = frontier.epochs.history()
        assert len(history) >= 2
        ids = [e.epoch_id for e in history]
        seqs = [e.mutation_seq for e in history]
        assert ids == sorted(ids) and len(set(ids)) == len(ids)
        assert seqs == sorted(seqs)
        for e in history:
            with pytest.raises(ValueError):
                e.cluster.used_mb[0] = 123.0
            with pytest.raises(ValueError):
                e.cluster.alive[0] = False

    def test_latest_epoch_matches_live_view(self):
        frontier, _ = _port_run(_port_scheduler("drex_sc"))
        epoch = frontier.read()
        live = frontier.engine.cluster
        assert np.array_equal(epoch.cluster.used_mb, live.used_mb)
        assert np.array_equal(epoch.cluster.alive, live.alive)
        assert epoch.mutation_seq == frontier.engine.mutation_seq
        assert epoch.n_live == int(live.alive.sum())

    def test_snapshots_decoupled_from_live_mutations(self):
        frontier, _ = _port_run(_port_scheduler("greedy_least_used"))
        epoch = frontier.read()
        before = epoch.cluster.used_mb.copy()
        live = frontier.engine.cluster
        with pytest.raises(ValueError):
            live.used_mb[0] += 999.0
        live.writable("used_mb")[0] += 999.0
        assert np.array_equal(epoch.cluster.used_mb, before)
        assert live.used_mb[0] == before[0] + 999.0

    def test_epochs_bracket_failures(self):
        frontier, _ = _port_run(_port_scheduler("drex_sc"), events=_churn(tserve, tcore, ttraces))
        dead = [e for e in frontier.epochs.history() if not e.cluster.alive[7]]
        assert dead, "failure epoch was not published"
        assert all(e.cluster.used_mb[7] == 0.0 for e in dead)
        assert not frontier.engine.cluster.alive[7]

    def test_epoch_ring_bounded(self):
        cfg = tserve.FrontierConfig(**_CFG, epoch_history=4)
        frontier, _ = _port_run(_port_scheduler("greedy_least_used"), cfg=cfg)
        assert len(frontier.epochs.history()) <= 4
        with pytest.raises(ValueError, match="latest"):
            tserve.EpochJournal(keep=0)


class TestChurnAndDriving:
    def test_failed_node_evacuated(self):
        events = tserve.arrival_events(_trace(ttraces)) + tserve.churn_events(
            failure_schedule=((0.1, 7),), unit="seconds"
        )
        frontier, report = _port_run(_port_scheduler("drex_sc"), events=events)
        for si in frontier.stored.values():
            assert 7 not in si.placement.node_ids
        s = report.summary
        assert s["n_failures"] == 1
        assert s["n_placed"] == len(frontier.stored) + s["n_items_lost"]

    def test_manual_drive(self):
        engine = tcore.PlacementEngine(_cluster(tcore), _port_scheduler("greedy_least_used"))
        frontier = tserve.PlacementFrontier(engine, tserve.FrontierConfig(**_CFG))
        epoch0 = frontier.read()
        for it in _trace(ttraces, n_items=6, rate=1000.0):
            frontier.submit(it, float(it.arrival_time))
        assert frontier.queue.depth == 6
        assert frontier.read().epoch_id == epoch0.epoch_id
        frontier.drain()
        assert frontier.queue.depth == 0 and len(frontier.outcomes) == 6
        assert frontier.read().epoch_id > epoch0.epoch_id

    def test_past_event_rejected(self):
        frontier, _ = _port_run(_port_scheduler("greedy_least_used"))
        with pytest.raises(ValueError, match="past"):
            frontier.run([tserve.ServiceEvent(0.0, "fail", 0)])

    def test_requires_auto_commit(self):
        engine = tcore.PlacementEngine(
            _cluster(tcore), _port_scheduler("greedy_least_used"), auto_commit=False
        )
        with pytest.raises(ValueError, match="auto_commit"):
            tserve.PlacementFrontier(engine)

    def test_default_device_is_the_card(self, monkeypatch):
        """An engine built by name for the service decides on CUDA unless
        told otherwise: with no card it raises."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.PlacementEngine(_cluster(tcore), "drex_sc")


class TestTelemetry:
    def test_schema_is_the_references(self):
        engine = tcore.PlacementEngine(_cluster(tcore), _port_scheduler("drex_sc"))
        engine.place_many(_trace(ttraces, n_items=8))
        snap = ttelemetry.snapshot(engine)
        ref = jtelemetry.snapshot(jcore.PlacementEngine(_cluster(jcore), "drex_sc"))
        assert [f.name for f in dataclasses.fields(snap)] == [
            f.name for f in dataclasses.fields(ref)
        ]
        d = snap.as_dict()
        assert set(d) == set(ref.as_dict())
        assert d["jit_cache"] is None
        assert set(d["engine"]) == set(ref.engine)
        assert d["engine"]["n_placed"] + d["engine"]["n_rejected"] == 8
        assert set(d["matrix_cache"]) == set(ref.matrix_cache)
        assert ttelemetry.snapshot().engine is None

    def test_snapshot_copies_and_reset_zeroes(self):
        ttelemetry.reset()
        engine = tcore.PlacementEngine(_cluster(tcore, 300), _port_scheduler("drex_lb"))
        engine.place_many(_trace(ttraces, n_items=8))
        snap = ttelemetry.snapshot(engine)
        assert snap.prefilter.get("drex_lb", {}).get("engaged", 0) > 0
        snap.prefilter.clear()
        assert ttelemetry.snapshot().prefilter
        ttelemetry.reset()
        after = ttelemetry.snapshot()
        assert after.prefilter == {}
        assert after.compile_cache == tcore.compile_cache_stats()
