"""Event-driven storage simulator (paper §5, simulator originally in C).

The run loop is a discrete-event core over a heap of typed events:

* **item arrivals** — the scheduler places each store request through the
  :class:`~repro_torch.core.engine.PlacementEngine` (Problem 1 constraints,
  per-item overhead telemetry);
* **fail-stop failures** — a node dies, its chunks are lost, and every
  affected item is routed through ``PlacementEngine.plan_repair`` (§5.7:
  replacement nodes freest-first, parity growth gated on the scheduler's
  declared capability).  Failures come in three granularities: single
  nodes (``failure_schedule``), whole racks and whole zones
  (``rack_failure_schedule`` / ``zone_failure_schedule`` against the
  :class:`ClusterView`'s rack/zone topology) — a correlated event kills
  every live node in the domain *atomically* (one void-then-replan pass
  over the batch), so repairs never target a node that dies in the same
  event.  Within an event, items replan most-degraded-first
  (``SimConfig.repair_priority="health"``: surviving-chunks-minus-K
  margin, item-id tie-break, re-derived at every event) so finite repair
  bandwidth is spent where data loss is nearest; ``"fifo"`` keeps the
  legacy insertion-order scan;
* **repair completions** — with a *finite* per-node repair bandwidth
  (``SimConfig.repair_bw_mbps``), a repair charges traffic on both sides
  of the reconstruction: each replacement node ingests its
  ``chunk_mb / repair_bw_mbps`` write, and each of the K survivors
  feeding the decode streams one chunk out through its own lane
  (``RepairPlan.read_mb`` — at 10k nodes the read side is what a shared
  repair fabric actually saturates).  Each node runs one repair transfer
  at a time, so repairs queue; an optional *cluster-wide* budget
  (``cluster_repair_bw_mbps``) additionally serializes the total
  read+write traffic of all repairs through one shared lane.  An item
  whose surviving chunks (or replacement targets) are hit by another
  failure while its repair is still in flight loses the repair — and is
  dropped outright if fewer than K chunks remain.  This is the
  repair-rate sensitivity that repair-bandwidth lower bounds (Luby et
  al., arXiv:2002.07904) show governs data survival; the legacy
  instantaneous-repair model is exactly the ``repair_bw_mbps=inf``
  (and ``cluster_repair_bw_mbps=inf``) special case and reproduces the
  pre-refactor results bit-for-bit (except D-Rex SC, whose saturation
  anchor changed intentionally with the ``smin_mb`` seeding fix — see
  ``TestLegacyEquivalence``).
* **node joins / heals** — late-arriving nodes
  (``SimConfig.node_join_schedule``) grow the cluster view mid-run and
  immediately become placement/repair candidates; healed nodes
  (``SimConfig.node_heal_schedule``) return alive and empty.

Metrics are unchanged: W — bytes successfully stored — and T — average
I/O throughput over encode+decode+write+read (Eq. in §3.2); the Fig. 12
retained-fraction metric now responds to repair bandwidth.

Transfer model per the paper: all chunk transfers are parallel, no shared
links, so the slowest node in the mapping bottlenecks both the write and
the read; encode/decode times come from the calibrated linear model
(:class:`repro_torch.core.types.ECTimeModel`).

**Port.**  The event loop is the JAX package's ``storage/simulator.py``
unchanged: host numpy float64, the same heap order, the same repair
passes and lane bookings, the same ``rng`` draws, so every result and
``repair_log`` equals the reference's.  The one addition is ``device``:
a scheduler given by name is built on it (``None`` means CUDA, and raises
without a card; pass ``device="cpu"`` for the CPU), and an instance keeps
its own.  Whether a decision reaches the card is the scheduler's dispatch
rule: at the paper's ten nodes D-Rex SC decides on the host, at 10,000 on
the card.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.algorithms import Scheduler
from repro_torch.core.engine import BatchContext, PlacementEngine
from repro_torch.core.repair import RepairPlan
from repro_torch.core.types import (
    ClusterView,
    DataItem,
    ECTimeModel,
    Placement,
    PlacementConstraints,
    StorageNode,
)

__all__ = ["SimConfig", "SimResult", "StoredItem", "Simulator", "run_simulation"]

SECONDS_PER_DAY = 86400.0

# Event priorities: ties at the same instant resolve in this order.
# Joins/heals first (capacity becomes available), then completions of
# in-flight repairs, then failures, then arrivals — failures preceding
# same-day arrivals matches the legacy loop's ``day <= arrival`` rule.
_P_JOIN, _P_HEAL, _P_REPAIR, _P_FAIL, _P_ARRIVAL = range(5)


@dataclasses.dataclass
class SimConfig:
    time_model: ECTimeModel = dataclasses.field(default_factory=ECTimeModel)
    #: (day, node_id) forced fail-stop events; node_id -1 = weighted random.
    failure_schedule: tuple[tuple[float, int], ...] = ()
    #: (day, rack_id) correlated fail-stop: every live node in the rack
    #: dies atomically (ToR switch / PDU loss).  Rack ids come from the
    #: cluster's ``ClusterView.rack`` topology.
    rack_failure_schedule: tuple[tuple[float, int], ...] = ()
    #: (day, zone_id) correlated fail-stop of a whole zone.
    zone_failure_schedule: tuple[tuple[float, int], ...] = ()
    #: dynamic schedulers may add parity chunks when repairing (§5.7).
    allow_parity_growth: bool = True
    seed: int = 0
    #: measure per-item scheduling latency (Table 2).
    measure_overhead: bool = False
    #: per-node repair bandwidth (MB/s); each node runs one repair
    #: transfer at a time — replacement targets ingest their chunk write,
    #: the K decode-source survivors stream their chunk read — so repairs
    #: queue.  ``inf`` reproduces the legacy instantaneous-repair model
    #: exactly (together with ``cluster_repair_bw_mbps=inf``).
    repair_bw_mbps: float = math.inf
    #: shared cluster-wide repair budget (MB/s): the *total* read+write
    #: traffic of every repair additionally serializes through one
    #: cluster lane (an oversubscribed core/aggregation fabric).  ``inf``
    #: (default) disables the shared budget.
    cluster_repair_bw_mbps: float = math.inf
    #: (day, StorageNode) nodes joining the cluster mid-run.
    node_join_schedule: tuple[tuple[float, StorageNode], ...] = ()
    #: (day, node_id) failed nodes returning alive and empty.
    node_heal_schedule: tuple[tuple[float, int], ...] = ()
    #: replanning order when one failure event touches several items:
    #: ``"health"`` (default) repairs the most-degraded first, keyed by
    #: surviving-chunks-minus-K margin with a deterministic item-id
    #: tie-break, and re-derives the priorities at every failure event;
    #: ``"fifo"`` keeps the legacy insertion-order scan.  Under finite
    #: repair bandwidth, health ordering spends the budget where data
    #: loss is nearest — an item one failure from death books lanes
    #: before one that can still lose P more chunks.
    repair_priority: str = "health"
    #: failure-domain constraints applied to every placement and repair
    #: the simulator's engine makes (rack/zone caps + spread width).
    constraints: Optional[PlacementConstraints] = None

    def __post_init__(self) -> None:
        if self.repair_priority not in ("health", "fifo"):
            raise ValueError(
                f"repair_priority must be 'health' or 'fifo', "
                f"got {self.repair_priority!r}"
            )


@dataclasses.dataclass
class StoredItem:
    item: DataItem
    placement: Placement
    chunk_mb: float
    t_encode: float
    t_decode: float
    t_write: float
    t_read: float

    @property
    def io_time(self) -> float:
        return self.t_encode + self.t_decode + self.t_write + self.t_read


@dataclasses.dataclass
class _PendingRepair:
    """An in-flight repair: the plan is committed (capacity reserved) but
    the replacement chunks have not landed yet."""

    repair_id: int
    plan: RepairPlan
    finish_day: float
    #: per-node transfer window (start_day, end_day) booked on that
    #: node's repair lane — replacement-chunk writes on the new nodes,
    #: decode-source reads on the first K survivors (disjoint key sets by
    #: construction) — released if the repair is voided.
    transfers: dict[int, tuple[float, float]]
    #: (start_day, end_day) booked on the shared cluster repair lane
    #: (``SimConfig.cluster_repair_bw_mbps``); None when the budget is
    #: infinite.
    cluster_window: Optional[tuple[float, float]] = None


@dataclasses.dataclass
class SimResult:
    stored_mb: float
    total_mb: float
    n_stored: int
    n_failed_writes: int
    #: bytes lost/dropped due to node failures (subset of stored_mb).
    dropped_mb: float
    #: Eq. §3.2: W / sum of IO times over successfully stored items.
    throughput_mbps: float
    time_breakdown: dict
    per_node_used_mb: np.ndarray
    stored_items: list[StoredItem]
    failed_item_ids: list[int]
    sched_overhead_s: list[float]
    n_node_failures: int = 0
    #: occupancy each node held at the moment it failed (latest failure
    #: per node) — ``per_node_used_mb`` shows failed nodes as 0, so this
    #: is what lets Fig. 7-style utilization plots distinguish a dead
    #: node from an idle one.
    used_mb_at_failure: dict[int, float] = dataclasses.field(default_factory=dict)
    n_repairs_planned: int = 0
    n_repairs_completed: int = 0
    #: repairs voided mid-flight (a source or target died before the
    #: replacement chunks landed); each is re-planned or dropped.
    n_repairs_aborted: int = 0
    #: replacement bytes actually landed by completed repairs.
    repaired_mb: float = 0.0
    #: decode-source bytes streamed off the K survivors by completed
    #: repairs (the read side of ``RepairPlan.total_traffic_mb``).
    repair_read_mb: float = 0.0

    @property
    def stored_fraction(self) -> float:
        return self.stored_mb / self.total_mb if self.total_mb else 0.0

    @property
    def retained_fraction(self) -> float:
        """Fraction of successfully-stored bytes still retained at the end
        (Fig. 12 metric)."""
        if self.stored_mb <= 0:
            return 0.0
        return max(0.0, (self.stored_mb - self.dropped_mb)) / self.stored_mb


class Simulator:
    def __init__(
        self,
        nodes: Sequence[StorageNode],
        scheduler: Scheduler | str,
        config: SimConfig | None = None,
        *,
        device=None,
    ):
        self.nodes = list(nodes)
        self.config = config or SimConfig()
        # The engine owns the view, commits placements and repair
        # reservations, and measures per-decision overhead; the sim
        # shares one BatchContext across the whole run (AFRs never change
        # mid-simulation) so the reliability DP amortizes over the trace.
        self.engine = PlacementEngine(
            ClusterView.from_nodes(self.nodes),
            scheduler,
            constraints=self.config.constraints,
            device=device,
        )
        self.scheduler = self.engine.scheduler
        self.cluster = self.engine.cluster
        self.ctx = BatchContext()
        self.rng = np.random.default_rng(self.config.seed)
        self.live_items: dict[int, StoredItem] = {}
        self.dropped_mb = 0.0
        self.n_node_failures = 0
        self.used_mb_at_failure: dict[int, float] = {}
        # Event heap + in-flight repair state.
        self._events: list[tuple[float, int, int, tuple]] = []
        self._seq = itertools.count()
        self._pending: dict[int, _PendingRepair] = {}
        self._repair_ids = itertools.count()
        #: day each node's repair lane frees up (finite-bandwidth mode).
        self._repair_free_at: dict[int, float] = {}
        #: day the shared cluster repair lane frees up
        #: (finite ``cluster_repair_bw_mbps`` mode).
        self._cluster_lane_free_at = 0.0
        #: simulation clock: the timestamp of the event being processed.
        self._now = 0.0
        self.n_repairs_planned = 0
        self.n_repairs_completed = 0
        self.n_repairs_aborted = 0
        self.repaired_mb = 0.0
        self.repair_read_mb = 0.0
        #: deterministic replan trace: one ``(day, item_id, margin)`` row
        #: per repair-or-drop decision, in the exact order the decisions
        #: were made — the same-seed replay digest hashes this.
        self.repair_log: list[tuple[float, int, int]] = []

    # -- store path ---------------------------------------------------------

    def _io_times(self, item: DataItem, pl: Placement) -> tuple[float, float, float, float]:
        tm = self.config.time_model
        ids = list(pl.node_ids)
        chunk = pl.chunk_size_mb(item.size_mb)
        t_write = chunk / float(self.cluster.write_bw[ids].min())
        t_read = chunk / float(self.cluster.read_bw[ids].min())
        return (
            tm.t_encode(pl.n, pl.k, item.size_mb),
            tm.t_decode(pl.k, item.size_mb),
            t_write,
            t_read,
        )

    def store(self, item: DataItem) -> tuple[Optional[StoredItem], float]:
        # The engine re-checks Problem 1's write-success constraints and
        # commits; record.overhead_s is the per-item latency of Table 2.
        record = self.engine.place(item, ctx=self.ctx)
        if record.placement is None:
            return None, record.overhead_s
        pl = record.placement
        te, td, tw, tr = self._io_times(item, pl)
        si = StoredItem(item, pl, record.chunk_mb, te, td, tw, tr)
        self.live_items[item.item_id] = si
        return si, record.overhead_s

    # -- cluster membership ---------------------------------------------------

    def add_node(self, node: StorageNode) -> int:
        """Elastic join: the node becomes a placement/repair candidate for
        every subsequent decision."""
        nid = self.cluster.add_node(node)
        self.engine.observe_churn("join", [nid])
        self.nodes.append(node)
        return nid

    def heal_node(self, node_id: int) -> None:
        """Fail-stop recovery: the node returns alive and empty."""
        if self.cluster.alive[node_id]:
            return
        self.cluster.heal_node(node_id)
        self.engine.observe_churn("heal", [node_id])
        self._repair_free_at[node_id] = 0.0

    # -- failure path (§5.7) --------------------------------------------------

    def fail_node(self, node_id: int, day: float = 0.0) -> None:
        """Fail-stop ``node_id`` at time ``day`` (see :meth:`fail_nodes`)."""
        self.fail_nodes([node_id], day=day)

    def fail_nodes(self, node_ids: Sequence[int], day: float = 0.0) -> None:
        """Atomically fail-stop every node in ``node_ids`` at time
        ``day``; plan repair (or drop) for every affected item, including
        items whose in-flight repairs the failures void.  ``day`` is
        clamped to the simulation clock, so direct mid-run callers can
        never book repair transfers in the past.

        All deaths land *before* any replanning (this is what the
        correlated rack/zone events rely on): a repair planned for one
        victim can never choose another same-event victim as a
        replacement target or decode source.  Replanning order follows
        ``SimConfig.repair_priority``: most-degraded-first by
        surviving-chunks-minus-K margin (``"health"``, the default,
        item-id tie-break), or the legacy insertion-order scan
        (``"fifo"`` — with which a single-node event is exactly the old
        ``fail_node``, same decisions bit-for-bit).  Every decision is
        appended to :attr:`repair_log` in replan order."""
        dead: list[int] = []
        for nid in node_ids:
            nid = int(nid)
            if (
                nid >= self.cluster.n_nodes
                or not self.cluster.alive[nid]
                or nid in dead
            ):
                continue
            dead.append(nid)
        if not dead:
            return
        day = max(float(day), self._now)
        for nid in dead:
            self.used_mb_at_failure[nid] = float(self.cluster.used_mb[nid])
            self.cluster.fail_stop(nid)
            self.n_node_failures += 1
        self.engine.observe_churn("fail", dead)
        dead_set = set(dead)
        # Two passes: first void every in-flight repair these failures
        # touch (a reconstruction source or replacement target died),
        # returning capacity reservations and unused lane time — only
        # then re-plan.  Interleaving the two would let a re-plan book a
        # lane window that a later void still occupies, leaving one lane
        # with overlapping transfers.
        affected: list[tuple[int, int, StoredItem, Optional[list[int]]]] = []
        for iid in list(self.live_items):
            si = self.live_items[iid]
            pend = self._pending.get(iid)
            if pend is not None:
                if dead_set.isdisjoint(pend.plan.survivors) and dead_set.isdisjoint(
                    pend.plan.new_nodes
                ):
                    continue
                self.engine.abort_repair(pend.plan)
                self._release_lanes(pend, day)
                del self._pending[iid]
                self.n_repairs_aborted += 1
                survivors = [
                    n for n in pend.plan.survivors if self.cluster.alive[n]
                ]
                margin = len(survivors) - si.placement.k
                affected.append((margin, iid, si, survivors))
            elif not dead_set.isdisjoint(si.placement.node_ids):
                n_live = sum(
                    1 for n in si.placement.node_ids if self.cluster.alive[n]
                )
                affected.append((n_live - si.placement.k, iid, si, None))
        if self.config.repair_priority == "health":
            # Health-prioritized repair: most-degraded items (smallest
            # surviving-chunks-minus-K margin) replan first, so finite
            # repair bandwidth is booked where data loss is nearest;
            # deterministic item-id tie-break.  Margins are re-derived at
            # every failure event, so a second event re-prioritizes the
            # items it voids.  "fifo" preserves the legacy
            # insertion-order scan.
            affected.sort(key=lambda entry: (entry[0], entry[1]))
        for margin, iid, si, survivors in affected:
            self.repair_log.append((day, iid, margin))
            self._repair_or_drop(si, day, survivors=survivors)

    def _repair_or_drop(
        self,
        si: StoredItem,
        day: float,
        survivors: Optional[list[int]] = None,
    ) -> None:
        plan = self.engine.plan_repair(
            si.item,
            si.placement,
            chunk_mb=si.chunk_mb,
            survivors=survivors,
            allow_parity_growth=self.config.allow_parity_growth,
            commit=True,
            ctx=self.ctx,
        )
        if not plan.ok:
            self._drop(si, holding=plan.survivors)
            return
        self.n_repairs_planned += 1
        if not plan.new_nodes:
            si.placement = plan.placement
            return
        bw = self.config.repair_bw_mbps
        cbw = self.config.cluster_repair_bw_mbps
        if math.isinf(bw) and math.isinf(cbw):
            # Legacy instantaneous-repair model: chunks land now.
            si.placement = plan.placement
            self.n_repairs_completed += 1
            self.repaired_mb += plan.repair_mb
            self.repair_read_mb += plan.read_mb
            return
        # Finite repair budget: both sides of the reconstruction book
        # transfer windows, one at a time per node lane — each replacement
        # node ingests its chunk write, each of the K decode-source
        # survivors streams its chunk read (survivors and new nodes are
        # disjoint, so every lane sees at most one window per repair) —
        # and the repair completes when the slowest transfer lands.
        # Until then the item has only its surviving chunks.
        finish = day
        transfers: dict[int, tuple[float, float]] = {}
        if not math.isinf(bw):
            transfer_days = (si.chunk_mb / bw) / SECONDS_PER_DAY
            for n in plan.new_nodes:
                start = max(day, self._repair_free_at.get(n, 0.0))
                end = start + transfer_days
                self._repair_free_at[n] = end
                transfers[n] = (start, end)
                finish = max(finish, end)
            for n in plan.survivors[: plan.placement.k]:
                start = max(day, self._repair_free_at.get(n, 0.0))
                end = start + transfer_days
                self._repair_free_at[n] = end
                transfers[n] = (start, end)
                finish = max(finish, end)
        cluster_window: Optional[tuple[float, float]] = None
        if not math.isinf(cbw):
            # Shared fabric: the repair's *total* read+write traffic
            # serializes through the cluster lane on top of the per-node
            # windows.
            gstart = max(day, self._cluster_lane_free_at)
            gend = gstart + (plan.total_traffic_mb / cbw) / SECONDS_PER_DAY
            self._cluster_lane_free_at = gend
            cluster_window = (gstart, gend)
            finish = max(finish, gend)
        rid = next(self._repair_ids)
        self._pending[si.item.item_id] = _PendingRepair(
            rid, plan, finish, transfers, cluster_window
        )
        self._push(finish, _P_REPAIR, ("repair", si.item.item_id, rid))

    def _release_lanes(self, pend: _PendingRepair, day: float) -> None:
        """Return the un-run remainder of a voided repair's lane bookings
        so later repairs don't queue behind phantom transfers.

        Approximation: repairs already queued *behind* the voided
        transfers keep their original (now conservative) completion
        events — only reservations made after this point see the freed
        lane time.  Dead nodes are skipped; their lanes reset on heal."""
        for n, (start, end) in pend.transfers.items():
            if not self.cluster.alive[n]:
                continue
            remaining = max(0.0, end - max(start, day))
            if remaining > 0.0:
                self._repair_free_at[n] = (
                    self._repair_free_at.get(n, 0.0) - remaining
                )
        if pend.cluster_window is not None:
            start, end = pend.cluster_window
            remaining = max(0.0, end - max(start, day))
            if remaining > 0.0:
                self._cluster_lane_free_at -= remaining

    def _drop(self, si: StoredItem, holding: Sequence[int] | None = None) -> None:
        """Permanently lose an item; ``holding`` names the nodes that
        still carry its chunks (defaults to the full placement)."""
        nodes = si.placement.node_ids if holding is None else holding
        alive_holding = [n for n in nodes if self.cluster.alive[n]]
        if alive_holding:
            # release == per-entry subtract + clamp-at-zero, bitwise what
            # the old per-node max(0, used - chunk) loop computed
            self.cluster.release(alive_holding, si.chunk_mb)
            self.engine.observe_external_release(alive_holding, si.chunk_mb)
        self.dropped_mb += si.item.size_mb
        pend = self._pending.pop(si.item.item_id, None)
        if pend is not None:
            # Defensive: today every caller voids an item's in-flight
            # repair before dropping it, but a dropped item must never
            # keep engine reservations or phantom lane bookings alive.
            self.engine.abort_repair(pend.plan)
            self._release_lanes(pend, self._now)
            self.n_repairs_aborted += 1
        del self.live_items[si.item.item_id]

    # -- event loop ------------------------------------------------------------

    def _push(self, day: float, prio: int, payload: tuple) -> None:
        heapq.heappush(self._events, (day, prio, next(self._seq), payload))

    def run(self, items: Sequence[DataItem]) -> SimResult:
        for day, nid in sorted(self.config.failure_schedule):
            self._push(day, _P_FAIL, ("fail", nid))
        for day, rid in sorted(self.config.rack_failure_schedule):
            self._push(day, _P_FAIL, ("rack_fail", int(rid)))
        for day, zid in sorted(self.config.zone_failure_schedule):
            self._push(day, _P_FAIL, ("zone_fail", int(zid)))
        for day, node in sorted(
            self.config.node_join_schedule, key=lambda e: e[0]
        ):
            self._push(day, _P_JOIN, ("join", node))
        for day, nid in sorted(self.config.node_heal_schedule):
            self._push(day, _P_HEAL, ("heal", nid))
        for item in items:
            self._push(
                item.arrival_time / SECONDS_PER_DAY, _P_ARRIVAL, ("arrival", item)
            )

        stored: list[StoredItem] = []
        failed_ids: list[int] = []
        overheads: list[float] = []
        total_mb = 0.0
        while self._events:
            day, _prio, _seq, payload = heapq.heappop(self._events)
            self._now = max(self._now, day)
            kind = payload[0]
            if kind == "arrival":
                item = payload[1]
                total_mb += item.size_mb
                si, ovh = self.store(item)
                if self.config.measure_overhead:
                    overheads.append(ovh)
                if si is None:
                    failed_ids.append(item.item_id)
                else:
                    stored.append(si)
            elif kind == "fail":
                nid = payload[1]
                if nid < 0:
                    nid = self._draw_failing_node()
                if nid is not None:
                    self.fail_node(int(nid), day=day)
            elif kind in ("rack_fail", "zone_fail"):
                domain = (
                    self.cluster.rack if kind == "rack_fail" else self.cluster.zone
                )
                victims = np.nonzero(
                    (domain == payload[1]) & self.cluster.alive
                )[0]
                self.fail_nodes([int(n) for n in victims], day=day)
            elif kind == "repair":
                self._complete_repair(payload[1], payload[2])
            elif kind == "join":
                self.add_node(payload[1])
            elif kind == "heal":
                self.heal_node(int(payload[1]))

        stored_mb = float(sum(s.item.size_mb for s in stored))
        tsum = {
            "encode": float(sum(s.t_encode for s in stored)),
            "decode": float(sum(s.t_decode for s in stored)),
            "write": float(sum(s.t_write for s in stored)),
            "read": float(sum(s.t_read for s in stored)),
        }
        io_total = sum(tsum.values())
        return SimResult(
            stored_mb=stored_mb,
            total_mb=total_mb,
            n_stored=len(stored),
            n_failed_writes=len(failed_ids),
            dropped_mb=self.dropped_mb,
            throughput_mbps=stored_mb / io_total if io_total > 0 else 0.0,
            time_breakdown=tsum,
            per_node_used_mb=self.cluster.used_mb.copy(),
            stored_items=stored,
            failed_item_ids=failed_ids,
            sched_overhead_s=overheads,
            n_node_failures=self.n_node_failures,
            used_mb_at_failure=dict(self.used_mb_at_failure),
            n_repairs_planned=self.n_repairs_planned,
            n_repairs_completed=self.n_repairs_completed,
            n_repairs_aborted=self.n_repairs_aborted,
            repaired_mb=self.repaired_mb,
            repair_read_mb=self.repair_read_mb,
        )

    def _complete_repair(self, item_id: int, repair_id: int) -> None:
        pend = self._pending.get(item_id)
        if pend is None or pend.repair_id != repair_id:
            return  # stale event: the repair was aborted or the item dropped
        si = self.live_items[item_id]
        si.placement = pend.plan.placement
        del self._pending[item_id]
        self.n_repairs_completed += 1
        self.repaired_mb += pend.plan.repair_mb
        self.repair_read_mb += pend.plan.read_mb

    def _draw_failing_node(self) -> Optional[int]:
        live = self.cluster.live_ids()
        if live.size == 0:
            return None
        daily = -np.expm1(-self.cluster.afr[live] / 365.25)
        w = daily / daily.sum()
        return int(self.rng.choice(live, p=w))


def run_simulation(
    nodes: Sequence[StorageNode],
    scheduler: Scheduler | str,
    items: Sequence[DataItem],
    config: SimConfig | None = None,
    *,
    device=None,
) -> SimResult:
    return Simulator(nodes, scheduler, config, device=device).run(items)
