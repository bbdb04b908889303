"""The streaming placement frontier: a long-lived service over
:class:`~repro_torch.core.engine.PlacementEngine`.

Open-loop arrivals are admitted into a bounded queue
(:mod:`.admission`), coalesced into micro-batched ``place_many``
*windows* (flush when the window fills or its oldest item has waited
``max_wait_s``), and decided against the live cluster; every flush and
every churn event publishes a snapshot :class:`~.epochs.Epoch` so reads
see a consistent view without ever blocking placements.

**Determinism.**  The service runs on a *virtual clock*: arrivals and
churn events carry virtual timestamps, and a deterministic service-time
model (``service_base_s + B * service_per_item_s`` virtual seconds per
window of B items) governs when the frontier is busy — which fixes
window composition, queue depths, and admission rejects as pure
functions of the trace and configuration.  Replaying the same trace +
seed therefore yields byte-identical placements on any machine (pinned
by golden-trace tests equal to the JAX package's), while the real
wall-clock cost of each ``place_many`` call is measured separately as
telemetry (p50/p99 decision latency) that never feeds back into
decisions.  Single-threaded by construction: "concurrency" between
readers and placements is the epoch snapshot discipline, not threads.

**Correctness under churn.**  ``place_many`` is bit-identical to
sequential ``place`` per item in arrival order, so placements are
invariant to how arrivals are partitioned into windows; the only thing
window boundaries decide is *which cluster state* an item is scored
against when failures/joins interleave with arrivals — exactly the
mid-window churn the service must absorb.  Failures route every affected
stored item through ``engine.plan_repair`` (the instantaneous
placement-plane model, matching ``Simulator._repair_or_drop`` with
infinite repair bandwidth), most-degraded first by
surviving-chunks-minus-K margin (the simulator's health priority);
unrecoverable items release their surviving chunks and are counted
lost — never silently.

Failure-domain awareness comes for free from the engine: construct the
``PlacementEngine`` with :class:`~repro_torch.core.types.PlacementConstraints`
and every placement and repair the frontier makes — including the
post-failure replans — honors the rack/zone caps and spread width.

**Device.**  The frontier is host code; the engine it is given carries
the device its scheduler scores windows on (CUDA unless the engine was
built with ``device="cpu"``).  The scorers hand back host placements,
so ``place_many`` has waited for the card when it returns and the
measured wall time covers the device work.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Iterable, Optional, Sequence

from repro_torch.core.engine import BatchContext, PlacementEngine
from repro_torch.core.types import DataItem, Placement, StorageNode

from .admission import AdmissionQueue
from .epochs import Epoch, EpochJournal
from .metrics import ServiceMetrics

__all__ = [
    "FrontierConfig",
    "PlacementFrontier",
    "ServiceEvent",
    "ServiceOutcome",
    "ServiceReport",
    "arrival_events",
    "churn_events",
    "placements_digest",
]

SECONDS_PER_DAY = 86400.0

#: outcome statuses (never a fourth: every offered item ends in one)
PLACED = "placed"
REJECTED = "rejected"               # scheduler found no feasible mapping
ADMISSION_REJECT = "admission_reject"  # queue was full (backpressure)

# event priorities at equal virtual time: cluster membership changes
# apply before arrivals, mirroring the simulator's event ordering.
_P_JOIN, _P_HEAL, _P_FAIL, _P_ARRIVAL = 0, 1, 2, 3
_PRIO = {"join": _P_JOIN, "heal": _P_HEAL, "fail": _P_FAIL, "arrival": _P_ARRIVAL}


@dataclasses.dataclass(frozen=True)
class FrontierConfig:
    """Tuning knobs for one frontier instance."""

    #: window flushes as soon as this many items are queued ...
    max_batch: int = 32
    #: ... or once its oldest item has waited this long (virtual s).
    max_wait_s: float = 0.05
    #: admission-queue bound; offers beyond it are rejected explicitly.
    queue_capacity: int = 256
    #: deterministic service-time model: a window of B items occupies
    #: the frontier for ``service_base_s + B * service_per_item_s``
    #: virtual seconds.  Fixed constants — never measured — so queue
    #: dynamics and admission decisions replay identically everywhere.
    service_base_s: float = 2e-3
    service_per_item_s: float = 1e-3
    #: snapshot epochs retained for history diffing.
    epoch_history: int = 8

    def service_s(self, batch: int) -> float:
        return self.service_base_s + batch * self.service_per_item_s


@dataclasses.dataclass(frozen=True)
class ServiceEvent:
    """One virtual-time event: ``kind`` in {arrival, fail, join, heal}."""

    t: float
    kind: str
    payload: object  # DataItem | node id | StorageNode


def arrival_events(items: Iterable[DataItem]) -> list[ServiceEvent]:
    """Arrival events from a trace (``DataItem.arrival_time`` seconds)."""
    return [ServiceEvent(float(it.arrival_time), "arrival", it) for it in items]


def churn_events(
    failure_schedule: Sequence[tuple[float, int]] = (),
    node_join_schedule: Sequence[tuple[float, StorageNode]] = (),
    node_heal_schedule: Sequence[tuple[float, int]] = (),
    *,
    unit: str = "days",
) -> list[ServiceEvent]:
    """Churn events from SimConfig-style ``(when, what)`` schedules.

    ``unit`` is ``"days"`` (the simulator's convention) or ``"seconds"``
    (the frontier's native clock).
    """
    scale = SECONDS_PER_DAY if unit == "days" else 1.0
    if unit not in ("days", "seconds"):
        raise ValueError(f"unknown time unit {unit!r}")
    out = [ServiceEvent(t * scale, "fail", int(n)) for t, n in failure_schedule]
    out += [ServiceEvent(t * scale, "join", node) for t, node in node_join_schedule]
    out += [ServiceEvent(t * scale, "heal", int(n)) for t, n in node_heal_schedule]
    return out


@dataclasses.dataclass(frozen=True)
class ServiceOutcome:
    """Per-item service result — one per offered item, no silent drops."""

    item_id: int
    status: str                      # PLACED | REJECTED | ADMISSION_REJECT
    placement: Optional[Placement]   # None unless PLACED
    reason: str                      # "" on success
    submit_t: float                  # virtual arrival time
    decide_t: float                  # virtual decision time (flush end)
    epoch_id: int                    # epoch published with this decision

    @property
    def ok(self) -> bool:
        return self.status == PLACED


@dataclasses.dataclass
class _StoredItem:
    """A placed item the frontier still tracks (the repair plane's unit)."""

    item: DataItem
    placement: Placement
    chunk_mb: float


@dataclasses.dataclass(frozen=True)
class ServiceReport:
    """Everything one :meth:`PlacementFrontier.run` produced."""

    outcomes: list[ServiceOutcome]
    summary: dict
    makespan_virtual_s: float

    def digest(self) -> int:
        return placements_digest(self.outcomes)


def placements_digest(outcomes: Sequence[ServiceOutcome]) -> int:
    """Order-sensitive digest of every outcome's placement bits, as an
    int so a benchmark gate can equality-check it (gates skip
    non-numeric leaves)."""
    h = hashlib.sha256()
    for o in outcomes:
        if o.placement is None:
            h.update(f"{o.item_id}|{o.status}|-\n".encode())
        else:
            p = o.placement
            h.update(
                f"{o.item_id}|{o.status}|{p.k},{p.p},{p.node_ids}\n".encode()
            )
    return int(h.hexdigest()[:12], 16)


class PlacementFrontier:
    """Single-threaded streaming placement service (see module docstring).

    Drive it with :meth:`run` over a merged event stream, or feed it
    piecemeal with :meth:`submit`/:meth:`advance` for interactive use.
    :meth:`read` returns the latest snapshot epoch at any point and
    never touches the live view.
    """

    def __init__(self, engine: PlacementEngine, config: FrontierConfig | None = None):
        if not engine.auto_commit:
            raise ValueError("the placement frontier requires auto_commit engines")
        self.engine = engine
        self.config = config or FrontierConfig()
        self.queue = AdmissionQueue(self.config.queue_capacity)
        self.ctx = BatchContext()
        self.metrics = ServiceMetrics()
        self.epochs = EpochJournal(keep=self.config.epoch_history)
        self.outcomes: list[ServiceOutcome] = []
        self.stored: dict[int, _StoredItem] = {}
        self.clock = 0.0        # virtual now
        self.busy_until = 0.0   # virtual time the current window ends
        self.epochs.publish(self.engine, 0.0)  # epoch 0: initial state

    # -- reads ---------------------------------------------------------------

    def read(self) -> Epoch:
        """Latest consistent snapshot; O(1), never blocks placements."""
        return self.epochs.latest()

    # -- event loop ----------------------------------------------------------

    def run(self, events: Iterable[ServiceEvent]) -> ServiceReport:
        """Process an event stream to completion (drains the queue)."""
        ordered = sorted(
            enumerate(events), key=lambda iv: (iv[1].t, _PRIO[iv[1].kind], iv[0])
        )
        for _, ev in ordered:
            if ev.t < self.clock:
                raise ValueError(
                    f"event at t={ev.t} is in the past (clock={self.clock})"
                )
            self.advance(ev.t)
            if ev.kind == "arrival":
                self.submit(ev.payload, ev.t)
            elif ev.kind == "fail":
                self._on_fail(ev.t, ev.payload)
            elif ev.kind == "join":
                self._on_join(ev.t, ev.payload)
            elif ev.kind == "heal":
                self._on_heal(ev.t, ev.payload)
            else:  # pragma: no cover - guarded by _PRIO lookup in sort
                raise ValueError(f"unknown event kind {ev.kind!r}")
        self.drain()
        makespan = max(self.clock, self.busy_until)
        epoch = self.epochs.publish(self.engine, makespan)
        summary = self.metrics.summary(makespan)
        summary["final_epoch_id"] = epoch.epoch_id
        summary["n_stored"] = len(self.stored)
        summary["ctx"] = {"hits": self.ctx.hits, "misses": self.ctx.misses}
        summary.update(self.queue.counters())
        return ServiceReport(
            outcomes=list(self.outcomes),
            summary=summary,
            makespan_virtual_s=makespan,
        )

    def submit(self, item: DataItem, t: float) -> None:
        """Offer one arrival at virtual time ``t`` (advance first)."""
        if not self.queue.offer(item, t):
            # Backpressure: explicit per-item reject, counted and
            # reported — the caller sees exactly which items bounced.
            self.metrics.n_rejected_admission += 1
            self.outcomes.append(
                ServiceOutcome(
                    item_id=item.item_id,
                    status=ADMISSION_REJECT,
                    placement=None,
                    reason=f"admission queue full ({self.queue.capacity})",
                    submit_t=t,
                    decide_t=t,
                    epoch_id=self.epochs.latest().epoch_id,
                )
            )
        self.metrics.record_depth(self.queue.depth)

    def advance(self, until: float) -> None:
        """Run every window flush due strictly before virtual ``until``."""
        while True:
            trigger = self._next_trigger()
            if trigger is None:
                break
            flush_t = max(trigger, self.busy_until)
            if flush_t >= until:
                break
            self._flush(flush_t)
        self.clock = max(self.clock, until)

    def drain(self) -> None:
        """Flush until the queue is empty (end of stream)."""
        while self.queue.depth:
            trigger = self._next_trigger()
            self._flush(max(trigger, self.busy_until))

    # -- internals -----------------------------------------------------------

    def _next_trigger(self) -> float | None:
        """Virtual time the next window becomes due: the moment it
        filled to ``max_batch``, or its oldest item's deadline."""
        oldest = self.queue.oldest_t()
        if oldest is None:
            return None
        deadline = oldest + self.config.max_wait_s
        if self.queue.depth >= self.config.max_batch:
            return min(deadline, self.queue.peek_t(self.config.max_batch - 1))
        return deadline

    def _flush(self, flush_t: float) -> None:
        """Decide one micro-batch window at virtual time ``flush_t``."""
        batch = self.queue.take(self.config.max_batch)
        items = [qi.item for qi in batch]
        w0 = time.perf_counter()
        records = self.engine.place_many(items, ctx=self.ctx)
        wall = time.perf_counter() - w0
        # busy_until, not clock, carries the window's completion: events
        # with t < done_t arrive while the window is in flight and are
        # processed after its commits (which applied at the flush).
        done_t = flush_t + self.config.service_s(len(batch))
        self.busy_until = done_t
        epoch = self.epochs.publish(self.engine, done_t)
        for qi, rec in zip(batch, records):
            if rec.ok:
                self.metrics.n_placed += 1
                self.stored[rec.item_id] = _StoredItem(
                    qi.item, rec.placement, rec.chunk_mb
                )
            else:
                self.metrics.n_rejected_placement += 1
            self.metrics.sojourn_virtual.record(done_t - qi.enqueued_t)
            self.outcomes.append(
                ServiceOutcome(
                    item_id=rec.item_id,
                    status=PLACED if rec.ok else REJECTED,
                    placement=rec.placement,
                    reason=rec.reason,
                    submit_t=qi.enqueued_t,
                    decide_t=done_t,
                    epoch_id=epoch.epoch_id,
                )
            )
        self.metrics.record_flush(len(batch), wall)

    # -- churn ---------------------------------------------------------------

    def _on_fail(self, t: float, node_id: int) -> None:
        """Fail-stop a node between windows; queued arrivals older than
        the failure are decided after it (churn lands mid-window)."""
        cluster = self.engine.cluster
        if node_id >= cluster.n_nodes or not cluster.alive[node_id]:
            return
        cluster.fail_stop(node_id)
        self.engine.observe_churn("fail", [node_id])
        self.metrics.n_failures += 1
        affected = [
            si for si in self.stored.values() if node_id in si.placement.node_ids
        ]
        # Health-prioritized replanning (same policy as the simulator's
        # repair queue): most-degraded first by surviving-chunks-minus-K
        # margin, deterministic item-id tie-break — replacement capacity
        # goes to the items nearest data loss.
        affected.sort(
            key=lambda si: (
                sum(1 for n in si.placement.node_ids if cluster.alive[n])
                - si.placement.k,
                si.item.item_id,
            )
        )
        for si in affected:
            self._repair_or_drop(si)
        self.epochs.publish(self.engine, t)

    def _repair_or_drop(self, si: _StoredItem) -> None:
        """Instantaneous placement-plane repair (the simulator's
        infinite-bandwidth model): replacements land immediately or the
        item is lost and its surviving chunks released."""
        plan = self.engine.plan_repair(
            si.item, si.placement, chunk_mb=si.chunk_mb, commit=True, ctx=self.ctx
        )
        if plan.ok:
            si.placement = plan.placement
            self.metrics.n_repairs += 1
            return
        cluster = self.engine.cluster
        alive_survivors = [n for n in plan.survivors if cluster.alive[n]]
        if alive_survivors:
            # release == per-entry subtract + clamp-at-zero, bitwise what
            # the old per-node max(0, used - chunk) loop computed
            cluster.release(alive_survivors, si.chunk_mb)
            self.engine.observe_external_release(alive_survivors, si.chunk_mb)
        self.metrics.n_items_lost += 1
        self.metrics.mb_lost += si.item.size_mb
        del self.stored[si.item.item_id]

    def _on_join(self, t: float, node: StorageNode) -> None:
        nid = self.engine.cluster.add_node(node)
        self.engine.observe_churn("join", [nid])
        self.metrics.n_joins += 1
        self.epochs.publish(self.engine, t)

    def _on_heal(self, t: float, node_id: int) -> None:
        cluster = self.engine.cluster
        if node_id >= cluster.n_nodes or cluster.alive[node_id]:
            return
        cluster.heal_node(node_id)
        self.engine.observe_churn("heal", [node_id])
        self.metrics.n_heals += 1
        self.epochs.publish(self.engine, t)
