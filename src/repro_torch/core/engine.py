"""Placement engine: the one entry point through which items get placed.

The engine owns a :class:`ClusterView`, runs a registered scheduler over
it, commits accepted placements, and emits structured per-decision
telemetry (:class:`PlacementRecord`).  It adds the two things the bare
``Scheduler.place`` call sites (simulator, checkpoint manager,
benchmarks) each reimplemented ad hoc:

* **commit/rollback** — ``place`` commits the chunk bytes to the view
  (optional); :meth:`PlacementEngine.snapshot` /
  :meth:`PlacementEngine.rollback` restore the view exactly, and
  ``place_many(..., atomic=True)`` rolls the whole batch back if any
  item is rejected.
* **batched placement** — :meth:`PlacementEngine.place_many` threads a
  shared :class:`BatchContext` through the scheduler so pure derived
  quantities (failure probabilities per retention window, Poisson-
  binomial parity frontiers per sorted node sequence) are computed once
  per batch instead of once per item.  Caches key on the *exact inputs*
  of each computation, so batched placements are bit-identical to
  sequential ``place`` calls — the DP cost of D-Rex SC simply amortizes
  whenever consecutive items see an unchanged sort order.  Rescoring
  after a commit is *dependency-aware*: schedulers declaring the
  ``windowed_scoring`` capability keep pending scores whose
  ``Decision.window`` is provably untouched (see
  :meth:`PlacementEngine._place_many_batched`).
* **repair planning** — :meth:`PlacementEngine.plan_repair` routes
  degraded-item re-placement through the shared
  :class:`~repro_torch.core.repair.RepairPlanner` (capability-gated parity
  growth, reliability feasibility via the same DP kernel), with the same
  commit/telemetry treatment as placements; the simulator's failure path
  and the checkpoint manager's proactive repair both delegate here.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import telemetry

from . import constraints as constraints_mod
from . import greedy_kernel
from .registry import create_scheduler, scheduler_capabilities
from .reliability import min_parity_for_target, ParityFrontier
from .repair import RepairPlan, RepairPlanner
from .types import (
    ClusterView,
    DataItem,
    Placement,
    PlacementConstraints,
    StorageNode,
)

__all__ = [
    "BatchContext",
    "PlacementRecord",
    "PlacementEngine",
    "RepairPlan",
    "batch_stats",
]


class BatchContext:
    """Memoization scope shared by the items of one batch.

    All caches key on the exact content of their inputs (byte-hashed
    arrays + scalars), never on cluster identity or time, so a cache hit
    returns precisely what recomputation would — schedulers may consult
    the context freely without changing their decisions.  The context
    assumes node failure *rates* are constant while it lives (occupancy
    and liveness may change freely); discard it if AFRs are edited.

    **Commit staleness.** Content keying is what makes the context safe
    across the commits of a batch: a committed placement changes free
    space, which changes the free-desc node ordering the prefix-greedy
    schedulers sort by, which changes the permuted failure-probability
    sequence that *is* the frontier cache key — so the Nth item of a
    batch can never be served a frontier computed against pre-commit
    free space unless the orderings (and hence the DPs) are genuinely
    identical, in which case reuse is exact.  Quantities that depend on
    occupancy itself (capacity fits, saturation, balance penalties) are
    never cached here; schedulers always read them fresh from the view.
    Pinned by ``TestBatchStaleness`` in tests/test_engine.py.
    """

    #: default bound on cached entries per cache; content keys churn with
    #: cluster occupancy, so a long-lived context (e.g. the simulator's
    #: run-long one) would otherwise grow without bound over large traces.
    MAX_ENTRIES = 4096

    def __init__(self, max_entries: int | None = None):
        self.max_entries = self.MAX_ENTRIES if max_entries is None else max_entries
        self._fp_seen: set[tuple[float, int]] = set()
        self._frontiers: dict[tuple[bytes, float], ParityFrontier] = {}
        self._min_parity: dict[tuple[bytes, float], int] = {}
        self._rna_rows: dict[tuple[bytes, float, int], np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def _bound(self, cache) -> None:
        # Plain clear-on-full: memoization is pure, so dropping entries
        # only costs recomputation, never correctness.
        if len(cache) >= self.max_entries:
            cache.clear()

    def fail_probs(self, cluster: ClusterView, delta_t_days: float) -> np.ndarray:
        """Per-node failure probabilities for one retention window.

        Delegates to :meth:`ClusterView.fail_probs`, which caches per
        ``delta_t`` against an AFR-content mirror with touched-entry
        refresh — correct across AFR edits, joins and accidental sharing
        of a context across engines/clusters, without hashing all N AFR
        bytes per decision the way the old ``(delta_t, afr.tobytes())``
        key did.  Hit/miss telemetry counts per (window, view)."""
        fp = cluster.fail_probs(delta_t_days)
        token = (float(delta_t_days), id(cluster))
        if token in self._fp_seen:
            self.hits += 1
        else:
            self.misses += 1
            self._bound(self._fp_seen)
            self._fp_seen.add(token)
        return fp

    def frontier(self, sorted_fail_probs: np.ndarray, target: float) -> ParityFrontier:
        """Shared lazily-extended parity frontier for one node sequence."""
        key = (sorted_fail_probs.tobytes(), float(target))
        fr = self._frontiers.get(key)
        if fr is None:
            self.misses += 1
            fr = ParityFrontier(sorted_fail_probs, target)
            self._bound(self._frontiers)
            self._frontiers[key] = fr
        else:
            self.hits += 1
        return fr

    def rna_frontier(
        self, sorted_fail_probs: np.ndarray, target: float, L: int
    ) -> np.ndarray:
        """Shared RNA min-parity frontier row for one sorted node sequence
        (the approximation-regime half of the GreedyMinStorage kernel;
        see :func:`repro_torch.core.greedy_kernel.rna_frontier_row`).  The
        write-bandwidth sort order is insensitive to occupancy, so this
        row survives the commits of a batch and amortizes across the
        per-commit rescoring groups of ``place_many``."""
        key = (np.ascontiguousarray(sorted_fail_probs).tobytes(), float(target), int(L))
        row = self._rna_rows.get(key)
        if row is None:
            self.misses += 1
            row = greedy_kernel.rna_frontier_row(sorted_fail_probs, target, L)
            self._bound(self._rna_rows)
            self._rna_rows[key] = row
        else:
            self.hits += 1
        return row

    def min_parity(self, fail_probs: np.ndarray, target: float) -> int:
        """Min parity for an arbitrary mapping; -1 if infeasible."""
        key = (np.ascontiguousarray(fail_probs).tobytes(), float(target))
        mp = self._min_parity.get(key)
        if mp is None:
            self.misses += 1
            got = min_parity_for_target(fail_probs, target)
            mp = -1 if got is None else int(got)
            self._bound(self._min_parity)
            self._min_parity[key] = mp
        else:
            self.hits += 1
        return mp


@dataclasses.dataclass(frozen=True)
class PlacementRecord:
    """Structured telemetry for one scheduling decision."""

    item_id: int
    placement: Optional[Placement]     # None => rejected
    chunk_mb: float                    # 0.0 when rejected
    candidates_considered: int
    reason: str                        # "" on success
    overhead_s: float                  # scheduler wall time for this item
    committed: bool                    # True iff bytes were committed

    @property
    def ok(self) -> bool:
        return self.placement is not None


class PlacementEngine:
    """Runs one scheduler against one :class:`ClusterView`.

    ``scheduler`` may be a registered name (resolved through the
    registry) or an instance; ``cluster`` may be a view or a node list.
    ``device`` goes to a kernel-backed scheduler resolved by name (``None``
    means CUDA); an instance keeps its own.
    With ``auto_commit=True`` (default) accepted placements are committed
    to the view; the checkpoint plane runs with ``auto_commit=False``
    because its fabric accounts for the bytes as chunks actually land.
    """

    def __init__(
        self,
        cluster: ClusterView | Sequence[StorageNode],
        scheduler,
        *,
        auto_commit: bool = True,
        constraints: Optional[PlacementConstraints] = None,
        device=None,
        **scheduler_kwargs,
    ):
        if isinstance(scheduler, str):
            scheduler = create_scheduler(scheduler, device=device, **scheduler_kwargs)
        elif scheduler_kwargs:
            raise TypeError("scheduler kwargs only apply to name resolution")
        if not isinstance(cluster, ClusterView):
            cluster = ClusterView.from_nodes(list(cluster))
        self.cluster = cluster
        self.scheduler = scheduler
        self.auto_commit = auto_commit
        # Engine-wide failure-domain constraints (normalized: the
        # all-default record means "no constraints" and takes the exact
        # unconstrained code path).  Per-call ``constraints=`` overrides.
        if constraints is not None and constraints.unconstrained:
            constraints = None
        self.constraints = constraints
        self.capabilities = scheduler_capabilities(scheduler)
        # Legacy third-party schedulers may still implement the two-arg
        # ``place(item, cluster)``; detect once and call accordingly.
        try:
            sig = inspect.signature(scheduler.place)
            self._pass_ctx = "ctx" in sig.parameters or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values()
            )
        except (TypeError, ValueError):  # builtins / C callables
            self._pass_ctx = False
        # Commit-delta hook: schedulers maintaining incremental rescoring
        # state (see repro_torch.core.incremental) get every commit replayed;
        # out-of-band mutations are caught by the trackers' own mirror
        # validation, so the hook is an optimization, never a soundness
        # requirement.
        self._observe_commit = getattr(scheduler, "observe_commit", None)
        self._observe_release = getattr(scheduler, "observe_release", None)
        self._observe_churn = getattr(scheduler, "observe_churn", None)
        #: monotonic counter of state mutations made *through the engine*
        #: (commits, repairs, releases, rollbacks); snapshot epochs stamp
        #: it so readers can order views without comparing arrays.
        self.mutation_seq = 0
        self._repair_planner = RepairPlanner(self.cluster)
        self.stats = {
            "n_placed": 0,
            "n_rejected": 0,
            "mb_committed": 0.0,
            "overhead_s": 0.0,
            "n_repairs_planned": 0,
            "n_repairs_failed": 0,
            "repair_mb_committed": 0.0,
            # Constraint post-pass telemetry: chunks swapped to satisfy
            # failure-domain constraints, and decisions rejected because
            # no conforming mapping existed.
            "n_constraint_swaps": 0,
            "n_constraint_rejects": 0,
        }

    # -- placement ----------------------------------------------------------

    def place(
        self,
        item: DataItem,
        *,
        ctx: BatchContext | None = None,
        constraints: Optional[PlacementConstraints] = None,
    ) -> PlacementRecord:
        """Schedule (and, with ``auto_commit``, commit) one item.

        ``constraints`` overrides the engine-wide
        :class:`PlacementConstraints` for this call.  ``topology_aware``
        schedulers receive them directly and build cap-conforming
        mappings by construction; for every other scheduler the swap
        post-pass in :meth:`_finalize` enforces the invariant, so it
        holds registry-wide."""
        c = self._effective_constraints(constraints)
        t0 = time.perf_counter()
        if c is not None and self.capabilities.topology_aware:
            decision = self.scheduler.place(
                item, self.cluster, ctx=ctx, constraints=c
            )
        elif self._pass_ctx:
            decision = self.scheduler.place(item, self.cluster, ctx=ctx)
        else:
            decision = self.scheduler.place(item, self.cluster)
        return self._finalize(
            item, decision, time.perf_counter() - t0, constraints=c, ctx=ctx
        )

    def _effective_constraints(
        self, constraints: Optional[PlacementConstraints]
    ) -> Optional[PlacementConstraints]:
        if constraints is None:
            return self.constraints
        return None if constraints.unconstrained else constraints

    def _finalize(
        self,
        item: DataItem,
        decision,
        overhead: float,
        constraints: Optional[PlacementConstraints] = None,
        ctx: BatchContext | None = None,
    ) -> PlacementRecord:
        """Turn a scheduler decision into a committed record + telemetry."""
        self.stats["overhead_s"] += overhead
        if decision.placement is not None and constraints is not None:
            decision = self._enforce_constraints(item, decision, constraints, ctx)
        if decision.placement is None:
            self.stats["n_rejected"] += 1
            return PlacementRecord(
                item_id=item.item_id,
                placement=None,
                chunk_mb=0.0,
                candidates_considered=decision.candidates_considered,
                reason=decision.reason or "rejected",
                overhead_s=overhead,
                committed=False,
            )
        pl = decision.placement
        chunk = pl.chunk_size_mb(item.size_mb)
        self._validate(pl, chunk, constraints)
        committed = False
        if self.auto_commit:
            self.cluster.commit(pl, chunk)
            self.mutation_seq += 1
            if self._observe_commit is not None:
                self._observe_commit(pl.node_ids, chunk, self.cluster)
            self.stats["mb_committed"] += chunk * pl.n
            committed = True
        self.stats["n_placed"] += 1
        return PlacementRecord(
            item_id=item.item_id,
            placement=pl,
            chunk_mb=chunk,
            candidates_considered=decision.candidates_considered,
            reason="",
            overhead_s=overhead,
            committed=committed,
        )

    def _enforce_constraints(
        self,
        item: DataItem,
        decision,
        constraints: PlacementConstraints,
        ctx: BatchContext | None,
    ):
        """Constraint-repair post-pass (see ``core.constraints``).

        ``topology_aware`` schedulers arrive here already cap-conforming
        (their candidate orders are cap-admitted), so the swap pass only
        ever fires for spread width — and, for non-declaring schedulers,
        for everything.  A mapping that cannot be repaired (no admissible
        swap, or the swapped mapping would miss Eq. 3 at the original
        parity) becomes a rejection rather than a constraint violation.
        A swap invalidates ``Decision.window`` (the score's provenance no
        longer matches the mapping), so rescoring stays sound."""
        pl = decision.placement
        if constraints.satisfied_by(pl.node_ids, self.cluster.rack, self.cluster.zone):
            return decision
        chunk = pl.chunk_size_mb(item.size_mb)
        if ctx is not None:
            fail_probs = ctx.fail_probs(self.cluster, item.delta_t_days)

            def mp(probs: np.ndarray) -> int:
                return ctx.min_parity(probs, item.reliability_target)

        else:
            fail_probs = self.cluster.fail_probs(item.delta_t_days)

            def mp(probs: np.ndarray) -> int:
                got = min_parity_for_target(probs, item.reliability_target)
                return -1 if got is None else int(got)

        repaired = constraints_mod.repair_mapping(
            pl, self.cluster, constraints, chunk,
            min_parity=mp, fail_probs=fail_probs,
        )
        if repaired is None:
            self.stats["n_constraint_rejects"] += 1
            return dataclasses.replace(
                decision,
                placement=None,
                window=None,
                reason="failure-domain constraints unsatisfiable for this item",
            )
        new_pl, swaps = repaired
        if swaps == 0:
            return decision
        self.stats["n_constraint_swaps"] += swaps
        return dataclasses.replace(
            decision, placement=new_pl, window=None
        )

    def place_many(
        self,
        items: Sequence[DataItem],
        *,
        atomic: bool = False,
        ctx: BatchContext | None = None,
        constraints: Optional[PlacementConstraints] = None,
    ) -> list[PlacementRecord]:
        """Place a batch in arrival order under one shared context.

        Decisions are identical to calling :meth:`place` per item, but
        the batch amortizes two ways:

        * the shared :class:`BatchContext` memoizes pure derived
          quantities (failure probabilities, parity frontiers) across
          items, and
        * schedulers declaring the ``batch_scoring`` capability are
          driven through :meth:`Scheduler.place_batch`, which scores many
          queued items against one cluster snapshot in a single
          vectorized call.  A committed placement changes the snapshot,
          so pending decisions are re-scored against the post-commit
          state — except decisions a ``windowed_scoring`` scheduler has
          *proven* independent of the commit (disjoint
          ``Decision.window``, unchanged free-desc order), which are
          exactly what rescoring would return (see
          :meth:`_place_many_batched`).  Batched placement never
          consumes a score the commit could have affected.

        With ``atomic=True`` the whole batch is rolled back if any item
        is rejected (records then carry ``committed=False``).  Traced as
        ``engine.place_many``.
        """
        with telemetry.span("engine.place_many"):
            c = self._effective_constraints(constraints)
            ctx = ctx or BatchContext()
            snap = self.snapshot()
            records: list[PlacementRecord] = []
            batched = self.capabilities.batch_scoring and hasattr(
                self.scheduler, "place_batch"
            )
            try:
                if batched:
                    records = self._place_many_batched(list(items), ctx, c)
                else:
                    for item in items:
                        records.append(self.place(item, ctx=ctx, constraints=c))
            except Exception:
                self.rollback(snap)
                raise
            if atomic and not all(r.ok for r in records):
                self.rollback(snap)
                records = [dataclasses.replace(r, committed=False) for r in records]
            return records

    #: upper bound on items scored per place_batch call: beyond this a
    #: vectorized scorer's per-item working set (e.g. the SC kernel's
    #: pairwise Pareto matrices) dominates memory, and a single commit
    #: would discard the whole group's scores anyway.
    MAX_SCORING_GROUP = 64

    def _place_many_batched(
        self,
        items: list[DataItem],
        ctx: BatchContext,
        constraints: Optional[PlacementConstraints] = None,
    ) -> list[PlacementRecord]:
        """Batch placement via ``Scheduler.place_batch``.

        The scheduler scores a group of items against the current
        cluster snapshot in one vectorized call; decisions are consumed
        in arrival order.  A committed placement mutates the cluster, so
        not-yet-consumed scores are *stale* by default and the remainder
        of the group is re-scored against the post-commit snapshot.

        **Dependency-aware rescoring.**  Schedulers declaring the
        ``windowed_scoring`` capability emit decisions whose scores are
        pure functions of the free-desc node order plus the free space
        of their ``Decision.window`` nodes.  For those, a commit only
        invalidates the pending scores it can actually affect: a pending
        decision survives while (a) its window is disjoint from every
        node committed since the group was scored and (b) the free-desc
        order of live nodes is unchanged — both checked here, so a kept
        score is *provably* equal to what rescoring would return, and a
        score whose window intersects a committed mapping is never
        reused.  Decisions without a window (rejections, conservative
        schedulers) always trigger the rescore.  Pinned by
        ``TestBatchStaleness`` in tests/test_engine.py.

        Group size adapts: commit-heavy workloads without windowed
        scoring degrade to per-item kernel calls (still vectorized over
        candidates), while non-committing engines (``auto_commit=False``,
        the Table-2 protocol) and windowed schedulers with disjoint
        traffic score the whole queue in ~one call.  Results are
        bit-identical to sequential :meth:`place`.
        """
        records: list[PlacementRecord] = []
        i, n = 0, len(items)
        windowed = self.capabilities.windowed_scoring
        if not self.auto_commit or windowed:
            chunk = min(n, self.MAX_SCORING_GROUP)
        else:
            chunk = 1
        while i < n:
            group = items[i : i + chunk]
            order0 = (
                self._free_desc_order()
                if windowed and self.auto_commit and len(group) > 1
                else None
            )
            t0 = time.perf_counter()
            if constraints is not None and self.capabilities.topology_aware:
                decisions = self.scheduler.place_batch(
                    group, self.cluster, ctx=ctx, constraints=constraints
                )
            else:
                decisions = self.scheduler.place_batch(group, self.cluster, ctx=ctx)
            elapsed = time.perf_counter() - t0
            if len(decisions) != len(group):
                raise RuntimeError(
                    f"{self.scheduler.name}.place_batch returned "
                    f"{len(decisions)} decisions for {len(group)} items"
                )
            per_item = elapsed / len(group)
            used = 0
            committed_nodes: set[int] = set()
            order_unchanged = True
            stale = False
            reused = False
            for item, decision in zip(group, decisions):
                if committed_nodes:
                    if not (
                        order_unchanged
                        and decision.window is not None
                        and committed_nodes.isdisjoint(decision.window)
                    ):
                        stale = True
                        break  # this score saw pre-commit state: rescore
                    reused = True
                # place_batch is pure; the scheduler observes the item
                # only as its decision is consumed (matching sequential
                # place, where observation precedes the item's scoring).
                self.scheduler.observe_item(item)
                records.append(
                    self._finalize(
                        item, decision, per_item,
                        constraints=constraints, ctx=ctx,
                    )
                )
                used += 1
                if records[-1].committed:
                    committed_nodes.update(records[-1].placement.node_ids)
                    if order0 is not None and order_unchanged:
                        order_unchanged = np.array_equal(
                            order0, self._free_desc_order()
                        )
                    elif order0 is None:
                        # Conservative schedulers never reuse across a
                        # commit; skip the order bookkeeping entirely.
                        order_unchanged = False
            i += used
            # Per-record overhead is the amortized share of the scoring
            # call; scores discarded by a mid-group commit still cost
            # wall time, so charge the unconsumed share to the aggregate
            # gauge (stats['overhead_s'] tracks real scheduling time).
            self.stats["overhead_s"] += elapsed - used * per_item
            # Grow the scoring group only while scores are being consumed
            # wholesale: a stale break — or a commit no score survived
            # (non-windowed schedulers always; windowed ones whose
            # windows happened to collide) — degrades to per-item calls
            # rather than oscillating and re-wasting scores.
            if stale or (committed_nodes and not reused):
                chunk = 1
            elif used == len(group) and i < n:
                chunk = min(chunk * 2, self.MAX_SCORING_GROUP, n - i)
        return records

    def _free_desc_order(self) -> np.ndarray:
        """Live node ids in free-space-descending order — the sort every
        windowed-scoring scheduler's decisions are relative to.  Served
        from the scheduler's own candidate tracker when it keeps one
        (same maintained array the scheduler sorts by, so the
        reuse-soundness check and the scheduler can never disagree on
        key or tie-breaking — and the per-commit check stops paying an
        argsort); falls back to the from-scratch ``_live_sorted``."""
        tracker = getattr(self.scheduler, "_order_tracker", None)
        if tracker is not None:
            return tracker.order(self.cluster)
        from .algorithms import Scheduler  # deferred: no import cycle

        return Scheduler._live_sorted(self.cluster, self.cluster.free_mb)

    def observe_churn(self, kind: str, node_ids: Sequence[int]) -> None:
        """Notify the scheduler's incremental trackers of a membership
        event (``fail`` / ``heal`` / ``join``) applied to the cluster
        through the owning plane (serve frontier, simulator).  Purely an
        optimization: trackers self-heal via mirror validation if this
        is never called."""
        if self._observe_churn is not None:
            self._observe_churn(kind, node_ids, self.cluster)

    def observe_external_release(
        self, node_ids: Sequence[int], chunk_mb: float
    ) -> None:
        """Notify the trackers of a release applied to the cluster
        directly by the owning plane (e.g. the frontier's drop path).
        Optimization only — trackers self-heal without it."""
        if self._observe_release is not None:
            self._observe_release(node_ids, chunk_mb, self.cluster)

    # -- repair ---------------------------------------------------------------

    def plan_repair(
        self,
        item: DataItem,
        placement: Placement,
        *,
        chunk_mb: float | None = None,
        survivors: Sequence[int] | None = None,
        allow_parity_growth: bool = True,
        require_target: bool = True,
        commit: bool | None = None,
        ctx: BatchContext | None = None,
        constraints: Optional[PlacementConstraints] = None,
    ) -> RepairPlan:
        """Plan (and, with ``commit``, reserve) re-placement of an item's
        lost chunks — the one repair policy in the codebase (§5.7).

        Parity growth happens only when *both* the caller allows it and
        the scheduler's registry entry declares ``supports_parity_growth``
        (capability gating, never name matching).  ``commit`` defaults to
        the engine's ``auto_commit``; committing reserves one chunk on
        each replacement node so concurrent placements see the capacity
        as taken while the repair transfer is in flight.  Use
        :meth:`abort_repair` to return the reservation if the repair is
        voided (e.g. a reconstruction source dies mid-transfer).
        """
        t0 = time.perf_counter()
        grow = bool(allow_parity_growth) and self.capabilities.supports_parity_growth
        plan = self._repair_planner.plan(
            item,
            placement,
            chunk_mb=chunk_mb,
            survivors=survivors,
            allow_parity_growth=grow,
            require_target=require_target,
            ctx=ctx,
            constraints=self._effective_constraints(constraints),
        )
        plan = dataclasses.replace(
            plan, overhead_s=time.perf_counter() - t0
        )
        self.stats["overhead_s"] += plan.overhead_s
        if not plan.ok:
            self.stats["n_repairs_failed"] += 1
            return plan
        self.stats["n_repairs_planned"] += 1
        commit = self.auto_commit if commit is None else commit
        if commit and plan.new_nodes:
            self.cluster.charge(plan.new_nodes, plan.chunk_mb)
            self.mutation_seq += 1
            if self._observe_commit is not None:
                # same array op as a placement commit: replayable
                self._observe_commit(plan.new_nodes, plan.chunk_mb, self.cluster)
            self.stats["repair_mb_committed"] += plan.repair_mb
            plan = dataclasses.replace(plan, committed=True)
        return plan

    def abort_repair(self, plan: RepairPlan) -> None:
        """Release a committed repair's reserved replacement bytes.

        Occupancy is returned only on still-alive replacement nodes —
        fail-stop already zeroed any that died (which is exactly why the
        repair is being aborted) — but the ``repair_mb_committed`` gauge
        drops by the full reservation: after an abort no replacement
        bytes remain reserved anywhere."""
        if plan.committed and plan.new_nodes:
            alive = [n for n in plan.new_nodes if self.cluster.alive[n]]
            if alive:
                self.cluster.release(alive, plan.chunk_mb)
                if self._observe_release is not None:
                    self._observe_release(alive, plan.chunk_mb, self.cluster)
            self.mutation_seq += 1
            self.stats["repair_mb_committed"] -= plan.repair_mb

    # -- commit / rollback ----------------------------------------------------

    def view_snapshot(self) -> ClusterView:
        """Read-only copy-on-write snapshot of the current cluster state.

        This is the mechanism behind the placement frontier's snapshot
        epochs (:mod:`repro_torch.serve.placement.epochs`): readers hold a
        consistent view while placements keep mutating the live one.
        Publishing is O(1) — the snapshot *shares* the live arrays and
        both sides are write-protected; the live view copies a field
        lazily on its next mutation of that field (see
        :meth:`ClusterView.share_snapshot`), so an epoch costs one copy
        per field that actually changes instead of eight O(N) copies per
        window.  Snapshot arrays stay write-protected forever, so a
        reader bug cannot corrupt a published epoch — and a direct
        out-of-band write to the *live* arrays while they are shared
        raises ``ValueError`` instead of silently mutating the epoch."""
        return self.cluster.share_snapshot()

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, dict, Optional[float]]:
        """Capture the mutable engine state (occupancy, liveness, stats,
        and the scheduler's observed min item size)."""
        return (
            self.cluster.used_mb.copy(),
            self.cluster.alive.copy(),
            dict(self.stats),
            getattr(self.scheduler, "smin_mb", None),
        )

    def rollback(self, snapshot: tuple[np.ndarray, np.ndarray, dict, Optional[float]]) -> None:
        """Restore a :meth:`snapshot` exactly (bitwise, not arithmetically).
        A rolled-back batch leaves no trace: telemetry counters and the
        scheduler's ``smin_mb`` observation (which feeds D-Rex SC's
        saturation curve) are restored along with the cluster."""
        used, alive, stats, smin = snapshot
        self.cluster.restore(used, alive)
        self.mutation_seq += 1
        self.stats = dict(stats)
        if hasattr(self.scheduler, "smin_mb"):
            self.scheduler.smin_mb = smin

    def release(self, record: PlacementRecord) -> None:
        """Return one committed placement's bytes to the cluster (and to
        ``stats['mb_committed']``).

        ``stats['mb_committed']`` counts bytes committed *through this
        engine* (net of release/rollback); it is not a live occupancy
        gauge — callers that mutate the view directly (e.g. the
        simulator's failure/drop paths) should read ``cluster.used_mb``
        for current occupancy."""
        if record.committed and record.placement is not None:
            self.cluster.release(record.placement.node_ids, record.chunk_mb)
            if self._observe_release is not None:
                self._observe_release(
                    record.placement.node_ids, record.chunk_mb, self.cluster
                )
            self.mutation_seq += 1
            self.stats["mb_committed"] -= record.chunk_mb * record.placement.n

    # -- internal -------------------------------------------------------------

    def _validate(
        self,
        pl: Placement,
        chunk: float,
        constraints: Optional[PlacementConstraints] = None,
    ) -> None:
        ids = np.asarray(pl.node_ids)
        if not np.all(self.cluster.alive[ids]):
            raise RuntimeError(
                f"{self.scheduler.name} placed on a dead node: {pl.node_ids}"
            )
        # index-then-subtract == free_mb[ids] bitwise, without the O(N)
        # full-array materialize on every commit
        free = self.cluster.capacity_mb[ids] - self.cluster.used_mb[ids]
        if not np.all(free >= chunk - 1e-6):
            raise RuntimeError(
                f"{self.scheduler.name} violated capacity ({chunk:.3f} MB chunk)"
            )
        if constraints is not None and not constraints.satisfied_by(
            pl.node_ids, self.cluster.rack, self.cluster.zone
        ):
            # Post-pass guarantees conformance before commit; reaching
            # here means a scheduler/post-pass bug, not user input.
            raise RuntimeError(
                f"{self.scheduler.name} violated failure-domain constraints: "
                f"{pl.node_ids}"
            )


def batch_stats(records: Sequence[PlacementRecord]) -> dict:
    """Aggregate a batch of records into the summary benchmarks report."""
    ok = [r for r in records if r.ok]
    rejected = [r for r in records if not r.ok]
    reasons: dict[str, int] = {}
    for r in rejected:
        reasons[r.reason] = reasons.get(r.reason, 0) + 1
    return {
        "n_items": len(records),
        "n_placed": len(ok),
        "n_rejected": len(rejected),
        "mb_placed": float(sum(r.chunk_mb * r.placement.n for r in ok)),
        "mb_committed": float(
            sum(r.chunk_mb * r.placement.n for r in ok if r.committed)
        ),
        "overhead_s": float(sum(r.overhead_s for r in records)),
        "overhead_per_item_ms": (
            1e3 * sum(r.overhead_s for r in records) / len(records)
            if records
            else 0.0
        ),
        "reject_reasons": reasons,
    }
