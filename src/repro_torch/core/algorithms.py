"""The four D-Rex schedulers (paper §4) and the SOTA baselines (§5.2).

The JAX package's ``core/algorithms.py``, ported: the scalar oracles,
the dispatch rule and the constants are copied (host numpy float64, so
decisions are the reference's bit for bit); the batch scorers the JAX
package jitted run as float64 torch on the scheduler's device
(:mod:`repro_torch.core.sc_kernel`, ``lb_kernel``, ``greedy_kernel``),
with the parity frontiers of D-Rex SC and the greedy baselines in the
hand-written kernel :mod:`repro_torch.kernels.pb_frontier`.

Every scheduler answers, for one item ``d`` arriving online, the question
of Problem 1: choose ``(K_d, P_d, M_d)`` subject to the reliability
constraint (Eq. 3) and per-node capacity, optimizing storage and I/O.

All schedulers see the cluster through :class:`repro_torch.core.types.ClusterView`
and are purely functional over it (the caller — normally a
:class:`repro_torch.core.engine.PlacementEngine` — commits the placement).
Each algorithm registers itself with :mod:`repro_torch.core.registry`, declaring
its capabilities (adaptive (K,P)?, may grow parity on reschedule?) so the
simulator and checkpoint plane never match on name strings.

The reliability feasibility question every prefix-greedy algorithm asks
("min parity for the first n nodes of my sorted order?") is answered by
one shared :class:`repro_torch.core.reliability.ParityFrontier` DP; under
batched placement (``PlacementEngine.place_many``) the optional ``ctx``
argument memoizes frontiers across items so the DP cost amortizes.

**Devices.**  The kernel-backed schedulers (D-Rex SC, D-Rex LB and the
two greedy baselines) take ``device=``: ``None`` means CUDA, and CUDA
without a card raises.  The only reason they decide through the numpy
oracle instead of the device scorer is the reference's node-count rule
(:func:`_kernel_dispatch`) or ``use_kernel = False``; a device scorer
that fails to build or launch raises, it never falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from repro_torch._device import resolve_device

from . import constraints as constraints_mod
from . import greedy_kernel, lb_kernel, prefilter, sc_kernel
from .incremental import FreeOrderTracker, SaturationTracker
from .registry import (
    get_spec,
    register_scheduler,
    register_scheduler_family,
    SchedulerCapabilities,
)
from .reliability import _AUTO_EXACT_LIMIT, min_parity_for_target, ParityFrontier
from .types import (
    ClusterView,
    DataItem,
    Decision,
    ECTimeModel,
    Placement,
    PlacementConstraints,
)

__all__ = [
    "Scheduler",
    "GreedyMinStorage",
    "GreedyLeastUsed",
    "DRexLB",
    "DRexSC",
    "StaticEC",
    "DAOSAdaptive",
    "RandomSpread",
    "SCHEDULER_NAMES",
    "saturation_score",
]


class Scheduler:
    """Base interface. ``place`` must not mutate ``cluster``.

    ``ctx`` is an optional :class:`repro_torch.core.engine.BatchContext`; when
    provided, pure derived quantities (failure probabilities per
    retention window, parity frontiers per sorted node sequence) are
    memoized across the items of a batch.  Results are bit-identical with
    and without a context — the cache keys on the exact inputs of each
    computation.
    """

    name: str = "base"
    #: capability record; overwritten by the registry decorator.
    capabilities: SchedulerCapabilities = SchedulerCapabilities()
    #: smallest item size seen so far (MB); None until the first item is
    #: observed.  Seeded from the first item rather than a fixed 1 MB
    #: prior: traces whose smallest item exceeds 1 MB would otherwise
    #: never move the anchor, skewing the SC saturation curve's
    #: (s_min, 1/L) endpoint (§4.4).
    smin_mb: Optional[float] = None

    def place(
        self, item: DataItem, cluster: ClusterView, ctx=None
    ) -> Decision:
        raise NotImplementedError

    def observe_item(self, item: DataItem) -> None:
        """Track the smallest item size (used by the SC saturation curve)."""
        if item.size_mb > 0:
            smin = self.smin_mb
            self.smin_mb = (
                item.size_mb if smin is None else min(smin, item.size_mb)
            )

    # -- shared helpers -----------------------------------------------------

    @staticmethod
    def _live_sorted(cluster: ClusterView, key: np.ndarray, descending=True):
        """Live node ids sorted by ``key`` (stable, deterministic)."""
        ids = cluster.live_ids()
        order = np.argsort(-key[ids] if descending else key[ids], kind="stable")
        return ids[order]

    @staticmethod
    def _apply_constraints(
        order: np.ndarray,
        cluster: ClusterView,
        constraints: Optional[PlacementConstraints],
    ) -> np.ndarray:
        """Cap-admitted subsequence of a sorted candidate order (see
        ``core.constraints.constrained_order``).  Identity — same array
        object — when no constraints are given, so the unconstrained
        path stays bit-identical.  ``topology_aware`` schedulers call
        this on their own order before any slicing: every mapping they
        emit is then a subset of a cap-conforming set, so the per-domain
        caps hold by construction and only spread width is left to the
        engine's swap post-pass."""
        if constraints is None or constraints.unconstrained:
            return order
        return constraints_mod.constrained_order(
            order, cluster.rack, cluster.zone, constraints
        )

    @staticmethod
    def _fits(cluster: ClusterView, node_ids, chunk_mb: float) -> bool:
        free = cluster.free_mb[np.asarray(node_ids)]
        return bool(np.all(free >= chunk_mb))

    @staticmethod
    def _fail_probs(cluster: ClusterView, item: DataItem, ctx) -> np.ndarray:
        if ctx is not None:
            return ctx.fail_probs(cluster, item.delta_t_days)
        return cluster.fail_probs(item.delta_t_days)

    @staticmethod
    def _frontier(probs: np.ndarray, target: float, ctx) -> ParityFrontier:
        if ctx is not None:
            return ctx.frontier(probs, target)
        return ParityFrontier(probs, target)

    @staticmethod
    def _min_parity(probs: np.ndarray, target: float, ctx) -> int:
        """Min parity for an arbitrary (non-prefix) mapping; -1 infeasible."""
        if ctx is not None:
            return ctx.min_parity(probs, target)
        mp = min_parity_for_target(probs, target)
        return -1 if mp is None else mp


def _kernel_dispatch(scheduler, cluster: ClusterView, batch: int) -> bool:
    """The one kernel/scalar dispatch rule for kernel-backed schedulers,
    the reference's with its constants: a single item needs at least
    ``KERNEL_MIN_NODES`` live nodes for the device scorer; batches of
    >= 4 items need only ``KERNEL_MIN_NODES_BATCH`` (0 for most
    schedulers — GreedyLeastUsed's scalar scan is so cheap its scorer
    only wins batched on large clusters).  Setting both to 0 forces the
    device scorer everywhere (the equivalence tests do).  There is no
    availability gate: a scorer that cannot run raises."""
    if not scheduler.use_kernel:
        return False
    live = int(np.count_nonzero(cluster.alive))
    if batch >= 4:
        return live >= scheduler.KERNEL_MIN_NODES_BATCH
    return live >= scheduler.KERNEL_MIN_NODES


class _KernelSchedulerMixin:
    """Kernel/scalar dispatch shared by the kernel-backed prefix
    schedulers (the greedys on :mod:`repro_torch.core.greedy_kernel`,
    D-Rex LB on :mod:`repro_torch.core.lb_kernel`).  Concrete classes
    provide the scalar oracle (``_place_scalar``), the batched device
    path (``_place_kernel``) and the ``KERNEL_MIN_NODES`` crossover."""

    #: set to False to force the scalar numpy oracle.
    use_kernel = True
    #: live-node crossover for batched (>= 4 item) dispatch; 0 = batches
    #: always use the device scorer (see :func:`_kernel_dispatch`).
    KERNEL_MIN_NODES_BATCH = 0

    def __init__(self, device=None):
        #: where the batch scorer runs (``None`` means CUDA).
        self.device = resolve_device(device)

    def _kernel_wins(self, cluster: ClusterView, batch: int) -> bool:
        return _kernel_dispatch(self, cluster, batch)

    def place(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        self.observe_item(item)
        if self._kernel_wins(cluster, 1):
            return self._place_kernel([item], cluster, ctx, constraints)[0]
        return self._place_scalar(item, cluster, ctx, constraints)

    def place_batch(
        self,
        items: Sequence[DataItem],
        cluster: ClusterView,
        ctx=None,
        constraints=None,
    ) -> list[Decision]:
        """Score ``items`` against the *current* cluster snapshot in one
        batched device call (pure; consumed by the engine's batched
        ``place_many``, which re-scores items invalidated by a commit).
        ``constraints`` (a :class:`PlacementConstraints`) restricts the
        candidate order to the cap-admitted subsequence — only the
        engine passes it, and only to ``topology_aware`` schedulers."""
        if self._kernel_wins(cluster, len(items)):
            return self._place_kernel(list(items), cluster, ctx, constraints)
        return [self._place_scalar(it, cluster, ctx, constraints) for it in items]

    def place_scalar(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        """Reference numpy oracle (kept for equivalence tests)."""
        self.observe_item(item)
        return self._place_scalar(item, cluster, ctx, constraints)


# ---------------------------------------------------------------------------
# §4.1 GreedyMinStorage
# ---------------------------------------------------------------------------


@register_scheduler(
    "greedy_min_storage",
    adaptive=True,
    supports_parity_growth=True,
    batch_scoring=True,
    topology_aware=True,
)
class GreedyMinStorage(_KernelSchedulerMixin, Scheduler):
    """Minimize per-item storage footprint ``(size/K) * N`` s.t. reliability
    (Eq. 4); mapping favors the fastest (write-bandwidth) nodes *among
    those with room for the chunk* — once the fast nodes saturate the
    selection slides to slower ones instead of failing (the paper's §5.4
    observation that GreedyMinStorage keeps utilizing all nodes).

    Two implementations of the same decision function: the scalar numpy
    oracle (:meth:`place_scalar` — the Python fixed-point loop over K per
    candidate N) and the device scorer
    (:mod:`repro_torch.core.greedy_kernel`), which evaluates the fixed
    point in closed form for every N at once wherever the bw-sorted
    prefix fits the chunk, finishing capacity-tight rows with the same
    :meth:`_fixed_point_row` the oracle runs.  ``place`` uses the device
    scorer when the cluster clears ``KERNEL_MIN_NODES`` (batches of >= 4
    items always do); ``place_batch`` scores many items sharing a
    snapshot in one call.  Decisions are bit-for-bit the oracle's.
    """

    name = "greedy_min_storage"
    #: below this many live nodes a single item takes the scalar oracle;
    #: batches of >= 4 items use the device scorer regardless (the JAX
    #: package's crossover, kept; the H100's is measured in PERF.md).
    #: Set to 0 to force the device scorer (tests do).
    KERNEL_MIN_NODES = 24

    def _fixed_point_row(
        self, n, by_bw, free, fail_all, size, target, ctx
    ) -> Optional[Placement]:
        # Fixed point over K for one N: the chunk size determines which
        # nodes qualify (free >= chunk), which determines the mapping,
        # which determines the min parity, which determines K. K only
        # ever decreases, so this terminates in <= N steps (typically
        # 1-2).  Shared verbatim by the scalar oracle's N-loop and the
        # kernel's slow-row fallback.
        k = n - 1
        while k >= 1:
            chunk = size / k
            fitting = by_bw[free[by_bw] >= chunk]
            if len(fitting) < n:
                return None
            mapping = fitting[:n]
            mp = self._min_parity(fail_all[mapping], target, ctx)
            if mp < 0:
                return None
            p_star = max(1, mp)  # the repository always keeps parity
            k_new = n - p_star
            if k_new < 1:
                return None
            if k_new >= k:
                return Placement(
                    k=k, p=n - k, node_ids=tuple(int(x) for x in mapping)
                )
            k = k_new
        return None

    # -- scalar oracle ------------------------------------------------------

    def _place_scalar(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        by_bw = self._apply_constraints(
            self._live_sorted(cluster, cluster.write_bw), cluster, constraints
        )
        L = len(by_bw)
        if L < 2:
            return Decision(None, 0, "fewer than 2 live nodes")
        fail_all = self._fail_probs(cluster, item, ctx)
        free = cluster.free_mb

        best: Optional[Placement] = None
        best_cost = math.inf
        considered = 0
        for n in range(2, L + 1):
            considered += 1
            placement = self._fixed_point_row(
                n, by_bw, free, fail_all, item.size_mb,
                item.reliability_target, ctx,
            )
            if placement is None:
                continue
            cost = (item.size_mb / placement.k) * n
            if cost < best_cost:
                best_cost = cost
                best = placement
        if best is None:
            return Decision(None, considered, "no (N,K) satisfies reliability+capacity")
        return Decision(best, considered, "")

    # -- vectorized path ----------------------------------------------------

    def _place_kernel(
        self, items: list[DataItem], cluster: ClusterView, ctx, constraints=None
    ) -> list[Decision]:
        by_bw = self._apply_constraints(
            self._live_sorted(cluster, cluster.write_bw), cluster, constraints
        )
        L = len(by_bw)
        if L < 2:
            return [Decision(None, 0, "fewer than 2 live nodes") for _ in items]
        # No top-M pre-filter: the (size/K)*N objective keeps improving as
        # N grows (K grows with N), so a bw-sorted prefix slice can change
        # the argmin — MinStorage always scores the full grid (counted so
        # the scale lane's hit-rate columns show the bypass).
        prefilter.record(self.name, "bypassed", len(items))
        free = cluster.free_mb
        free_bw = free[by_bw]
        B = len(items)
        fail_rows: list[np.ndarray] = []
        probs_mat = np.empty((B, L), dtype=np.float64)
        for row, item in enumerate(items):
            fa = self._fail_probs(cluster, item, ctx)
            fail_rows.append(fa)
            probs_mat[row] = fa[by_bw]
        # Host-side RNA frontier rows for mappings beyond the exact-DP
        # limit (the oracle's min_parity auto-method switch); items
        # sharing (fail probs, target) pay for a row once per batch.
        rna_rows = np.full((B, L + 1), -1, dtype=np.int64)
        if L > _AUTO_EXACT_LIMIT:
            memo: dict[tuple[bytes, float], np.ndarray] = {}
            for row, item in enumerate(items):
                if ctx is not None:
                    rna_rows[row] = ctx.rna_frontier(
                        probs_mat[row], item.reliability_target, L
                    )
                    continue
                key = (probs_mat[row].tobytes(), item.reliability_target)
                got = memo.get(key)
                if got is None:
                    got = greedy_kernel.rna_frontier_row(
                        probs_mat[row], item.reliability_target, L
                    )
                    memo[key] = got
                rna_rows[row] = got
        valid, slow, ks, ps, cost = greedy_kernel.min_storage_batch(
            probs_mat,
            np.array([it.size_mb for it in items], dtype=np.float64),
            np.array([it.reliability_target for it in items], dtype=np.float64),
            rna_rows,
            free_bw,
            device=self.device,
        )
        decisions = []
        considered = L - 1  # the N-loop always runs 2..L
        for row, item in enumerate(items):
            c = cost[row]
            slow_pl: dict[int, Placement] = {}
            if slow[row].any():
                # Capacity filter engaged: finish these N with the same
                # fixed point the scalar oracle runs, then merge.
                c = c.copy()
                for i in np.nonzero(slow[row])[0]:
                    n = int(i) + 1
                    pl = self._fixed_point_row(
                        n, by_bw, free, fail_rows[row], item.size_mb,
                        item.reliability_target, ctx,
                    )
                    if pl is not None:
                        slow_pl[n] = pl
                        c[i] = (item.size_mb / pl.k) * n
            best_i = int(np.argmin(c))
            if not np.isfinite(c[best_i]):
                decisions.append(
                    Decision(
                        None, considered, "no (N,K) satisfies reliability+capacity"
                    )
                )
                continue
            n = best_i + 1
            if n in slow_pl:
                decisions.append(Decision(slow_pl[n], considered, ""))
            else:
                decisions.append(
                    Decision(
                        Placement(
                            k=int(ks[row, best_i]),
                            p=int(ps[row, best_i]),
                            node_ids=tuple(int(x) for x in by_bw[:n]),
                        ),
                        considered,
                        "",
                    )
                )
        return decisions


# ---------------------------------------------------------------------------
# §4.2 GreedyLeastUsed
# ---------------------------------------------------------------------------


@register_scheduler(
    "greedy_least_used",
    adaptive=True,
    supports_parity_growth=True,
    batch_scoring=True,
    windowed_scoring=True,
    topology_aware=True,
)
class GreedyLeastUsed(_KernelSchedulerMixin, Scheduler):
    """Minimize ``K+P`` s.t. reliability (Eq. 5); nodes with the highest
    free space get the chunks (then minimal parity among feasible).
    ``K >= 2`` as in Alg. 1 — the paper's erasure-coding schedulers do not
    degenerate to replication (only DAOS's explicit replication configs do).

    The scalar numpy oracle (:meth:`place_scalar`) scans N upward with a
    lazily-extended :class:`ParityFrontier`; the device scorer
    (:mod:`repro_torch.core.greedy_kernel`) evaluates the whole
    first-feasible-N scan as one masked DP, batched across items in
    :meth:`place_batch`.

    Declares ``windowed_scoring``: a successful decision is a pure
    function of the free-desc order, the item, the failure probabilities
    and the free space of the *scanned prefix* — which is exactly the
    chosen mapping, since every probed N < N_chosen maps a sub-prefix of
    it.  Decisions therefore carry ``window = node_ids``, and the
    engine's dependency-aware rescoring may keep them across a commit
    that neither touches the window nor perturbs the free-desc order
    (see ``PlacementEngine._place_many_batched``).  Rejections scanned
    every live node and carry no window (always re-scored).
    """

    name = "greedy_least_used"
    #: the scalar scan stops at the first feasible N (typically < 10), so
    #: the JAX package keeps single items on the oracle below this many
    #: live nodes; kept as the reference's dispatch boundary (set it to 0
    #: to force the device scorer everywhere).
    KERNEL_MIN_NODES = 4096
    #: the reference's crossover for batched calls, kept (the H100's is
    #: measured in PERF.md, not applied).
    KERNEL_MIN_NODES_BATCH = 192
    #: prefix length the kernel scans: the first feasible N within the
    #: cap is globally first-feasible, and items with none fall back to
    #: the scalar oracle (bit-identical, just recomputed) — keeping the
    #: batched DP O(batch * SCAN_CAP^2) instead of O(batch * L^2).
    SCAN_CAP = 32

    def __init__(self, device=None):
        super().__init__(device)
        #: incremental free-desc order across commit deltas (see
        #: core/candidates); None forces the from-scratch argsort.
        self._order_tracker: Optional[FreeOrderTracker] = FreeOrderTracker()

    def observe_commit(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Engine commit hook (see ``PlacementEngine._finalize``)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_commit(node_ids, chunk_mb, cluster)

    def observe_release(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Engine release hook (release / abort_repair)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_release(node_ids, chunk_mb, cluster)

    def observe_churn(self, kind: str, node_ids, cluster: ClusterView) -> None:
        """Membership-churn hook (fail / heal / join)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_churn(kind, node_ids, cluster)

    def _by_free(self, cluster: ClusterView) -> np.ndarray:
        if self._order_tracker is None:
            return self._live_sorted(cluster, cluster.free_mb)
        return self._order_tracker.order(cluster)

    def _place_scalar(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        by_free = self._apply_constraints(
            self._by_free(cluster), cluster, constraints
        )
        L = len(by_free)
        if L < 2:
            return Decision(None, 0, "fewer than 2 live nodes")
        fail_all = self._fail_probs(cluster, item, ctx)
        frontier = self._frontier(
            fail_all[by_free], item.reliability_target, ctx
        )

        considered = 0
        for n in range(2, L + 1):
            considered += 1
            mp = frontier.min_parity(n)
            if mp < 0:
                continue
            p_star = max(1, mp)  # the repository always keeps parity
            k = n - p_star
            if k < 2:
                continue
            chunk = item.size_mb / k
            mapping = by_free[:n]
            if not self._fits(cluster, mapping, chunk):
                continue
            ids = tuple(int(x) for x in mapping)
            return Decision(
                Placement(k=k, p=p_star, node_ids=ids),
                considered,
                "",
                window=ids,
            )
        return Decision(None, considered, "no N satisfies reliability+capacity")

    def _place_kernel(
        self, items: list[DataItem], cluster: ClusterView, ctx, constraints=None
    ) -> list[Decision]:
        by_free = self._apply_constraints(
            self._by_free(cluster), cluster, constraints
        )
        L = len(by_free)
        if L < 2:
            return [Decision(None, 0, "fewer than 2 live nodes") for _ in items]
        # The first-feasible-N rule makes SCAN_CAP a lossless top-M
        # pre-filter (see core/prefilter): any N found within the prefix
        # is the global answer, so kernel inputs are materialized over the
        # cap slice only — decision cost scales with the cap, not L.
        # Under constraints the slice keeps per-domain representatives
        # (prefilter.domain_slice) so a spread width cannot be starved by
        # the cap; it stays a free-descending subsequence, so the
        # first-feasible scan and capacity logic are unchanged.
        cap = min(L, self.SCAN_CAP)
        if constraints is not None and not constraints.unconstrained:
            by_free_c = prefilter.domain_slice(
                by_free, cluster.rack, cluster.zone, cap, constraints, self.name
            )
            cap = len(by_free_c)
        else:
            by_free_c = by_free[:cap]
        if cap < L:
            prefilter.record(self.name, "engaged", len(items))
        probs_mat = np.empty((len(items), cap), dtype=np.float64)
        for row, item in enumerate(items):
            probs_mat[row] = self._fail_probs(cluster, item, ctx)[by_free_c]
        ok, ns, ks, ps = greedy_kernel.least_used_batch(
            probs_mat,
            np.array([it.size_mb for it in items], dtype=np.float64),
            np.array([it.reliability_target for it in items], dtype=np.float64),
            # free space of the cap slice only: index-then-subtract is
            # bitwise free_mb[by_free_c] without the O(N) materialize
            cluster.capacity_mb[by_free_c] - cluster.used_mb[by_free_c],
            device=self.device,
        )
        decisions = []
        for row, item in enumerate(items):
            if not ok[row]:
                if cap < L:
                    # No feasible N within the scanned prefix: finish with
                    # the scalar oracle (rare; bit-identical decision).
                    prefilter.record(self.name, "fallback")
                    decisions.append(
                        self._place_scalar(item, cluster, ctx, constraints)
                    )
                else:
                    decisions.append(
                        Decision(None, L - 1, "no N satisfies reliability+capacity")
                    )
                continue
            n = int(ns[row])
            ids = tuple(int(x) for x in by_free_c[:n])
            decisions.append(
                Decision(
                    Placement(k=int(ks[row]), p=int(ps[row]), node_ids=ids),
                    n - 1,  # the scalar scan increments considered per N
                    "",
                    window=ids,
                )
            )
        if cap < L:
            prefilter.record(self.name, "accepted", int(np.count_nonzero(ok)))
        return decisions


# ---------------------------------------------------------------------------
# §4.3 D-Rex LB (Algorithm 1)
# ---------------------------------------------------------------------------


@register_scheduler(
    "drex_lb",
    adaptive=True,
    supports_parity_growth=True,
    batch_scoring=True,
    topology_aware=True,
)
class DRexLB(_KernelSchedulerMixin, Scheduler):
    """Balance-penalty minimization; smallest feasible parity (Alg. 1).

    Two implementations of the same decision function: the scalar numpy
    oracle (:meth:`place_scalar` — the per-P scan below, penalties
    vectorized over K) and the device scorer
    (:mod:`repro_torch.core.lb_kernel`), which evaluates the full (K, P)
    grid in one shot for every item of :meth:`place_batch`.

    **Exactness policy** (see the lb_kernel module docstring): the
    balance penalty's in-mapping sum is accumulated in plain
    left-to-right prefix-sum order on both paths (``np.cumsum`` here, an
    explicit loop carry on the device), and every other
    order-sensitive quantity — ``f_avg``, the out-of-mapping suffix
    sums, and the :class:`ParityFrontier` rows themselves — is a
    host-computed numpy value the kernel consumes as an input, so kernel
    decisions are bit-for-bit equal to this oracle with no fallback
    regimes.

    No ``windowed_scoring``: every score depends on ``f_avg`` — the mean
    free space over *all* live nodes — so any commit anywhere shifts
    every pending penalty and batched scores can never outlive a commit
    (the engine's dependency-aware rescoring correctly invalidates them).

    **Incremental rescoring under commit-heavy load**: the exactness
    policy pins ``f_avg`` to numpy's pairwise mean over the free-desc
    order, so the mean itself must be re-reduced after every commit —
    but the *order* usually survives (a commit moves a few nodes down a
    little), and with the order the O(L log L) argsort, the frontier
    cache keys and the DP reuse all survive too.  A
    :class:`~repro_torch.core.incremental.FreeOrderTracker` fed by the
    engine's ``observe_commit`` hook keeps the order across commit
    deltas with an O(p) adjacency check, leaving ``f_avg``/dev/suffix as
    O(L) re-reductions over the same element order (bitwise identical to
    the from-scratch path).
    """

    name = "drex_lb"
    #: below this many live nodes a single item takes the (vectorized-
    #: numpy) scalar oracle; batches of >= 4 items use the device scorer
    #: regardless.  The JAX package's crossover, kept (the H100's is
    #: measured in PERF.md, not applied).  Set to 0 to force the device
    #: scorer (tests do).
    KERNEL_MIN_NODES = 256
    #: top-M candidate pre-filter (core/prefilter): above this many live
    #: nodes the (K, P) grid runs over the freest-PREFILTER_CAP prefix
    #: with a per-row exactness test and unfiltered fallback.  A shapes
    #: rung so filtered pads land on shared buckets; False disables.
    use_prefilter = True
    PREFILTER_CAP = prefilter.lb_cap()

    def __init__(self, device=None):
        super().__init__(device)
        #: incremental free-desc order across commit deltas; set to None
        #: to force the from-scratch argsort (the exactness tests compare
        #: both).
        self._order_tracker: Optional[FreeOrderTracker] = FreeOrderTracker()

    def observe_commit(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Engine commit hook (see ``PlacementEngine._finalize``)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_commit(node_ids, chunk_mb, cluster)

    def observe_release(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Engine release hook (release / abort_repair)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_release(node_ids, chunk_mb, cluster)

    def observe_churn(self, kind: str, node_ids, cluster: ClusterView) -> None:
        """Membership-churn hook (fail / heal / join)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_churn(kind, node_ids, cluster)

    def _by_free(self, cluster: ClusterView) -> np.ndarray:
        if self._order_tracker is None:
            return self._live_sorted(cluster, cluster.free_mb)
        return self._order_tracker.order(cluster)

    @staticmethod
    def _considered(L: int, p_found: int | None) -> int:
        """Candidates the scalar per-(P, K) loop enumerates: for each
        probed P it scans K = 2..L-P (``L - 1 - p`` candidates), stopping
        after the first feasible P (or exhausting P = 1..L-1)."""
        p_last = L - 1 if p_found is None else p_found
        return p_last * (L - 1) - p_last * (p_last + 1) // 2

    # -- scalar oracle ------------------------------------------------------

    def _place_scalar(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        by_free = self._apply_constraints(
            self._by_free(cluster), cluster, constraints
        )
        L = len(by_free)
        if L < 3:  # Alg. 1 needs K>=2 and P>=1
            return Decision(None, 0, "fewer than 3 live nodes")
        fail_all = self._fail_probs(cluster, item, ctx)
        free_sorted = cluster.free_mb[by_free]
        f_avg = float(free_sorted.mean())  # line 1
        # |F(S_j) - F_avg| for every node once; penalties for out-of-mapping
        # nodes are suffix sums over the sorted order (mapping is a prefix).
        dev = np.abs(free_sorted - f_avg)
        suffix = np.concatenate([np.cumsum(dev[::-1])[::-1], [0.0]])
        # One frontier answers the (prefix, parity) feasibility question for
        # every (K, P) pair: CDF_n(p) >= RT  <=>  min_parity(n) <= p.
        frontier = self._frontier(
            fail_all[by_free], item.reliability_target, ctx
        )
        mp_all = frontier.upto(L)

        # lines 10-15 for every K at once: the in-mapping penalty of the
        # (K, P) pair is the length-(K+P) prefix sum of the chunk-adjusted
        # deviations, accumulated left-to-right (np.cumsum — the fixed
        # summation order the kernel reproduces; see class docstring).
        ks = np.arange(2, L)                       # K = 2..L-1
        chunk_k = item.size_mb / ks.astype(np.float64)
        pen = np.cumsum(
            np.abs(free_sorted[None, :] - chunk_k[:, None] - f_avg), axis=1
        )

        for p in range(1, L):  # line 5
            k_arr = ks[: L - p - 1]                # K = 2..L-P
            if k_arr.size == 0:
                continue
            n_arr = k_arr + p
            mp = mp_all[n_arr - 1]
            feas = (
                (mp >= 0)
                & (mp <= p)
                & (free_sorted[n_arr - 1] >= chunk_k[: k_arr.size])
            )
            if not np.any(feas):
                continue
            # line 22: stop at the smallest feasible P; best (strictly
            # smallest penalty, earliest K on ties) K within it.
            bp = np.where(
                feas, pen[np.arange(k_arr.size), n_arr - 1] + suffix[n_arr],
                np.inf,
            )
            k = int(k_arr[int(np.argmin(bp))])
            n = k + p
            return Decision(
                Placement(
                    k=k, p=p, node_ids=tuple(int(x) for x in by_free[:n])
                ),
                self._considered(L, p),
                "",
            )
        return Decision(
            None, self._considered(L, None),
            "no (K,P) satisfies reliability+capacity",
        )

    # -- vectorized path ----------------------------------------------------

    def _place_kernel(
        self, items: list[DataItem], cluster: ClusterView, ctx, constraints=None
    ) -> list[Decision]:
        by_free = self._apply_constraints(
            self._by_free(cluster), cluster, constraints
        )
        L = len(by_free)
        if L < 3:
            return [Decision(None, 0, "fewer than 3 live nodes") for _ in items]
        cap = self.PREFILTER_CAP if self.use_prefilter else 0
        if constraints is not None and 3 <= cap < L:
            # LB's filtered grid consumes parity-frontier *prefix* rows,
            # so the slice must stay a plain prefix (no representative
            # promotion).  When the top-cap prefix of the admitted order
            # cannot span the required width, run the grid unfiltered
            # instead of starving the spread constraint.
            sl = by_free[:cap]
            if (
                np.unique(cluster.rack[sl]).shape[0]
                < min(constraints.min_racks, cap)
                or np.unique(cluster.zone[sl]).shape[0]
                < min(constraints.min_zones, cap)
            ):
                prefilter.record(self.name, "fallback", len(items))
                cap = 0
        if cap < 3 or cap >= L:  # lb_batch needs K>=2, P>=1 => m >= 3
            return self._kernel_decisions(items, cluster, ctx, by_free, L, {})
        # Top-M pre-filter (core/prefilter): run the (K, P) grid over the
        # freest-M prefix; a row's answer is provably the full-grid answer
        # iff the min parity of the whole M-prefix exceeds the P it found
        # (frontier monotonicity makes every wider window infeasible at
        # that P).  Rows failing the test re-run unfiltered — the lazily
        # extended ParityFrontier makes that an incremental DP, not a
        # restart.
        prefilter.record(self.name, "engaged", len(items))
        memo: dict[tuple[bytes, float], ParityFrontier] = {}
        decisions = self._kernel_decisions(items, cluster, ctx, by_free, cap, memo)
        fb = [i for i, d in enumerate(decisions) if d is None]
        prefilter.record(self.name, "accepted", len(items) - len(fb))
        if fb:
            prefilter.record(self.name, "fallback", len(fb))
            full = self._kernel_decisions(
                [items[i] for i in fb], cluster, ctx, by_free, L, memo
            )
            for j, i in enumerate(fb):
                decisions[i] = full[j]
        return decisions

    def _kernel_decisions(
        self,
        items: list[DataItem],
        cluster: ClusterView,
        ctx,
        by_free: np.ndarray,
        m: int,
        memo: dict,
    ) -> list[Optional[Decision]]:
        """Grid-evaluate ``items`` over the freest-``m`` prefix of
        ``by_free``.  When ``m < L`` (pre-filtered call) a row whose
        sufficiency test fails yields ``None`` — the caller re-runs it
        with ``m = L``."""
        L = len(by_free)
        filtered = m < L
        free_sorted = cluster.free_mb[by_free]
        # Order-sensitive global terms, host-computed exactly as the
        # scalar oracle computes them (numpy pairwise mean / reversed
        # cumsum); the device scorer consumes them as inputs.  f_avg and the
        # suffix sums are cluster-global (all L nodes) even on the
        # pre-filtered path — only the scanned grid shrinks to m.
        f_avg = float(free_sorted.mean())
        dev = np.abs(free_sorted - f_avg)
        suffix = np.concatenate([np.cumsum(dev[::-1])[::-1], [0.0]])
        # Host parity-frontier rows — the very DP the oracle consults
        # (equivalence by construction; see the lb_kernel docstring).
        # Items sharing (fail probs, target) pay for one frontier per
        # batch; the BatchContext extends that across commit groups.
        mp_rows = np.empty((len(items), m), dtype=np.int64)
        for row, item in enumerate(items):
            probs = self._fail_probs(cluster, item, ctx)[by_free]
            if ctx is not None:
                fr = ctx.frontier(probs, item.reliability_target)
            else:
                key = (probs.tobytes(), item.reliability_target)
                fr = memo.get(key)
                if fr is None:
                    fr = ParityFrontier(probs, item.reliability_target)
                    memo[key] = fr
            mp_rows[row] = fr.upto(m)[:m]
        ok, ks, ps = lb_kernel.lb_batch(
            mp_rows,
            np.array([it.size_mb for it in items], dtype=np.float64),
            free_sorted[:m],
            f_avg,
            suffix[: m + 1],
            device=self.device,
        )
        decisions: list[Optional[Decision]] = []
        for row in range(len(items)):
            if not ok[row]:
                if filtered:
                    # A wider-than-m window might still be feasible.
                    decisions.append(None)
                    continue
                decisions.append(
                    Decision(
                        None, self._considered(L, None),
                        "no (K,P) satisfies reliability+capacity",
                    )
                )
                continue
            k, p = int(ks[row]), int(ps[row])
            if filtered:
                # Sufficiency test: min parity of the full m-prefix (-1
                # sentinel => > m-1, i.e. at least m) must strictly exceed
                # the found P, else a wider window could be feasible at a
                # P <= found (same P, lower penalty) and the slice is not
                # provably exact.
                mp_m = int(mp_rows[row, m - 1])
                if (m if mp_m < 0 else mp_m) <= p:
                    decisions.append(None)
                    continue
            decisions.append(
                Decision(
                    Placement(
                        k=k, p=p,
                        node_ids=tuple(int(x) for x in by_free[: k + p]),
                    ),
                    self._considered(L, p),
                    "",
                )
            )
        return decisions


# ---------------------------------------------------------------------------
# §4.4 D-Rex SC (Algorithm 2)
# ---------------------------------------------------------------------------


def saturation_score(projected_used_mb, capacity_mb, smin_mb, n_nodes: int = 10):
    """Exponential saturation score (paper Fig. 3 / Alg. 2 line 11).

    The curve is the exponential through the two anchors the paper's
    formula names: ``(smallest known data item size, 1/L)`` and
    ``(total storage capacity, 1)``, evaluated at the projected *used*
    bytes ``x``:

        f(x) = (1/L) * exp( ln(L) * (x - s_min) / (cap - s_min) )

    i.e. an empty node scores ~1/L and a full node scores 1, rising
    exponentially as the node approaches its limit ("penalize nodes
    approaching their limit", §4.4). Elementwise on numpy arrays; clipped
    to [0, 1].
    """
    cap = np.asarray(capacity_mb, dtype=np.float64)
    x = np.asarray(projected_used_mb, dtype=np.float64)
    span = np.maximum(cap - smin_mb, 1e-9)
    u = np.clip((x - smin_mb) / span, 0.0, 1.0)
    inv_l = 1.0 / max(2, n_nodes)
    return np.clip(inv_l * np.exp(math.log(max(2, n_nodes)) * u), 0.0, 1.0)


@register_scheduler(
    "drex_sc",
    adaptive=True,
    supports_parity_growth=True,
    batch_scoring=True,
    topology_aware=True,
)
class DRexSC(Scheduler):
    """System-capacity-aware scheduler (Alg. 2): Pareto front over
    {duration, storage, saturation} with saturation-weighted scoring.

    Two implementations of the same decision function:

    * :meth:`place_scalar` — the reference numpy oracle: a Python loop
      over window starts, one lazily-extended :class:`ParityFrontier`
      per start.
    * the device scorer (:mod:`repro_torch.core.sc_kernel`) — the whole
      (starts x window-lengths) grid scored as one float64 torch
      program over the parity-frontier kernel, for every item of
      :meth:`place_batch` (consumed by ``PlacementEngine.place_many``).

    ``place`` uses the device scorer when the cluster has at least
    ``KERNEL_MIN_NODES`` live nodes (batches of >= 4 items always use
    it); set ``use_kernel = False`` to force the oracle.

    **Partial rescoring after commits**: the saturation *baseline*
    (Alg. 2 line 11's sum over every live node) changes after a commit
    only at the committed nodes, so a
    :class:`~repro_torch.core.incremental.SaturationTracker` fed by the
    engine's ``observe_commit`` hook refreshes just those entries
    instead of re-evaluating the exponential over the whole cluster;
    a :class:`~repro_torch.core.incremental.FreeOrderTracker` likewise keeps
    the free-desc order (and with it the per-start frontier cache keys)
    across commits.  Both reproduce the from-scratch values bitwise (see
    the incremental module docstring); the per-candidate window grid is
    always scored fresh.
    """

    name = "drex_sc"
    MAX_MAPPINGS = 2**10
    #: top-M candidate pre-filter (core/prefilter.sc_cap): above
    #: sc_cap(MAX_MAPPINGS) live nodes, kernel inputs slice to the
    #: freest-M prefix — exact by the start-major enumeration order.
    #: False disables.
    use_prefilter = True
    #: set to False to force the scalar numpy oracle.
    use_kernel = True
    #: below this many live nodes a single item takes the numpy oracle;
    #: batches use the device scorer regardless.  The JAX package's
    #: crossover, kept (the H100's is measured in PERF.md, not applied).
    #: Set to 0 to force the device scorer everywhere (tests do).
    KERNEL_MIN_NODES = 16
    #: batches of >= 4 items always use the kernel (see _kernel_dispatch).
    KERNEL_MIN_NODES_BATCH = 0

    def __init__(self, time_model: ECTimeModel | None = None, device=None):
        self.time_model = time_model or ECTimeModel()
        #: where the batch scorer runs (``None`` means CUDA).
        self.device = resolve_device(device)
        #: incremental rescoring state (None disables; exactness tests
        #: compare both paths).
        self._order_tracker: Optional[FreeOrderTracker] = FreeOrderTracker()
        self._sat_tracker: Optional[SaturationTracker] = SaturationTracker()

    def observe_commit(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Engine commit hook (see ``PlacementEngine._finalize``)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_commit(node_ids, chunk_mb, cluster)
        if self._sat_tracker is not None:
            self._sat_tracker.observe_commit(node_ids, chunk_mb, cluster)

    def observe_release(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Engine release hook.  The saturation tracker's per-entry
        scores are commit-shaped only; a release invalidates it (the
        mirror would catch the mismatch anyway — this skips the failed
        validation)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_release(node_ids, chunk_mb, cluster)
        if self._sat_tracker is not None:
            self._sat_tracker.invalidate()

    def observe_churn(self, kind: str, node_ids, cluster: ClusterView) -> None:
        """Membership-churn hook (fail / heal / join)."""
        if self._order_tracker is not None:
            self._order_tracker.observe_churn(kind, node_ids, cluster)
        if self._sat_tracker is not None:
            self._sat_tracker.invalidate()  # live set changed

    def _by_free(self, cluster: ClusterView) -> np.ndarray:
        if self._order_tracker is None:
            return self._live_sorted(cluster, cluster.free_mb)
        return self._order_tracker.order(cluster)

    def _f_base_sum(
        self, cluster: ClusterView, smin: float, live: np.ndarray, L: int
    ) -> float:
        """Alg. 2 line 11's baseline sum; tracker-served when possible."""
        if self._sat_tracker is None:
            return float(
                saturation_score(
                    cluster.used_mb[live], cluster.capacity_mb[live], smin, L
                ).sum()
            )
        return self._sat_tracker.f_base_sum(cluster, smin)

    def _kernel_wins(self, cluster: ClusterView, batch: int) -> bool:
        return _kernel_dispatch(self, cluster, batch)

    def place(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        self.observe_item(item)
        if self._kernel_wins(cluster, 1):
            smin = self.smin_mb if self.smin_mb is not None else 1.0
            return self._place_kernel([item], [smin], cluster, ctx, constraints)[0]
        return self._place_scalar(item, cluster, ctx, constraints)

    def place_batch(
        self,
        items: Sequence[DataItem],
        cluster: ClusterView,
        ctx=None,
        constraints=None,
    ) -> list[Decision]:
        """Score ``items`` against the *current* cluster snapshot in one
        batched device call.

        Pure: scheduler state (``smin_mb``) is not mutated — each item is
        scored with the running smallest-size anchor it would see under
        sequential ``place`` calls, and the consumer (the engine's
        batched ``place_many``) calls :meth:`observe_item` as it commits
        to a decision.  Decisions are valid only while the cluster is
        unchanged: any commit invalidates the remaining items of the
        batch, which must be re-scored against the post-commit state.
        """
        run = self.smin_mb
        smins: list[float] = []
        for it in items:
            if it.size_mb > 0:
                run = it.size_mb if run is None else min(run, it.size_mb)
            smins.append(run if run is not None else 1.0)
        if self._kernel_wins(cluster, len(items)):
            return self._place_kernel(list(items), smins, cluster, ctx, constraints)
        saved = self.smin_mb
        try:
            out = []
            for it, sm in zip(items, smins):
                self.smin_mb = sm
                out.append(self._place_scalar(it, cluster, ctx, constraints))
            return out
        finally:
            self.smin_mb = saved

    def place_scalar(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        """Reference numpy oracle (kept for equivalence tests)."""
        self.observe_item(item)
        return self._place_scalar(item, cluster, ctx, constraints)

    # -- vectorized path ----------------------------------------------------

    def _place_kernel(
        self,
        items: list[DataItem],
        smins: Sequence[float],
        cluster: ClusterView,
        ctx,
        constraints=None,
    ) -> list[Decision]:
        by_free = self._apply_constraints(
            self._by_free(cluster), cluster, constraints
        )  # line 1
        L = len(by_free)
        if L < 2:
            return [Decision(None, 0, "fewer than 2 live nodes") for _ in items]
        live = cluster.live_ids()
        # Saturation terms stay cluster-global under constraints: the
        # 1/L anchor and the baseline sum describe the repository, not
        # the admissible candidate set (L_live == L when unconstrained,
        # keeping that path bit-identical).
        L_live = len(live)
        used, cap = cluster.used_mb, cluster.capacity_mb
        # Top-M pre-filter (core/prefilter): window enumeration under the
        # candidate budget is start-major, so whenever it engages
        # (L > sc_cap >= budget + 1) no enumerated window ever reaches
        # past the first budget+1 sorted nodes — slicing kernel inputs to
        # M is exact with no per-row test.  Cluster-global terms (the
        # saturation baseline/system saturation below and the 1/L scale,
        # threaded through as n_live) still use the true L.
        M = prefilter.sc_cap(self.MAX_MAPPINGS) if self.use_prefilter else 0
        if 0 < M < L:
            prefilter.record(self.name, "engaged", len(items))
            prefilter.record(self.name, "accepted", len(items))
            if constraints is not None and not constraints.unconstrained:
                # Keep per-domain representatives in the slice (still a
                # free-descending subsequence, so the start-major window
                # logic below is unchanged).
                by_free_k = prefilter.domain_slice(
                    by_free, cluster.rack, cluster.zone, M, constraints,
                    self.name,
                )
            else:
                by_free_k = by_free[:M]
        else:
            by_free_k = by_free
        Lk = len(by_free_k)
        probs_mat = np.empty((len(items), Lk), dtype=np.float64)
        for row, item in enumerate(items):
            probs_mat[row] = self._fail_probs(cluster, item, ctx)[by_free_k]
        # The saturation baseline and system saturation depend only on the
        # item's smin anchor; batches rarely move the running min, so
        # compute once per distinct value (numpy, bit-matching the oracle).
        base_cache: dict[float, tuple[float, float]] = {}
        fbase = np.empty(len(items))
        ssat = np.empty(len(items))
        for row, smin in enumerate(smins):
            got = base_cache.get(smin)
            if got is None:
                f_base_sum = self._f_base_sum(cluster, smin, live, L_live)
                sys_sat = float(
                    saturation_score(
                        np.array([used[live].sum()]),
                        np.array([cap[live].sum()]),
                        smin,
                        L_live,
                    )[0]
                )
                got = (f_base_sum, sys_sat)
                base_cache[smin] = got
            fbase[row], ssat[row] = got
        tm = self.time_model
        ok, s, n, k, p = sc_kernel.score_windows_batch(
            probs_mat,
            np.array([it.size_mb for it in items], dtype=np.float64),
            np.array([it.reliability_target for it in items], dtype=np.float64),
            np.asarray(smins, dtype=np.float64),
            fbase,
            ssat,
            cluster.free_mb[by_free_k],
            cluster.write_bw[by_free_k],
            cluster.read_bw[by_free_k],
            used[by_free_k],
            cap[by_free_k],
            self.MAX_MAPPINGS,
            (tm.e0, tm.e_byte, tm.e_mult, tm.d0, tm.d_byte, tm.d_mult),
            n_live=L_live,
            device=self.device,
        )
        considered = min(L * (L - 1) // 2, self.MAX_MAPPINGS)
        decisions = []
        for row in range(len(items)):
            if not ok[row]:
                decisions.append(
                    Decision(
                        None, considered, "no mapping satisfies reliability+capacity"
                    )
                )
                continue
            s_r, n_r = int(s[row]), int(n[row])
            decisions.append(
                Decision(
                    Placement(
                        k=int(k[row]),
                        p=int(p[row]),
                        node_ids=tuple(int(x) for x in by_free_k[s_r : s_r + n_r]),
                    ),
                    considered,
                    "",
                )
            )
        return decisions

    # -- scalar oracle ------------------------------------------------------

    def _place_scalar(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        by_free = self._apply_constraints(
            self._by_free(cluster), cluster, constraints
        )  # line 1
        L = len(by_free)
        if L < 2:
            return Decision(None, 0, "fewer than 2 live nodes")
        fail_all = self._fail_probs(cluster, item, ctx)
        fail_sorted = fail_all[by_free]
        free_sorted = cluster.free_mb[by_free]
        wb_sorted = cluster.write_bw[by_free]
        rb_sorted = cluster.read_bw[by_free]
        used_sorted = cluster.used_mb[by_free]
        cap_sorted = cluster.capacity_mb[by_free]
        used = cluster.used_mb
        cap = cluster.capacity_mb
        # observe_item just ran, so smin_mb is only None for degenerate
        # zero-size items; fall back to the old 1 MB prior there.
        smin = self.smin_mb if self.smin_mb is not None else 1.0
        size = item.size_mb
        live = cluster.live_ids()
        # Saturation baseline over every live node; candidates add only the
        # delta of their mapped nodes (+chunk), so — like D-Rex LB's
        # balance penalty — unmapped nodes still participate and wide,
        # shallow placements are rewarded for not pushing any node toward
        # its limit.  The 1/L anchor is the true live count (== L unless
        # a constraint shortened the candidate order).
        L_live = len(live)
        f_base_sum = self._f_base_sum(cluster, smin, live, L_live)
        tm = self.time_model

        # Candidate windows as parallel arrays ((s, n) identifies the
        # mapping; only the winner's node tuple is ever materialized).
        cand_cols: list[np.ndarray] = []
        considered = 0
        budget = self.MAX_MAPPINGS
        # line 2: first 2^10 contiguous windows of the sorted order, windows
        # expanding from each start: [0:2],[0:3],...,[0:L],[1:3],...
        # The window [s:e] is a prefix of the suffix starting at s, so one
        # lazily-extended ParityFrontier per start answers every window;
        # all windows sharing a start are then scored vectorized.
        for s in range(L - 1):
            if budget <= 0:
                break
            n_wins = min(L - s - 1, budget)   # windows e in [s+2, s+2+n_wins)
            budget -= n_wins
            considered += n_wins
            nmax = n_wins + 1                 # largest prefix length probed
            frontier = self._frontier(
                fail_sorted[s:], item.reliability_target, ctx
            )
            fr = frontier.upto(nmax)
            n_arr = np.arange(2, nmax + 1)
            mp = fr[1:nmax]                   # min parity for n = 2..nmax
            p_star = np.maximum(1, mp)        # line 4: min storage == max K
            k = n_arr - p_star
            valid = (mp >= 0) & (k >= 1)
            if not np.any(valid):
                continue
            k_safe = np.where(valid, k, 1)
            chunk = size / k_safe
            # Capacity: mapping is sorted by free desc, so the window min
            # is its last node.
            valid &= free_sorted[s + n_arr - 1] >= chunk
            if not np.any(valid):
                continue
            wb_min = np.minimum.accumulate(wb_sorted[s : s + nmax])[n_arr - 1]
            rb_min = np.minimum.accumulate(rb_sorted[s : s + nmax])[n_arr - 1]
            enc = tm.t_encode_many(n_arr, k_safe, size)
            dec = tm.t_decode_many(k_safe, size)
            duration = chunk / wb_min + chunk / rb_min + enc + dec  # line 6
            storage = chunk * n_arr  # line 7
            # line 8: per-window saturation delta of the mapped prefix.
            u = used_sorted[s : s + nmax]
            c = cap_sorted[s : s + nmax]
            delta = saturation_score(
                u[None, :] + chunk[:, None], c[None, :], smin, L_live
            ) - saturation_score(u, c, smin, L_live)[None, :]
            in_window = np.arange(nmax)[None, :] < n_arr[:, None]
            sat = f_base_sum + (delta * in_window).sum(axis=1)
            cand_cols.append(
                np.stack(
                    [
                        np.full(int(valid.sum()), float(s)),
                        n_arr[valid].astype(np.float64),
                        k[valid].astype(np.float64),
                        p_star[valid].astype(np.float64),
                        duration[valid],
                        storage[valid],
                        sat[valid],
                    ],
                    axis=1,
                )
            )
        if not cand_cols:
            return Decision(None, considered, "no mapping satisfies reliability+capacity")
        cands = np.concatenate(cand_cols, axis=0)  # (m, 7); every block non-empty

        # line 11: system saturation over the whole repository.
        sys_sat = float(
            saturation_score(
                np.array([used[live].sum()]), np.array([cap[live].sum()]), smin,
                L_live,
            )[0]
        )

        objectives = cands[:, 4:7]  # (duration, storage, saturation)
        front = cands[_pareto_front(objectives)]
        dur_prog = _progress(front[:, 4])
        sto_prog = _progress(front[:, 5])
        sat_prog = _progress(front[:, 6])
        score = (1.0 - sys_sat) * dur_prog + (sto_prog + sat_prog) / 2.0  # line 17
        best = front[int(np.argmax(score))]
        s_best, n_best = int(best[0]), int(best[1])
        return Decision(
            Placement(
                k=int(best[2]),
                p=int(best[3]),
                node_ids=tuple(int(x) for x in by_free[s_best : s_best + n_best]),
            ),
            considered,
            "",
        )


def _progress(vals: np.ndarray) -> np.ndarray:
    """Relative progress (line 16): 1 at the min, 0 at the max; all-equal
    candidates make no progress relative to each other."""
    lo, hi = float(vals.min()), float(vals.max())
    if hi - lo <= 1e-12:
        return np.zeros_like(vals)
    return (hi - vals) / (hi - lo)


def _pareto_front(objectives: np.ndarray) -> np.ndarray:
    """Keep-mask of the minimizing front over an (m, d) objective matrix;
    one broadcasted pairwise comparison with m <= 1024 candidates."""
    # i is dominated iff some j is <= on every objective and < on one:
    # le[i, j] = all_k arr[j, k] <= arr[i, k]; lt[i, j] = any_k <.
    # Built per objective in 2-D (m x m) to avoid the (m, m, d) temporary.
    m, d = objectives.shape
    le = np.ones((m, m), dtype=bool)
    lt = np.zeros((m, m), dtype=bool)
    for col in range(d):
        c = objectives[:, col]
        le &= c[None, :] <= c[:, None]
        lt |= c[None, :] < c[:, None]
    keep = ~np.any(le & lt, axis=1)
    if not np.any(keep):  # defensive — exact ties are never "dominated"
        keep[:] = True
    return keep


# ---------------------------------------------------------------------------
# §5.2.1 Static erasure coding (HDFS EC(3,2)/EC(6,3), Gluster EC(4,2))
# ---------------------------------------------------------------------------


@register_scheduler_family(r"ec\(\s*(\d+)\s*,\s*(\d+)\s*\)")
class StaticEC(Scheduler):
    """Algorithm 3: fixed (K, P); first K+P fitting nodes by write BW."""

    def __init__(self, k: int, p: int):
        self.k = k
        self.p = p
        self.name = f"ec({k},{p})"

    def place(self, item: DataItem, cluster: ClusterView, ctx=None) -> Decision:
        self.observe_item(item)
        by_bw = self._live_sorted(cluster, cluster.write_bw)  # line 2
        n = self.k + self.p
        chunk = item.size_mb / self.k
        fitting = [int(i) for i in by_bw if cluster.free_mb[i] >= chunk]
        if len(fitting) < n:
            return Decision(None, 1, "not enough nodes with capacity")
        mapping = tuple(fitting[:n])
        fail_all = self._fail_probs(cluster, item, ctx)
        mp = self._min_parity(
            fail_all[list(mapping)], item.reliability_target, ctx
        )
        if mp < 0 or mp > self.p:
            return Decision(None, 1, "fixed (K,P) cannot meet reliability target")
        return Decision(Placement(k=self.k, p=self.p, node_ids=mapping), 1, "")


# ---------------------------------------------------------------------------
# §5.2.2 DAOS: EC configs + replication, least storage overhead meeting RT
# ---------------------------------------------------------------------------


@register_scheduler("daos", adaptive=True)
class DAOSAdaptive(Scheduler):
    """Pick, among DAOS's predefined configs, the one meeting the
    reliability target with the lowest storage overhead (paper §5.2.2).

    Replication 2x/4x/6x is modeled in the erasure-coded representation as
    K=1 with P = copies-1 (paper §3.1)."""

    name = "daos"
    # (K, P), ordered by storage overhead N/K ascending:
    CONFIGS = [(8, 1), (8, 2), (4, 1), (4, 2), (1, 1), (1, 3), (1, 5)]

    def place(self, item: DataItem, cluster: ClusterView, ctx=None) -> Decision:
        self.observe_item(item)
        by_bw = self._live_sorted(cluster, cluster.write_bw)
        fail_all = self._fail_probs(cluster, item, ctx)
        considered = 0
        for k, p in sorted(self.CONFIGS, key=lambda kp: (kp[0] + kp[1]) / kp[0]):
            considered += 1
            n = k + p
            chunk = item.size_mb / k
            fitting = [int(i) for i in by_bw if cluster.free_mb[i] >= chunk]
            if len(fitting) < n:
                continue
            mapping = tuple(fitting[:n])
            mp = self._min_parity(
                fail_all[list(mapping)], item.reliability_target, ctx
            )
            if mp < 0 or mp > p:
                continue
            return Decision(Placement(k=k, p=p, node_ids=mapping), considered, "")
        return Decision(None, considered, "no DAOS config meets target")


# ---------------------------------------------------------------------------
# Extra baseline (ours): uniform random spread — ablation control
# ---------------------------------------------------------------------------


@register_scheduler("random_spread", randomized=True)
class RandomSpread(Scheduler):
    """Uniformly random feasible mapping with HDFS-style EC(6,3); control
    baseline for ablations (not in the paper).

    RNG state: the mapping for an item is drawn from a generator seeded
    with ``(seed, item_id)``, so ``place`` is a pure function of
    ``(seed, item, cluster)`` — repeated calls for the same item return
    the same mapping, and batched ``place_many`` matches sequential
    ``place`` exactly (no generator state threaded between calls).
    """

    name = "random_spread"

    def __init__(self, k: int = 6, p: int = 3, seed: int = 0):
        self.k, self.p = k, p
        self.seed = seed

    def place(self, item: DataItem, cluster: ClusterView, ctx=None) -> Decision:
        self.observe_item(item)
        n = self.k + self.p
        chunk = item.size_mb / self.k
        ids = [int(i) for i in cluster.live_ids() if cluster.free_mb[i] >= chunk]
        if len(ids) < n:
            return Decision(None, 1, "not enough nodes with capacity")
        # Mask to non-negative 64-bit words: default_rng rejects negative
        # entropy, and DataItem does not forbid sentinel/negative ids.
        mask = (1 << 64) - 1
        rng = np.random.default_rng((self.seed & mask, item.item_id & mask))
        mapping = tuple(int(x) for x in rng.choice(ids, size=n, replace=False))
        fail_all = self._fail_probs(cluster, item, ctx)
        mp = self._min_parity(
            fail_all[list(mapping)], item.reliability_target, ctx
        )
        if mp < 0 or mp > self.p:
            return Decision(None, 1, "fixed (K,P) cannot meet reliability target")
        return Decision(Placement(k=self.k, p=self.p, node_ids=mapping), 1, "")


# ---------------------------------------------------------------------------


#: Canonical paper ordering (the 9 algorithms every benchmark sweeps).
SCHEDULER_NAMES = [
    "drex_sc",
    "drex_lb",
    "greedy_min_storage",
    "greedy_least_used",
    "ec(3,2)",
    "ec(4,2)",
    "ec(6,3)",
    "daos",
    "random_spread",
]

# Materialize the paper's static-EC configs in the registry so
# ``scheduler_names()`` lists all nine out of the box.
for _name in SCHEDULER_NAMES:
    get_spec(_name)

