"""D-Rex SC (paper §4.4, Algorithm 2) and the static ``ec(K,P)`` family
(§5.2.1): the schedulers of the checkpoint plane's main path.

Every scheduler answers, for one item ``d`` arriving online, the question
of Problem 1: choose ``(K_d, P_d, M_d)`` subject to the reliability
constraint (Eq. 3) and per-node capacity, optimizing storage and I/O.

All schedulers see the cluster through :class:`repro_torch.core.types.ClusterView`
and are purely functional over it (the caller — normally a
:class:`repro_torch.core.engine.PlacementEngine` — commits the placement).
Each algorithm registers itself with :mod:`repro_torch.core.registry`,
declaring its capabilities, so the checkpoint plane never matches on
name strings.

This module is host numpy float64, copied from the JAX package's
``core/algorithms.py`` so that decisions are bit-identical to the
reference.  D-Rex SC decides through its scalar oracle only; the device
scorer of the JAX package (``sc_kernel._score_windows``) and the other
schedulers (D-Rex LB, the two greedy baselines, DAOS, RandomSpread) are
not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from . import constraints as constraints_mod
from .incremental import FreeOrderTracker, SaturationTracker
from .registry import (
    get_spec,
    register_scheduler,
    register_scheduler_family,
    SchedulerCapabilities,
)
from .reliability import min_parity_for_target, ParityFrontier
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
    "DRexSC",
    "StaticEC",
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

    :meth:`place`, :meth:`place_batch` and :meth:`place_scalar` all run
    the numpy oracle: a Python loop over window starts, one
    lazily-extended :class:`ParityFrontier` per start.  The JAX package
    also scores the whole (starts x window-lengths) grid as one device
    program; its decisions equal the oracle's
    (tests/test_sc_vectorized.py), and the port's device scorer comes in
    a later slice.

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

    def __init__(self, time_model: ECTimeModel | None = None):
        self.time_model = time_model or ECTimeModel()
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

    def place(
        self, item: DataItem, cluster: ClusterView, ctx=None, constraints=None
    ) -> Decision:
        self.observe_item(item)
        return self._place_scalar(item, cluster, ctx, constraints)

    def place_batch(
        self,
        items: Sequence[DataItem],
        cluster: ClusterView,
        ctx=None,
        constraints=None,
    ) -> list[Decision]:
        """Score ``items`` against the *current* cluster snapshot.

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
        """Reference numpy oracle (the name the JAX package's equivalence
        tests call)."""
        self.observe_item(item)
        return self._place_scalar(item, cluster, ctx, constraints)

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


#: The ported subset of the paper's nine algorithms, in the JAX package's
#: canonical order (D-Rex SC and the static ``ec(K,P)`` configs).
SCHEDULER_NAMES = [
    "drex_sc",
    "ec(3,2)",
    "ec(4,2)",
    "ec(6,3)",
]

# Materialize the static-EC configs in the registry so
# ``scheduler_names()`` lists them out of the box.
for _name in SCHEDULER_NAMES:
    get_spec(_name)
