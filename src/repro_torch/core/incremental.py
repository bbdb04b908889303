"""Incremental commit-delta rescoring for cluster-global D-Rex terms.

Both dynamic D-Rex schedulers rescore *cluster-global* quantities on
every placement: LB re-sorts all live nodes by free space and re-averages
them for the balance penalty's ``f_avg``; SC re-evaluates the exponential
saturation baseline over every live node.  Under commit-heavy streaming
load those recomputations dominate the per-decision cost, yet a commit's
effect on the cluster is known exactly — ``used_mb[node_ids] += chunk``
— so this module keeps per-scheduler trackers that fold commit deltas in
instead of recomputing from scratch.

**Exactness contract.**  Decisions must stay bit-identical to the
from-scratch path (the simulator's legacy goldens and the fig12 equality
gates pin absolute placements), which rules out changing any summation
order.  The trackers therefore never maintain floating-point *sums*
incrementally:

* :class:`FreeOrderTracker` maintains the free-desc *sort order*.  It is
  an alias of :class:`repro_torch.core.candidates.CandidateTracker`, which
  generalizes the original O(p) adjacency fast path (sortedness of every
  adjacent pair under the strict ``(free desc, id asc)`` total order
  implies the unique sorted arrangement, hence equality with a fresh
  stable argsort) with an O(p log N) *splice* that repositions only the
  touched nodes when they actually moved — instead of dropping the cache
  and re-argsorting all N.  When the order is served from cache,
  ``f_avg`` and the deviation terms are recomputed in O(L) over the
  *same* element order, which is bitwise what the argsort path yields;
  an unchanged order also keeps the permuted fail-prob sequence
  identical, so :class:`BatchContext` frontier hits survive the commit.
* :class:`SaturationTracker` caches D-Rex SC's per-node saturation
  scores in live-id order and refreshes only the touched entries after a
  commit (``saturation_score`` is elementwise, so a sliced recompute is
  bit-equal to the full-array one); the baseline ``f_base_sum`` is then
  the same left-to-right pairwise ``.sum()`` over the same value
  sequence the from-scratch path reduces.

**Self-healing.**  Trackers mirror ``(used_mb, alive)`` (one shared
mirror implementation, ``repro_torch.core.candidates._UsedMirror``) and
validate the mirror against the live view on every query (two vectorized
array compares); any out-of-band mutation — a direct array write, a
rollback, a mutation whose observe hook was not called — fails
validation and triggers a from-scratch rebuild.  The engine feeds
commits through ``Scheduler.observe_commit`` (see
``PlacementEngine._finalize``), releases through ``observe_release`` and
membership churn through ``observe_churn``; everything else is caught by
validation.  Exactness and reuse are pinned by
tests/test_incremental_rescore.py and tests/test_candidates.py.
"""

from __future__ import annotations

import numpy as np

from .candidates import CandidateTracker, _UsedMirror
from .types import ClusterView

__all__ = ["FreeOrderTracker", "SaturationTracker"]

#: Backward-compatible name: the free-desc order tracker was absorbed
#: into the generalized candidate-order structure (see candidates.py).
FreeOrderTracker = CandidateTracker


class SaturationTracker:
    """Caches D-Rex SC's per-node saturation baseline across commits.

    Scores are kept per smin anchor in live-id order; a commit refreshes
    only the touched entries (elementwise recompute over the touched
    slice — bit-equal to the full-array evaluation), and
    :meth:`f_base_sum` is the same ``.sum()`` over the same value
    sequence the from-scratch path reduces.
    """

    #: distinct smin anchors kept; the anchor is a running minimum, so
    #: more than a couple of live values means the trace is degenerate.
    MAX_ANCHORS = 8

    def __init__(self):
        self._mirror = _UsedMirror()
        self._live: np.ndarray | None = None
        self._pos: np.ndarray | None = None
        self._scores: dict[float, np.ndarray] = {}
        self.hits = 0
        self.rebuilds = 0

    def invalidate(self) -> None:
        self._scores.clear()
        self._live = None
        self._pos = None
        self._mirror.used = None

    def f_base_sum(self, cluster: ClusterView, smin: float) -> float:
        """Saturation baseline over every live node for one smin anchor —
        bit-equal to
        ``float(saturation_score(used[live], cap[live], smin, L).sum())``."""
        from .algorithms import saturation_score  # deferred: no cycle

        smin = float(smin)
        if self._live is None or not self._mirror.matches(cluster):
            self.invalidate()
            self._live = cluster.live_ids()
            pos = np.full(cluster.n_nodes, -1, dtype=np.int64)
            pos[self._live] = np.arange(len(self._live))
            self._pos = pos
            self._mirror.capture(cluster)
        scores = self._scores.get(smin)
        if scores is None:
            self.rebuilds += 1
            scores = saturation_score(
                cluster.used_mb[self._live],
                cluster.capacity_mb[self._live],
                smin,
                len(self._live),
            )
            if len(self._scores) >= self.MAX_ANCHORS:
                self._scores.clear()
            self._scores[smin] = scores
        else:
            self.hits += 1
        return float(scores.sum())

    def observe_commit(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Refresh only the committed nodes' cached saturation scores."""
        from .algorithms import saturation_score

        if self._live is None:
            return
        if not self._mirror.apply_commit(node_ids, chunk_mb):
            self.invalidate()
            return
        ids = np.asarray(node_ids)
        if int(ids.max()) >= len(self._pos):
            self.invalidate()
            return
        at = self._pos[ids]
        if np.any(at < 0):  # committed to a node outside the cached live set
            self.invalidate()
            return
        used = self._mirror.used[ids]
        cap = cluster.capacity_mb[ids]
        L = len(self._live)
        for smin, scores in self._scores.items():
            scores[at] = saturation_score(used, cap, smin, L)
