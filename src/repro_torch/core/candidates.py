"""Incrementally maintained live-node candidate order (free desc, id asc).

Every prefix-greedy decision consumes ``Scheduler._live_sorted(cluster,
cluster.free_mb)`` — live node ids sorted free-space-descending with
ascending-id tie-break.  That is a *strict total order* over live nodes,
so there is exactly one sorted arrangement; any structure that maintains
it is bit-identical to the from-scratch stable argsort by construction.
This module maintains it across the cluster's mutation vocabulary —
commit / release / fail / heal / join — repositioning only the touched
nodes instead of re-sorting all N per decision:

* **O(p) fast path** — a commit (or release) changes the free space of
  its p mapped nodes only.  Each touched node's new key is written in
  place and verified against its cached neighbours under the total
  order; when every adjacency holds the arrangement is still *the*
  sorted one and the query returns the cached arrays untouched.
* **O(p log N) splice** — when a touched node actually moved past a
  neighbour (or a node died / was healed / joined), the touched set is
  deleted from the cached order in one vectorized pass and re-inserted
  at ``searchsorted`` positions (binary search on the key array, with an
  ascending-id bisect inside equal-key runs).  The surviving elements
  keep their relative order — they were sorted and their keys did not
  change — so the spliced arrangement is again the unique sorted one.
  No argsort runs; the O(N) terms are C-speed ``np.delete``/``np.insert``
  memmoves.
* **Self-healing** — the tracker mirrors ``(used_mb, alive)`` and
  validates the mirror against the live view on every query (vectorized
  array compares).  Any out-of-band mutation — a direct array write, a
  rollback, a mutation whose observe hook was not called — fails
  validation and triggers a from-scratch rebuild.  The observe hooks are
  an optimization, never a soundness requirement.

Exactness is pinned by tests/test_candidates.py (property suite over
random op interleavings, including equal-free tie churn and dead-node
resurrection) and tests/test_incremental_rescore.py (engine-level
bit-identity).  :class:`~repro_torch.core.incremental.FreeOrderTracker` is an
alias of :class:`CandidateTracker`; both D-Rex trackers share the one
:class:`_UsedMirror` defined here.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from .types import ClusterView

__all__ = ["CandidateTracker"]


class _UsedMirror:
    """Mirror of ``(used_mb, alive)`` that replays mutation deltas with
    the exact array ops :class:`ClusterView` performs, so a mirror that
    matched before a mutation matches (bitwise) after it."""

    def __init__(self):
        self.used: np.ndarray | None = None
        self.alive: np.ndarray | None = None

    def capture(self, cluster: ClusterView) -> None:
        self.used = cluster.used_mb.copy()
        self.alive = cluster.alive.copy()

    def matches(self, cluster: ClusterView) -> bool:
        return (
            self.used is not None
            and self.used.shape == cluster.used_mb.shape
            and np.array_equal(self.used, cluster.used_mb)
            and np.array_equal(self.alive, cluster.alive)
        )

    def apply_commit(self, node_ids, chunk_mb: float) -> bool:
        """Replay one commit; False when the mirror cannot absorb it."""
        if self.used is None:
            return False
        ids = np.asarray(node_ids)
        if ids.size == 0 or int(ids.max()) >= len(self.used):
            return False
        self.used[ids] += chunk_mb  # ClusterView.commit's exact op
        return True

    def apply_release(self, node_ids, chunk_mb: float) -> bool:
        """Replay :meth:`ClusterView.release`; False when the clamp would
        touch entries outside ``node_ids`` (a view that already held
        negative occupancy — pathological; the caller rebuilds)."""
        if self.used is None:
            return False
        ids = np.asarray(list(node_ids))
        if ids.size == 0 or int(ids.max()) >= len(self.used):
            return False
        neg_before = int(np.count_nonzero(self.used < 0.0))
        if neg_before:
            return False
        self.used[ids] -= chunk_mb
        np.maximum(self.used, 0.0, out=self.used)  # release's exact clamp
        return True

    def apply_fail_stop(self, node_ids) -> bool:
        """Replay :meth:`ClusterView.fail_stop`: dead and empty."""
        if self.used is None:
            return False
        ids = np.asarray(list(node_ids))
        if ids.size == 0 or int(ids.max()) >= len(self.used):
            return False
        self.alive[ids] = False
        self.used[ids] = 0.0
        return True

    def apply_heal(self, node_ids) -> bool:
        """Replay :meth:`ClusterView.heal_node`: alive and empty."""
        if self.used is None:
            return False
        ids = np.asarray(list(node_ids))
        if ids.size == 0 or int(ids.max()) >= len(self.used):
            return False
        self.alive[ids] = True
        self.used[ids] = 0.0
        return True

    def grow_to(self, cluster: ClusterView) -> bool:
        """Absorb an elastic join: extend the mirror with the live view's
        tail values (``add_node`` appends, never rewrites the prefix)."""
        if self.used is None:
            return False
        old = len(self.used)
        n = cluster.n_nodes
        if n < old:
            return False
        if n > old:
            used = np.empty(n, dtype=self.used.dtype)
            used[:old] = self.used
            used[old:] = cluster.used_mb[old:]
            alive = np.empty(n, dtype=self.alive.dtype)
            alive[:old] = self.alive
            alive[old:] = cluster.alive[old:]
            self.used, self.alive = used, alive
        return True


class CandidateTracker:
    """Maintains the free-desc live-node order across mutation deltas.

    :meth:`order` returns exactly what
    ``Scheduler._live_sorted(cluster, cluster.free_mb)`` would; the
    returned array is shared state — callers must not mutate it.
    :meth:`topm` slices the lazily-maintained top-M prefix for the
    candidate pre-filter.

    Counters: ``hits`` — queries served from the maintained order (fast
    path or splice); ``rebuilds`` — from-scratch argsorts (first query
    and out-of-band self-heals); ``splices`` — queries that repositioned
    a pending touched set.
    """

    def __init__(self):
        self._mirror = _UsedMirror()
        self._order: np.ndarray | None = None  # ids, free desc / id asc
        self._neg: np.ndarray | None = None    # -(free) per slot, ascending
        self._pos: np.ndarray | None = None    # node id -> slot, -1 absent
        self._touched: set[int] = set()        # ids pending reposition
        self.hits = 0
        self.rebuilds = 0
        self.splices = 0

    # -- queries ------------------------------------------------------------

    def invalidate(self) -> None:
        self._order = None
        self._neg = None
        self._pos = None
        self._touched.clear()
        self._mirror.used = None

    def order(self, cluster: ClusterView) -> np.ndarray:
        """The full maintained order (== fresh ``_live_sorted``)."""
        if self._order is None or not self._mirror.matches(cluster):
            return self._rebuild(cluster)
        if self._touched:
            self._splice(cluster)
        self.hits += 1
        return self._order

    def topm(self, cluster: ClusterView, m: int) -> np.ndarray:
        """Lazily-extracted top-M prefix of the maintained order."""
        return self.order(cluster)[:m]

    def hit_rate(self) -> float:
        total = self.hits + self.rebuilds
        return self.hits / total if total else 0.0

    # -- observe hooks ------------------------------------------------------

    def observe_commit(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Fold one committed placement (``used[ids] += chunk``) in."""
        if self._order is None:
            return
        if not self._mirror.apply_commit(node_ids, chunk_mb):
            self.invalidate()
            return
        self._reposition(node_ids, cluster)

    def observe_release(self, node_ids, chunk_mb: float, cluster: ClusterView) -> None:
        """Fold one release (``used[ids] -= chunk`` + clamp) in."""
        if self._order is None:
            return
        if not self._mirror.apply_release(node_ids, chunk_mb):
            self.invalidate()
            return
        self._reposition(node_ids, cluster)

    def observe_churn(self, kind: str, node_ids, cluster: ClusterView) -> None:
        """Fold a membership event in: ``fail`` (fail-stop: dead+empty),
        ``heal`` (alive+empty) or ``join`` (appended nodes).  Unknown
        kinds invalidate — the mirror then self-heals on the next query."""
        if self._order is None:
            return
        if kind == "fail":
            ok = self._mirror.apply_fail_stop(node_ids)
        elif kind == "heal":
            ok = self._mirror.apply_heal(node_ids)
        elif kind == "join":
            ok = self._mirror.grow_to(cluster)
        else:
            ok = False
        if not ok:
            self.invalidate()
            return
        self._mark(node_ids)

    # -- internals ----------------------------------------------------------

    def _rebuild(self, cluster: ClusterView) -> np.ndarray:
        self.rebuilds += 1
        ids = cluster.live_ids()
        neg = -cluster.free_mb[ids]
        perm = np.argsort(neg, kind="stable")  # key asc == free desc, ids asc in ties
        self._order = ids[perm]
        self._neg = neg[perm]
        pos = np.full(cluster.n_nodes, -1, dtype=np.int64)
        pos[self._order] = np.arange(len(self._order))
        self._pos = pos
        self._touched.clear()
        self._mirror.capture(cluster)
        return self._order

    def _mark(self, node_ids: Iterable[int]) -> None:
        """Queue ids for the next query's splice (no adjacency check)."""
        alive, pos = self._mirror.alive, self._pos
        for i in node_ids:
            i = int(i)
            if i >= len(alive):
                self.invalidate()
                return
            if alive[i] or (i < len(pos) and pos[i] >= 0):
                self._touched.add(i)

    def _reposition(self, node_ids, cluster: ClusterView) -> None:
        """O(p) fast path: write the touched keys in place and verify
        each against its neighbours under the strict total order
        ``(-free asc, id asc)``.  Sortedness of every adjacent pair under
        a strict total order implies the unique sorted arrangement, so a
        passing check leaves the cached order *the* answer.  On any
        violation the writes are reverted and the whole touched set is
        queued for the next query's splice (all-or-nothing: partial
        in-place moves cannot be verified pairwise)."""
        if self._touched:
            self._mark(node_ids)  # order already pending; skip the check
            return
        by, neg, pos = self._order, self._neg, self._pos
        used, alive = self._mirror.used, self._mirror.alive
        slots: list[tuple[int, int]] = []
        olds: list[float] = []
        for i in dict.fromkeys(int(x) for x in node_ids):
            if i >= len(alive):
                self.invalidate()
                return
            k = int(pos[i]) if i < len(pos) else -1
            if k < 0:
                if alive[i]:  # alive but absent from the order: stale
                    self.invalidate()
                continue  # delta on a dead node: order unaffected
            slots.append((i, k))
            olds.append(float(neg[k]))
        if self._order is None:  # invalidated above
            return

        def before(ka: float, ia: int, kb: float, ib: int) -> bool:
            return ka < kb or (ka == kb and ia < ib)

        # keys: -(free) computed exactly as the rebuild does
        cap = cluster.capacity_mb
        for i, k in slots:
            neg[k] = -(cap[i] - used[i])
        ok = True
        for i, k in slots:
            if k > 0 and not before(float(neg[k - 1]), int(by[k - 1]), float(neg[k]), i):
                ok = False
                break
            if k + 1 < len(by) and not before(
                float(neg[k]), i, float(neg[k + 1]), int(by[k + 1])
            ):
                ok = False
                break
        if not ok:
            for (i, k), old in zip(slots, olds):
                neg[k] = old
            self._mark(node_ids)

    def _splice(self, cluster: ClusterView) -> None:
        """Batch-reposition the pending touched set.

        Common case (every touched node alive and present — commits and
        releases, the per-decision traffic): a **windowed re-sort**.
        All stale slots sit inside ``[min slot, max slot]``, so the key
        array outside that span is clean and sorted; two binary searches
        extend the span to where the new keys could land, and only that
        window is re-sorted (``lexsort`` on (key, id) — exactly the
        strict total order) and its ``_pos`` entries rewritten.  Cost is
        O(w log w + log N) for window w — per-decision cost does not
        scale with N (the 100k gate in benchmarks/scale_cluster.py).

        Membership changes (fail / heal / join — rare events) take the
        general path: vectorized delete of the touched-present slots,
        then binary-search inserts (key bisect + ascending-id bisect
        inside the equal-key run) and an O(N) ``_pos`` rebuild."""
        touched = np.fromiter(self._touched, dtype=np.int64, count=len(self._touched))
        pos = self._pos
        if (
            int(touched.max()) < len(pos)
            and bool(np.all(pos[touched] >= 0))
            and bool(np.all(self._mirror.alive[touched]))
        ):
            self._splice_window(touched, cluster)
            return
        at = pos[touched[touched < len(pos)]]
        at = at[at >= 0]
        order, neg = self._order, self._neg
        if at.size:
            at = np.sort(at)
            order = np.delete(order, at)
            neg = np.delete(neg, at)
        alive, used = self._mirror.alive, self._mirror.used
        ins = touched[alive[touched]]
        if ins.size:
            ins = np.sort(ins)  # ascending ids
            keys = -(cluster.capacity_mb[ins] - used[ins])
            srt = np.argsort(keys, kind="stable")  # keeps id asc within ties
            ins, keys = ins[srt], keys[srt]
            where = np.empty(len(ins), dtype=np.int64)
            for j in range(len(ins)):
                lo = int(np.searchsorted(neg, keys[j], side="left"))
                hi = int(np.searchsorted(neg, keys[j], side="right"))
                where[j] = lo + int(np.searchsorted(order[lo:hi], ins[j]))
            order = np.insert(order, where, ins)
            neg = np.insert(neg, where, keys)
        self._order, self._neg = order, neg
        n = cluster.n_nodes
        if self._pos is None or len(self._pos) != n:
            self._pos = np.empty(n, dtype=np.int64)
        self._pos.fill(-1)
        self._pos[self._order] = np.arange(len(self._order))
        self._touched.clear()
        self.splices += 1

    def _splice_window(self, touched: np.ndarray, cluster: ClusterView) -> None:
        """Pure reposition (no membership change): re-sort only the span
        the moved keys can affect.  Entries before ``lo`` are strictly
        below every new key and entries from ``hi`` on strictly above
        (ties land inside the window), and untouched survivors inside
        the window were already ordered against both sides — so sorted
        prefix + sorted window + sorted suffix is *the* unique sorted
        arrangement."""
        order, neg, pos = self._order, self._neg, self._pos
        used = self._mirror.used
        keys = -(cluster.capacity_mb[touched] - used[touched])
        slots = pos[touched]
        lo0, hi0 = int(slots.min()), int(slots.max()) + 1
        lo = int(np.searchsorted(neg[:lo0], float(keys.min()), side="left"))
        hi = hi0 + int(np.searchsorted(neg[hi0:], float(keys.max()), side="right"))
        neg[slots] = keys  # stale slots are inside [lo0, hi0) ⊆ window
        sub_ids, sub_neg = order[lo:hi], neg[lo:hi]
        perm = np.lexsort((sub_ids, sub_neg))  # key asc, id asc in ties
        order[lo:hi] = sub_ids[perm]
        neg[lo:hi] = sub_neg[perm]
        pos[order[lo:hi]] = np.arange(lo, hi, dtype=np.int64)
        self._touched.clear()
        self.splices += 1
