"""Failure-domain constraint mechanics shared by schedulers and the engine.

:class:`~repro_torch.core.types.PlacementConstraints` is the declarative side
(caps + spread); this module is the operational side, built around one
observation that keeps the schedulers' scorers untouched:

* :func:`constrained_order` greedily admits nodes from a scheduler's own
  sorted candidate order while no failure domain exceeds its cap.  The
  admitted *set* as a whole satisfies the caps, therefore **every subset
  of it does** (domain counts only shrink under subsetting).  D-Rex SC's
  contiguous windows, D-Rex LB's prefix grid and both greedy rules all
  select subsets of the order they are handed — so feeding them the
  admitted order makes every decision cap-conforming by construction,
  with zero kernel changes.  An admitted order is a subsequence of the
  input, so a free-descending input stays free-descending (the kernels'
  sortedness assumptions hold).
* :func:`repair_mapping` is the swap-based post-pass: the registry-wide
  fallback for schedulers that do not declare ``topology_aware``, and
  the spread-width enforcer for those that do (caps are handled by the
  admitted order; spread needs a whole-mapping view).  It swaps the
  cheapest over-cap chunk (least free space in an over-cap domain) to
  the best out-of-domain candidate, then fixes spread the same way, and
  finally re-checks Eq. 3 feasibility so a swap can never silently trade
  durability for topology.

Greedily admitting under caps is WLOG for prefix-greedy choice rules:
any excluded node is dominated, under the scheduler's own sort key, by
the cap's worth of same-domain nodes admitted before it.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .types import ClusterView, Placement, PlacementConstraints

__all__ = ["constrained_order", "repair_mapping", "has_caps"]


def has_caps(constraints: Optional[PlacementConstraints]) -> bool:
    """Whether the constraints include per-domain caps (the part the
    admitted candidate order enforces; spread is the post-pass's job)."""
    return constraints is not None and (
        constraints.max_per_rack is not None
        or constraints.max_per_zone is not None
    )


def _occurrence_rank(values: np.ndarray) -> np.ndarray:
    """For each element, how many earlier elements share its value.

    Stable argsort groups equal values in original order, so the offset
    from each group's start is exactly the prior-occurrence count."""
    n = values.shape[0]
    idx = np.argsort(values, kind="stable")
    sorted_vals = values[idx]
    starts = np.nonzero(np.r_[True, np.diff(sorted_vals) != 0])[0]
    group_start = np.repeat(starts, np.diff(np.r_[starts, n]))
    ranks = np.empty(n, dtype=np.int64)
    ranks[idx] = np.arange(n) - group_start
    return ranks


def constrained_order(
    order: np.ndarray,
    rack: np.ndarray,
    zone: np.ndarray,
    constraints: Optional[PlacementConstraints],
) -> np.ndarray:
    """Greedy cap-admitted subsequence of a sorted candidate order.

    Walks ``order`` admitting each node while its rack/zone counts among
    already-admitted nodes stay below the caps; over-cap nodes are
    dropped.  Returns ``order`` unchanged (same object) when there are
    no caps, so the unconstrained path is bit-identical to before this
    module existed.
    """
    if not has_caps(constraints):
        return order
    order = np.asarray(order)
    cap_r = constraints.max_per_rack
    cap_z = constraints.max_per_zone
    if cap_r is not None and cap_z is None:
        return order[_occurrence_rank(rack[order]) < cap_r]
    if cap_z is not None and cap_r is None:
        return order[_occurrence_rank(zone[order]) < cap_z]
    # Both axes capped: sequential admission (a rack-rejected node must
    # not consume a zone slot, so the two ranks are not independent).
    r_cnt: dict[int, int] = {}
    z_cnt: dict[int, int] = {}
    keep = np.zeros(order.shape[0], dtype=bool)
    r_arr = rack[order]
    z_arr = zone[order]
    for i in range(order.shape[0]):
        r = int(r_arr[i])
        z = int(z_arr[i])
        if r_cnt.get(r, 0) < cap_r and z_cnt.get(z, 0) < cap_z:
            keep[i] = True
            r_cnt[r] = r_cnt.get(r, 0) + 1
            z_cnt[z] = z_cnt.get(z, 0) + 1
    return order[keep]


def _counts(ids: Sequence[int], axis: np.ndarray) -> dict[int, int]:
    out: dict[int, int] = {}
    for i in ids:
        d = int(axis[i])
        out[d] = out.get(d, 0) + 1
    return out


def _admissible(
    node: int,
    ids: list[int],
    skip: int,
    rack: np.ndarray,
    zone: np.ndarray,
    c: PlacementConstraints,
) -> bool:
    """Would swapping ``skip`` -> ``node`` keep every capped axis within
    its cap?  (Counts are over the post-swap mapping; a pre-existing
    violation elsewhere is allowed to persist — it gets its own swap.)"""
    for axis, cap in ((rack, c.max_per_rack), (zone, c.max_per_zone)):
        if cap is None:
            continue
        d = int(axis[node])
        cnt = sum(1 for i in ids if i != skip and int(axis[i]) == d)
        if cnt + 1 > cap:
            return False
    return True


def repair_mapping(
    placement: Placement,
    cluster: ClusterView,
    constraints: PlacementConstraints,
    chunk_mb: float,
    *,
    min_parity: Optional[Callable[[np.ndarray], int]] = None,
    fail_probs: Optional[np.ndarray] = None,
) -> Optional[tuple[Placement, int]]:
    """Swap chunks until ``placement`` satisfies ``constraints``.

    Returns ``(new_placement, n_swaps)`` or ``None`` when the constraints
    cannot be met (no admissible candidate, or the swapped mapping no
    longer meets the reliability target).  Pure: the view is only read.
    Deterministic: victims are the least-free member of the worst domain
    (ties on node id), replacements the freest admissible candidate.

    When ``min_parity`` and ``fail_probs`` are provided, the repaired
    mapping must still satisfy Eq. 3 at the original parity count
    (``min_parity(fail_probs[mapping]) <= placement.p``).
    """
    ids = list(int(i) for i in placement.node_ids)
    n = len(ids)
    rack, zone = cluster.rack, cluster.zone
    free = cluster.free_mb
    in_map = set(ids)
    pool = [
        int(i)
        for i in cluster.live_ids()
        if int(i) not in in_map and free[i] >= chunk_mb
    ]
    pool.sort(key=lambda i: (-free[i], i))
    swaps = 0

    def swap(victim: int, repl: int) -> None:
        nonlocal swaps
        ids[ids.index(victim)] = repl
        pool.remove(repl)
        swaps += 1

    # Phase 1 — caps: evict the cheapest chunk of each over-cap domain.
    for axis, cap in ((rack, constraints.max_per_rack),
                      (zone, constraints.max_per_zone)):
        if cap is None:
            continue
        for _ in range(2 * n):
            counts = _counts(ids, axis)
            over = {d for d, cnt in counts.items() if cnt > cap}
            if not over:
                break
            victim = min(
                (i for i in ids if int(axis[i]) in over),
                key=lambda i: (free[i], -i),
            )
            repl = next(
                (
                    cand
                    for cand in pool
                    if _admissible(cand, ids, victim, rack, zone, constraints)
                ),
                None,
            )
            if repl is None:
                return None
            swap(victim, repl)

    # Phase 2 — spread: promote a candidate from an unrepresented domain,
    # evicting from the most-populated one.  Bounded alternation because
    # a zone swap may narrow rack spread and vice versa.
    need_r = min(constraints.min_racks, n)
    need_z = min(constraints.min_zones, n)
    for _ in range(2 * n):
        fixed = True
        for axis, other, need in ((rack, zone, need_r), (zone, rack, need_z)):
            counts = _counts(ids, axis)
            if len(counts) >= need:
                continue
            fixed = False
            repl = next(
                (
                    cand
                    for cand in pool
                    if int(axis[cand]) not in counts
                    and _admissible(cand, ids, -1, rack, zone, constraints)
                ),
                None,
            )
            if repl is None:
                return None
            # Evict from the most-populated domain of this axis, preferring
            # victims whose *other*-axis domain keeps >= 2 members so the
            # swap cannot undo the other axis's spread.
            crowd = max(counts.items(), key=lambda kv: (kv[1], -kv[0]))[0]
            other_counts = _counts(ids, other)
            members = [i for i in ids if int(axis[i]) == crowd]
            safe = [i for i in members if other_counts[int(other[i])] >= 2]
            victim = min(safe or members, key=lambda i: (free[i], -i))
            swap(victim, repl)
        if fixed:
            break
    if not constraints.satisfied_by(ids, rack, zone):
        return None

    if min_parity is not None and fail_probs is not None:
        mp = min_parity(fail_probs[np.asarray(ids)])
        if not (0 <= mp <= placement.p):
            return None
    if swaps == 0:
        return placement, 0
    return (
        Placement(k=placement.k, p=placement.p, node_ids=tuple(ids)),
        swaps,
    )
