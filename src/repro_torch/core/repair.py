"""Repair planning: the one policy for re-placing degraded items.

Before this module existed the repo had two divergent hand-rolled repair
paths (the simulator's chunk rescheduling and the checkpoint manager's
proactive re-encode) that bypassed the placement engine entirely — no
telemetry, no shared reliability-DP kernel, no capability gating.  The
:class:`RepairPlanner` answers the one question both ask: *given an item
whose placement lost chunks, where do the replacements go?*

The policy (matching §5.7 of the paper):

* fewer than K surviving chunks ⇒ the item is unrecoverable;
* replacement targets are the freest live nodes not already involved
  with the item (the dynamic algorithms' house style);
* when the caller requires the reliability target to hold, the new
  mapping must satisfy Eq. 3 — schedulers whose registry entry declares
  ``supports_parity_growth`` may buy extra parity chunks to get there
  (gated by :class:`~repro_torch.core.engine.PlacementEngine`, which combines
  the caller's flag with the scheduler's declared capability);
* feasibility is answered through the shared reliability-DP kernel —
  an optional :class:`~repro_torch.core.engine.BatchContext` memoizes failure
  probabilities and min-parity queries across the repairs of one
  failure event.

The planner is *pure*: it never mutates the cluster view.  Commit (and
rollback of in-flight repairs) is the engine's job, so repair decisions
get the same commit/rollback + telemetry treatment as placements.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .reliability import min_parity_for_target
from .types import ClusterView, DataItem, Placement, PlacementConstraints

__all__ = ["RepairPlan", "RepairPlanner"]


@dataclasses.dataclass(frozen=True)
class RepairPlan:
    """Structured telemetry for one repair decision (the repair-side
    analogue of :class:`~repro_torch.core.engine.PlacementRecord`)."""

    item_id: int
    placement: Optional[Placement]     # full post-repair placement; None => infeasible
    survivors: tuple[int, ...]         # nodes still holding valid chunks
    new_nodes: tuple[int, ...]         # replacement targets, one chunk each
    added_parity: int                  # parity chunks bought on top of the old P
    chunk_mb: float
    candidates_considered: int
    reason: str                        # "" on success
    overhead_s: float = 0.0            # planner wall time (engine fills this in)
    committed: bool = False            # True iff replacement bytes were reserved

    @property
    def ok(self) -> bool:
        return self.placement is not None

    @property
    def repair_mb(self) -> float:
        """Replacement *write* bytes (kept under the historical name —
        the engine's ``repair_mb_committed`` gauge and the simulator's
        ``repaired_mb`` both account committed write bytes)."""
        return self.chunk_mb * len(self.new_nodes)

    @property
    def write_mb(self) -> float:
        """Bytes written onto replacement targets (alias of repair_mb)."""
        return self.repair_mb

    @property
    def read_mb(self) -> float:
        """Reconstruction *read* bytes: decoding the lost chunks streams
        one chunk from each of K survivors.  Zero when nothing needs
        rebuilding (no replacement targets)."""
        if not self.new_nodes or self.placement is None:
            return 0.0
        return self.chunk_mb * self.placement.k

    @property
    def total_traffic_mb(self) -> float:
        """Total repair traffic (survivor reads + replacement writes) —
        the quantity a shared cluster-wide repair budget throttles."""
        return self.read_mb + self.write_mb


class RepairPlanner:
    """Plans degraded-item re-placement against one :class:`ClusterView`."""

    def __init__(self, cluster: ClusterView):
        self.cluster = cluster

    def plan(
        self,
        item: DataItem,
        placement: Placement,
        *,
        chunk_mb: float | None = None,
        survivors: Sequence[int] | None = None,
        allow_parity_growth: bool = False,
        require_target: bool = True,
        ctx=None,
        constraints: Optional[PlacementConstraints] = None,
    ) -> RepairPlan:
        """Plan replacements for ``placement``'s lost chunks.

        ``survivors`` is the set of nodes still holding valid chunks; when
        omitted it is derived from the view's liveness (correct while the
        only invalid chunks are those on currently-dead nodes — callers
        tracking chunk state out of band, e.g. the checkpoint manager or
        in-flight repairs, pass it explicitly).  ``require_target=False``
        skips the reliability-feasibility loop (best-effort repair with
        the old (K, P) kept — the checkpoint plane's mode, where group
        health is reported separately).

        ``constraints`` (failure-domain caps + spread) shape replacement
        selection: a candidate is only taken while it keeps every capped
        domain within its cap *given the surviving chunks*, and while a
        spread width is unmet candidates from unrepresented domains are
        preferred.  Survivors hold data and are never moved, so a
        pre-constraint mapping that already violates a cap keeps its
        violation (repair never makes it worse) — cap-conforming inputs
        stay cap-conforming, which is what the invariant harness pins.
        """
        cluster = self.cluster
        chunk = (
            placement.chunk_size_mb(item.size_mb)
            if chunk_mb is None
            else float(chunk_mb)
        )
        if survivors is None:
            surv = [int(i) for i in placement.node_ids if cluster.alive[i]]
        else:
            surv = [int(i) for i in survivors]
        lost = placement.n - len(surv)

        def infeasible(reason: str, considered: int = 0) -> RepairPlan:
            return RepairPlan(
                item.item_id, None, tuple(surv), (), 0, chunk, considered, reason
            )

        if lost == 0:
            return RepairPlan(
                item.item_id, placement, tuple(surv), (), 0, chunk, 0, ""
            )
        if len(surv) < placement.k:
            return infeasible(
                f"unrecoverable: {len(surv)}/{placement.k} chunks survive"
            )
        # Freest-first replacement candidates; every node of the old
        # mapping is excluded (survivors must not double up, dead nodes
        # are gone, and a node that lost its chunk while staying alive —
        # the checkpoint heal case — held this item once already).
        # ``free_mb`` is computed once: read per node it costs O(N) each,
        # O(N^2) a plan.  A stable argsort of the id-ascending live nodes
        # on -free keeps ties in id order, as a stable sort on that key.
        exclude = set(surv) | {int(i) for i in placement.node_ids}
        free = cluster.free_mb
        live = cluster.live_ids()
        live = live[(free[live] >= chunk) & ~np.isin(live, list(exclude))]
        candidates = live[np.argsort(-free[live], kind="stable")].tolist()
        considered = len(candidates)
        if len(candidates) < lost:
            return infeasible(
                f"not enough replacement capacity: need {lost} nodes, "
                f"{len(candidates)} fit",
                considered,
            )
        if constraints is not None and not constraints.unconstrained:
            new_map, remaining = self._select_constrained(
                surv, candidates, lost, placement.n, constraints
            )
            if new_map is None:
                return infeasible(
                    "no replacement satisfies failure-domain constraints",
                    considered,
                )
        else:
            new_map = surv + candidates[:lost]
            remaining = candidates[lost:]
        added = 0
        if require_target:
            # Min-parity feasibility over the candidate mapping; dynamic
            # schedulers may keep buying parity nodes until Eq. 3 holds.
            # The full-N probability table is computed once; growth steps
            # append the single new entry instead of re-slicing O(N).
            fail_probs = self._fail_probs(item.delta_t_days, ctx)
            probs = fail_probs[new_map]
            while True:
                mp = self._min_parity(probs, item.reliability_target, ctx)
                if 0 <= mp <= placement.p + added:
                    break
                if not allow_parity_growth or not remaining:
                    return infeasible(
                        "reliability target unreachable after failure",
                        considered,
                    )
                if constraints is not None and not constraints.unconstrained:
                    nxt = self._pop_admissible(new_map, remaining, constraints)
                    if nxt is None:
                        return infeasible(
                            "reliability target unreachable within "
                            "failure-domain constraints",
                            considered,
                        )
                else:
                    nxt = remaining.pop(0)
                new_map.append(nxt)
                probs = np.append(probs, fail_probs[nxt])
                added += 1
        new_nodes = tuple(n for n in new_map if n not in surv)
        return RepairPlan(
            item.item_id,
            Placement(
                k=placement.k, p=placement.p + added, node_ids=tuple(new_map)
            ),
            tuple(surv),
            new_nodes,
            added,
            chunk,
            considered,
            "",
        )

    # -- failure-domain constraint selection ----------------------------------

    def _admissible(
        self, node: int, chosen: list[int], c: PlacementConstraints
    ) -> bool:
        """Would adding ``node`` keep every capped domain within its cap?"""
        cluster = self.cluster
        for axis, cap in (
            (cluster.rack, c.max_per_rack),
            (cluster.zone, c.max_per_zone),
        ):
            if cap is None:
                continue
            d = int(axis[node])
            if sum(1 for i in chosen if int(axis[i]) == d) + 1 > cap:
                return False
        return True

    def _pop_admissible(
        self, chosen: list[int], remaining: list[int], c: PlacementConstraints
    ) -> Optional[int]:
        for idx, cand in enumerate(remaining):
            if self._admissible(cand, chosen, c):
                return remaining.pop(idx)
        return None

    def _select_constrained(
        self,
        surv: list[int],
        candidates: list[int],
        lost: int,
        n_final: int,
        c: PlacementConstraints,
    ) -> tuple[Optional[list[int]], list[int]]:
        """Freest-first replacement selection under caps, preferring
        unrepresented domains while a spread width is unmet (racks
        first — they nest in zones, so widening racks usually widens
        zones for free)."""
        cluster = self.cluster
        chosen = list(surv)
        pool = list(candidates)
        need_r = min(c.min_racks, n_final)
        need_z = min(c.min_zones, n_final)
        for _ in range(lost):
            racks = {int(cluster.rack[i]) for i in chosen}
            zones = {int(cluster.zone[i]) for i in chosen}
            pick = None
            if len(racks) < need_r:
                pick = next(
                    (
                        cand
                        for cand in pool
                        if int(cluster.rack[cand]) not in racks
                        and self._admissible(cand, chosen, c)
                    ),
                    None,
                )
            if pick is None and len(zones) < need_z:
                pick = next(
                    (
                        cand
                        for cand in pool
                        if int(cluster.zone[cand]) not in zones
                        and self._admissible(cand, chosen, c)
                    ),
                    None,
                )
            if pick is None:
                pick = next(
                    (
                        cand
                        for cand in pool
                        if self._admissible(cand, chosen, c)
                    ),
                    None,
                )
            if pick is None:
                return None, pool
            chosen.append(pick)
            pool.remove(pick)
        return chosen, pool

    # -- shared-kernel shims (context-optional) -------------------------------

    def _fail_probs(self, delta_t_days: float, ctx) -> np.ndarray:
        if ctx is not None:
            return ctx.fail_probs(self.cluster, delta_t_days)
        return self.cluster.fail_probs(delta_t_days)

    @staticmethod
    def _min_parity(probs: np.ndarray, target: float, ctx) -> int:
        if ctx is not None:
            return ctx.min_parity(probs, target)
        mp = min_parity_for_target(probs, target)
        return -1 if mp is None else int(mp)
