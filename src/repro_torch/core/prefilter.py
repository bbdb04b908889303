"""Top-M candidate pre-filter for the batched placement scorers.

Host numpy, copied from the JAX package's ``core/prefilter.py`` so that
the filtered slices, and with them the decisions, are the reference's.

At 10k+ nodes the kernels' cost is dominated by padding and scoring over
*all* N live nodes even though every scheduler's choice rule only ever
reads a short freest-first prefix.  This module centralizes the
pre-filter contract: per batch, the top-M live nodes by the scheduler's
own sort key (free space, descending — the order ``_live_sorted``
already produces) are handed to the kernel and the remaining N-M nodes
are never materialized into kernel inputs, so decision cost scales with
M, not N.

Losslessness is *per scheduler*, proved from the choice rule plus the
parity-frontier monotonicity lemma (min feasible parity is weakly
increasing in freest-first prefix length — ``reliability.ParityFrontier``):

* **D-Rex SC** (``sc_cap``): window enumeration is start-major under a
  fixed candidate budget; whenever L-1 >= budget only windows inside the
  first ``budget + 1`` sorted nodes are enumerated at all, so slicing to
  M >= budget + 1 is *always* exact.  The only full-L dependence —
  the ``1/L`` / ``log L`` saturation scale — is threaded through as the
  true live count (``score_windows_batch(..., n_live=L)``).
* **D-Rex LB**: the (K, P) grid over the top-M prefix finds the same
  smallest feasible P and min-penalty K as the full grid whenever
  ``mp_eff(M) > P_found``, where ``mp_eff(M)`` is the min parity of the
  full M-prefix (the frontier's ``-1`` sentinel means "more parity than
  nodes", i.e. ``mp_eff = M``): monotonicity then makes every window
  wider than M infeasible at P <= P_found, so nothing outside the prefix
  could have been chosen.  Rows failing the test fall back to the
  unfiltered kernel — exactness is unconditional, the filter is purely
  a fast path.
* **GreedyLeastUsed**: the rule takes the *first* feasible N of a
  freest-first scan, so its existing ``SCAN_CAP`` prefix IS the
  pre-filter; a capped scan that finds nothing falls back to the scalar
  oracle over full L.
* **GreedyMinStorage** is *not* prefix-filterable: its objective
  ``(size/K) * N`` can keep improving as N grows (K grows with N), so a
  top-M slice can change the argmin.  It is counted ``bypassed`` and
  always scores unfiltered.

Caps are :mod:`repro_torch.core.shapes` rungs so filtered shapes land on
the same bucketed pads as everything else.

Process-wide hit-rate telemetry (``stats()``) is thread-safe, mirroring
``shapes.ShapeBucketer``'s locking discipline; ``chip_smoke.py`` prints
it beside the decisions-at-scale timings.
"""

from __future__ import annotations

import threading

import numpy as np

from . import shapes

__all__ = [
    "sc_cap",
    "lb_cap",
    "domain_slice",
    "record",
    "stats",
    "reset_stats",
    "LB_CAP_DEFAULT",
]

#: Default top-M target for D-Rex LB's filtered grid, rounded up to a
#: shapes rung by :func:`lb_cap`; at or below that many live nodes the
#: filter never engages.
LB_CAP_DEFAULT = 256

_EVENTS = ("engaged", "accepted", "fallback", "bypassed", "promoted")

_lock = threading.Lock()
_counters: dict[str, dict[str, int]] = {}


def sc_cap(budget: int) -> int:
    """Top-M cap sufficient for D-Rex SC's start-major window enumeration
    under ``budget`` candidate mappings (see module docstring): any
    M >= budget + 1 is exact, rounded up to a shapes rung for pad reuse."""
    return shapes.rung(budget + 1)


def lb_cap() -> int:
    """Default top-M cap for D-Rex LB (``LB_CAP_DEFAULT`` rounded up to
    a shapes rung so the filtered grid lands on a bucketed pad)."""
    return shapes.rung(LB_CAP_DEFAULT)


def domain_slice(
    order: np.ndarray,
    rack: np.ndarray,
    zone: np.ndarray,
    m: int,
    constraints,
    scheduler: str | None = None,
) -> np.ndarray:
    """Top-``m`` slice of a sorted candidate order with per-domain
    representatives: the slice keeps at least one node from enough
    distinct racks/zones to meet the spread width of ``constraints``
    (when the full order can), so the top-M pre-filter cannot starve a
    spread constraint into the engine's swap post-pass.

    Greedy and deterministic: first pick the earliest occurrence of each
    of the first ``min(min_racks, m)`` distinct racks (then zones, while
    slots remain), then fill with the earliest unpicked nodes.  The
    result is sorted by original position — a *subsequence* of ``order``,
    so a free-descending input stays free-descending and window/prefix
    capacity logic downstream stays valid.  When the plain ``order[:m]``
    slice already spans enough domains, the result is exactly that slice
    (bit-identical fast path); promotions are counted under the
    ``promoted`` telemetry event.
    """
    order = np.asarray(order)
    length = order.shape[0]
    if length <= m or constraints is None:
        return order
    need_r = min(int(constraints.min_racks), m)
    need_z = min(int(constraints.min_zones), m)
    if need_r <= 1 and need_z <= 1:
        return order[:m]
    picked: list[int] = []          # positions in `order`
    picked_set: set[int] = set()
    for axis, need in ((rack, need_r), (zone, need_z)):
        seen: set[int] = {int(axis[order[pos]]) for pos in picked}
        pos = 0
        while len(seen) < need and pos < length and len(picked) < m:
            d = int(axis[order[pos]])
            if d not in seen:
                seen.add(d)
                if pos not in picked_set:
                    picked.append(pos)
                    picked_set.add(pos)
            pos += 1
    pos = 0
    while len(picked) < m:
        if pos not in picked_set:
            picked.append(pos)
            picked_set.add(pos)
        pos += 1
    picked.sort()
    n_promoted = sum(1 for pos in picked if pos >= m)
    if n_promoted and scheduler is not None:
        record(scheduler, "promoted", n_promoted)
    if not n_promoted:
        return order[:m]
    return order[np.asarray(picked, dtype=np.int64)]


def record(scheduler: str, event: str, n: int = 1) -> None:
    """Count ``n`` items against ``event`` for ``scheduler``.

    Events: ``engaged`` (item scored through the filtered path),
    ``accepted`` (filtered decision provably exact), ``fallback`` (item
    re-scored unfiltered after the sufficiency test failed), ``bypassed``
    (scheduler's rule is not prefix-filterable, or too few nodes)."""
    if event not in _EVENTS:
        raise ValueError(f"unknown prefilter event {event!r}")
    if n <= 0:
        return
    with _lock:
        per = _counters.setdefault(scheduler, dict.fromkeys(_EVENTS, 0))
        per[event] += int(n)


def stats() -> dict[str, dict[str, int]]:
    """Snapshot of per-scheduler counters (copies; safe to mutate)."""
    with _lock:
        return {name: dict(per) for name, per in _counters.items()}


def reset_stats() -> None:
    with _lock:
        _counters.clear()
