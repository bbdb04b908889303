"""Host half of the greedy baselines' decision path (paper §4.1-4.2).

The JAX package's ``core/greedy_kernel.py`` scores the greedy baselines
as jitted device programs and takes the refined-normal-approximation
frontier rows as host inputs.  Only that host part is ported here: the
placement engine's :class:`~repro_torch.core.engine.BatchContext`
memoizes these rows (``BatchContext.rna_frontier``).  The device scorers
and the greedy schedulers themselves come in a later slice.
"""

from __future__ import annotations

import numpy as np

from .reliability import _AUTO_EXACT_LIMIT, rna_parity_frontier

__all__ = ["rna_frontier_row"]


def rna_frontier_row(fail_sorted: np.ndarray, target: float, L: int) -> np.ndarray:
    """Host-side min-parity frontier for prefixes beyond the exact-DP limit.

    ``out[n]`` is the minimum parity for the length-``n`` prefix of
    ``fail_sorted`` (``-1`` infeasible), computed for
    ``n in (_AUTO_EXACT_LIMIT, L]`` exactly as the scalar oracle's
    :func:`min_parity_for_target` would under ``method="auto"`` (Hong's
    RNA with libm transcendentals; see
    :func:`repro_torch.core.reliability.rna_parity_frontier`).
    """
    out = np.full(L + 1, -1, dtype=np.int64)
    if L > _AUTO_EXACT_LIMIT:
        out[_AUTO_EXACT_LIMIT + 1 :] = rna_parity_frontier(
            fail_sorted, target, _AUTO_EXACT_LIMIT + 1, L
        )
    return out
