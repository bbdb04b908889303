"""A frozen numpy copy of the D-Rex SC oracle (paper §4.4, Algorithm 2).

Plain float64 numpy, written out from the paper's algorithm as the
port's scalar oracle states it, so that the benchmark judges the
program's placements with code the program cannot change:

* Eq. 1: ``pr_failure = 1 - exp(-afr * dt)``, dt in years of 365.25 days;
* the prefix Poisson-binomial frontier (Eq. 2-3): for every prefix of the
  free-descending node order, the least parity whose availability meets
  the target;
* Algorithm 2: the first ``2**10`` contiguous windows of that order,
  start-major, each scored on (duration, storage, saturation), the
  Pareto front, and the saturation-weighted score of line 17.

Nothing here imports the program.  ``dtype`` selects the precision the
whole decision is computed in: float64 is the reference, float32 the
control that the comparison must catch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "DAYS_PER_YEAR",
    "MAX_MAPPINGS",
    "Cluster",
    "Decision",
    "pr_failure",
    "prefix_frontier",
    "pr_avail_exact",
    "place",
    "frontier_dp_ops",
]

DAYS_PER_YEAR = 365.25
#: Algorithm 2, line 2: candidate mappings scored per item.
MAX_MAPPINGS = 2**10
#: the linear encode/decode time model of §4.4 (e0, e_byte, e_mult, d0,
#: d_byte, d_mult): seconds, seconds per MB, seconds per coded MB.
TIME_MODEL = (1e-3, 2.0e-4, 1.2e-3, 1e-3, 2.0e-4, 1.2e-3)

REJECT_FEW = "fewer than 2 live nodes"
REJECT_NONE = "no mapping satisfies reliability+capacity"


@dataclass
class Cluster:
    """Node arrays as the benchmark made them (MB, MB/s, rates a year)."""

    capacity_mb: np.ndarray
    used_mb: np.ndarray
    write_bw: np.ndarray
    read_bw: np.ndarray
    afr: np.ndarray
    alive: np.ndarray

    def copy(self) -> "Cluster":
        return Cluster(*(np.array(a, copy=True) for a in (
            self.capacity_mb, self.used_mb, self.write_bw, self.read_bw,
            self.afr, self.alive)))


@dataclass(frozen=True)
class Decision:
    """(K, P, node ids), or a rejection with its reason."""

    k: int
    p: int
    node_ids: tuple
    reason: str = ""

    @property
    def ok(self) -> bool:
        return not self.reason


def pr_failure(afr, delta_t_days: float, dtype=np.float64) -> np.ndarray:
    """Eq. 1 over a retention window given in days."""
    lam = np.asarray(afr, dtype=dtype)
    return -np.expm1(-lam * dtype(delta_t_days / DAYS_PER_YEAR))


def prefix_frontier(probs: np.ndarray, target: float, nmax: int, dtype=np.float64) -> np.ndarray:
    """``out[n-1]``: least parity P in [0, n-1] with Pr(at most P of the
    first n nodes fail) >= target, or -1 if none (Eq. 2-3)."""
    probs = np.asarray(probs, dtype=dtype)
    one = dtype(1.0)
    target = dtype(target)
    dp = np.zeros(nmax + 1, dtype=dtype)
    dp[0] = one
    out = np.full(nmax, -1, dtype=np.int64)
    j = 0
    for i in range(nmax):
        pi = probs[i]
        dp[1 : i + 2] = dp[1 : i + 2] * (one - pi) + dp[: i + 1] * pi
        dp[0] *= one - pi
        # the least parity is weakly increasing in the prefix length
        cdf = dp[: j + 1].sum(dtype=dtype)
        while cdf < target and j <= i:
            j += 1
            cdf = dtype(cdf + dp[j])
        if j <= i:
            out[i] = j
    return out


def pr_avail_exact(probs: Sequence[float], parity: int) -> float:
    """Pr(at most ``parity`` of these nodes fail), exact Poisson-binomial."""
    p = np.asarray(probs, dtype=np.float64)
    if parity >= len(p):
        return 1.0
    dp = np.zeros(parity + 1, dtype=np.float64)
    dp[0] = 1.0
    for pi in p:
        dp[1:] = dp[1:] * (1.0 - pi) + dp[:-1] * pi
        dp[0] *= 1.0 - pi
    return float(min(1.0, dp.sum()))


def saturation(used, cap, smin: float, n_live: int, dtype=np.float64) -> np.ndarray:
    """Alg. 2 line 11: the exponential through (smin, 1/L) and (cap, 1)."""
    cap = np.asarray(cap, dtype=dtype)
    x = np.asarray(used, dtype=dtype)
    span = np.maximum(cap - dtype(smin), dtype(1e-9))
    u = np.clip((x - dtype(smin)) / span, dtype(0.0), dtype(1.0))
    n = max(2, n_live)
    return np.clip(dtype(1.0 / n) * np.exp(dtype(math.log(n)) * u), dtype(0.0), dtype(1.0))


def _pareto_keep(obj: np.ndarray) -> np.ndarray:
    m, d = obj.shape
    le = np.ones((m, m), dtype=bool)
    lt = np.zeros((m, m), dtype=bool)
    for col in range(d):
        c = obj[:, col]
        le &= c[None, :] <= c[:, None]
        lt |= c[None, :] < c[:, None]
    keep = ~np.any(le & lt, axis=1)
    if not np.any(keep):
        keep[:] = True
    return keep


def _progress(vals: np.ndarray) -> np.ndarray:
    lo, hi = vals.min(), vals.max()
    if float(hi) - float(lo) <= 1e-12:
        return np.zeros_like(vals)
    return (hi - vals) / (hi - lo)


def free_desc_order(cluster: Cluster) -> np.ndarray:
    """Live node ids by free space, descending; ties by node id."""
    live = np.nonzero(cluster.alive)[0]
    free = cluster.capacity_mb - cluster.used_mb
    return live[np.argsort(-free[live], kind="stable")]


def place(
    cluster: Cluster,
    size_mb: float,
    target: float,
    delta_t_days: float,
    smin_mb: Optional[float],
    dtype=np.float64,
) -> Decision:
    """One D-Rex SC decision for an item of ``size_mb`` against ``cluster``.

    ``smin_mb`` is the smallest item size seen so far, this item
    included."""
    order = free_desc_order(cluster)
    L = len(order)
    if L < 2:
        return Decision(0, 0, (), REJECT_FEW)
    f = lambda a: np.asarray(a, dtype=dtype)  # noqa: E731
    e0, e_byte, e_mult, d0, d_byte, d_mult = (dtype(v) for v in TIME_MODEL)
    fail = pr_failure(cluster.afr, delta_t_days, dtype)[order]
    cap_all, used_all = f(cluster.capacity_mb), f(cluster.used_mb)
    free_s = (cap_all - used_all)[order]
    wb_s, rb_s = f(cluster.write_bw)[order], f(cluster.read_bw)[order]
    used_s, cap_s = used_all[order], cap_all[order]
    smin = smin_mb if smin_mb is not None else 1.0
    size = dtype(size_mb)
    live = np.nonzero(cluster.alive)[0]
    f_base = saturation(used_all[live], cap_all[live], smin, L, dtype).sum(dtype=dtype)
    sys_sat = saturation(
        np.array([used_all[live].sum(dtype=dtype)]),
        np.array([cap_all[live].sum(dtype=dtype)]), smin, L, dtype)[0]

    cols = []
    budget = MAX_MAPPINGS
    for s in range(L - 1):
        if budget <= 0:
            break
        n_wins = min(L - s - 1, budget)
        budget -= n_wins
        nmax = n_wins + 1
        fr = prefix_frontier(fail[s:], target, nmax, dtype)
        n_arr = np.arange(2, nmax + 1)
        mp = fr[1:nmax]
        p_star = np.maximum(1, mp)
        k = n_arr - p_star
        valid = (mp >= 0) & (k >= 1)
        if not np.any(valid):
            continue
        k_safe = np.where(valid, k, 1)
        chunk = size / k_safe.astype(dtype)
        valid &= free_s[s + n_arr - 1] >= chunk
        if not np.any(valid):
            continue
        wb_min = np.minimum.accumulate(wb_s[s : s + nmax])[n_arr - 1]
        rb_min = np.minimum.accumulate(rb_s[s : s + nmax])[n_arr - 1]
        enc = np.where(k_safe == 1, e0,
                       e0 + e_byte * size + e_mult * (n_arr - k_safe).astype(dtype) * size)
        dec = np.where(k_safe == 1, d0, d0 + d_byte * size + d_mult * k_safe.astype(dtype) * size)
        duration = chunk / wb_min + chunk / rb_min + enc + dec
        storage = chunk * n_arr.astype(dtype)
        u, c = used_s[s : s + nmax], cap_s[s : s + nmax]
        delta = (saturation(u[None, :] + chunk[:, None], c[None, :], smin, L, dtype)
                 - saturation(u, c, smin, L, dtype)[None, :])
        in_window = np.arange(nmax)[None, :] < n_arr[:, None]
        sat = f_base + (delta * in_window).sum(axis=1, dtype=dtype)
        cols.append(np.stack([
            np.full(int(valid.sum()), s, dtype=dtype), n_arr[valid].astype(dtype),
            k[valid].astype(dtype), p_star[valid].astype(dtype),
            duration[valid], storage[valid], sat[valid]], axis=1))
    if not cols:
        return Decision(0, 0, (), REJECT_NONE)
    cands = np.concatenate(cols, axis=0)
    front = cands[_pareto_keep(cands[:, 4:7])]
    score = ((dtype(1.0) - sys_sat) * _progress(front[:, 4])
             + (_progress(front[:, 5]) + _progress(front[:, 6])) / dtype(2.0))
    best = front[int(np.argmax(score))]
    s_b, n_b = int(best[0]), int(best[1])
    return Decision(int(best[2]), int(best[3]), tuple(int(x) for x in order[s_b : s_b + n_b]))


def frontier_dp_ops(n_live: int) -> float:
    """Float64 operations of the frontier DP as the oracle defines it for
    one decision over ``n_live`` live nodes: per start s and prefix step
    i, 3 per distribution entry updated (i + 2 of them: two products and
    a sum), one for ``1 - p`` and one add for the scan.  Starts run until
    the 2**10 candidate windows are spent."""
    ops = 0.0
    budget = MAX_MAPPINGS
    for s in range(max(0, n_live - 1)):
        if budget <= 0:
            break
        n_wins = min(n_live - s - 1, budget)
        budget -= n_wins
        nmax = n_wins + 1
        i = np.arange(nmax, dtype=np.float64)
        ops += float((3.0 * (i + 2.0) + 2.0).sum())
    return ops
