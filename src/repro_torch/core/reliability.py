"""Reliability model of D-Rex (paper §3.1).

Implements:
  * ``pr_failure`` — Eq. (1): probability of a node failing at least once
    over ``delta_t`` (a fraction of a year), given a constant annual
    failure rate ``lambda_rate`` (homogeneous Poisson process).
  * ``poisson_binomial_cdf`` — Eq. (2): probability that at most ``P`` of
    the nodes in a mapping fail, i.e. the Poisson-binomial CDF at ``P``.
    Exact O(N*(P+1)) dynamic-programming convolution plus the refined
    normal approximation (RNA) of Hong (2013), which is what the paper's
    implementation approximates with.
  * ``pr_avail`` — availability of an item with ``P`` parity chunks on a
    mapping, and the reliability constraint check of Eq. (3).

All entry points are numpy/float64 (the online scheduler is sequential
control-plane code), copied from the JAX package so that every oracle
keeps its own summation order: the port's placements are held equal to
the reference's, and those orders decide ties at ulp distance.
"""

from __future__ import annotations

import math
from typing import Iterable, Literal, Sequence

import numpy as np

__all__ = [
    "pr_failure",
    "poisson_binomial_cdf",
    "pr_avail",
    "meets_target",
    "max_parity_needed",
    "min_parity_for_target",
    "parity_frontier",
    "rna_parity_frontier",
    "ParityFrontier",
]

_SQRT2PI = math.sqrt(2.0 * math.pi)

# Exact DP is used below this mapping size under method="auto"; RNA above.
_AUTO_EXACT_LIMIT = 64

Method = Literal["exact", "rna", "auto"]


def pr_failure(annual_failure_rate, delta_t_years):
    """Eq. (1): ``1 - exp(-lambda * dt)`` — elementwise on numpy arrays.

    ``annual_failure_rate`` is the Poisson rate per year (the Backblaze
    AFR is treated as this rate, per the paper); ``delta_t_years`` is the
    retention window expressed as a fraction of a year.
    """
    lam = np.asarray(annual_failure_rate, dtype=np.float64)
    dt = np.asarray(delta_t_years, dtype=np.float64)
    if np.any(lam < 0.0):
        raise ValueError("annual failure rate must be >= 0")
    if np.any(dt < 0.0):
        raise ValueError("delta_t must be >= 0")
    return -np.expm1(-lam * dt)


def _exact_cdf(p: np.ndarray, k: int) -> float:
    """Exact Poisson-binomial ``Pr(X <= k)`` via DP over failure probs.

    ``dp[j]`` holds ``Pr(X == j)`` over the prefix of trials processed so
    far, truncated at ``j <= k`` (probability mass above k is not needed
    for the CDF at k). O(N*(k+1)) time, O(k+1) space, stable in float64
    (all terms are nonnegative; no cancellation).
    """
    dp = np.zeros(k + 1, dtype=np.float64)
    dp[0] = 1.0
    for pi in p:
        q = 1.0 - pi
        # dp_new[j] = dp[j]*q + dp[j-1]*pi ; done in-place right-to-left.
        upper = k
        dp[1 : upper + 1] = dp[1 : upper + 1] * q + dp[:upper] * pi
        dp[0] *= q
    return float(min(1.0, dp.sum()))


def _rna_cdf_from_moments(mu: float, sigma: float, gamma: float, k: int) -> float:
    """Hong (2013) eq. 10 probe with the distribution moments precomputed
    — the one place the RNA formula lives (callers: :func:`_rna_cdf` per
    mapping, :func:`rna_parity_frontier` per prefix)."""
    x = (k + 0.5 - mu) / sigma
    phi = math.exp(-0.5 * x * x) / _SQRT2PI
    big_phi = 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    val = big_phi + gamma * (1.0 - x * x) * phi / 6.0
    return float(min(1.0, max(0.0, val)))


def _rna_cdf(p: np.ndarray, k: int) -> float:
    """Refined normal approximation (Hong 2013, eq. 10) to Pr(X <= k).

    Adds a skewness correction to the plain CLT approximation; accurate to
    ~1e-3 absolute for the N >= 10 regimes the paper's scheduler explores,
    and monotone enough for threshold checks. Falls back to exact for
    degenerate spreads (sigma == 0).
    """
    mu = float(p.sum())
    var = float((p * (1.0 - p)).sum())
    if var <= 0.0:
        # All-deterministic trials: X == mu exactly.
        return 1.0 if k >= round(mu) else 0.0
    sigma = math.sqrt(var)
    gamma = float((p * (1.0 - p) * (1.0 - 2.0 * p)).sum()) / (sigma**3)
    return _rna_cdf_from_moments(mu, sigma, gamma, k)


def poisson_binomial_cdf(
    fail_probs: Iterable[float], k: int, method: Method = "auto"
) -> float:
    """``Pr(X <= k)`` where ``X = sum Bernoulli(fail_probs_i)`` (Eq. 2)."""
    p = np.asarray(list(fail_probs) if not isinstance(fail_probs, np.ndarray) else fail_probs, dtype=np.float64)
    if p.ndim != 1:
        raise ValueError("fail_probs must be one-dimensional")
    if np.any((p < 0.0) | (p > 1.0)):
        raise ValueError("fail probabilities must lie in [0, 1]")
    n = p.shape[0]
    if k < 0:
        return 0.0
    if k >= n:
        return 1.0
    if method == "exact" or (method == "auto" and n <= _AUTO_EXACT_LIMIT):
        return _exact_cdf(p, k)
    if method in ("rna", "auto"):
        return _rna_cdf(p, k)
    raise ValueError(f"unknown method {method!r}")


def pr_avail(
    node_fail_probs: Iterable[float], parity: int, method: Method = "auto"
) -> float:
    """Availability of an item with ``parity`` parity chunks on a mapping.

    ``node_fail_probs[i]`` is ``pr_failure`` of the i-th node in the
    mapping over the item's retention window. The item survives iff at
    most ``parity`` of the mapped nodes fail.
    """
    return poisson_binomial_cdf(node_fail_probs, parity, method=method)


def meets_target(
    node_fail_probs: Iterable[float],
    parity: int,
    target: float,
    method: Method = "auto",
) -> bool:
    """Reliability constraint (Eq. 3): ``pr_avail >= RT(d)``."""
    return pr_avail(node_fail_probs, parity, method=method) >= target


class ParityFrontier:
    """Incremental Poisson-binomial frontier over a *prefix-structured*
    node sequence: for every prefix length ``n`` of ``fail_probs``, the
    smallest parity ``P`` (in ``[0, n-1]``) whose availability CDF meets
    ``target``, or ``-1`` if no such P exists.

    This is the one DP the prefix-greedy schedulers (GreedyLeastUsed,
    D-Rex LB, D-Rex SC windows) all need: they sort the live nodes once
    and ask "what is the minimum parity for the first ``n`` nodes?" for
    growing ``n``.  The DP state is shared across all prefixes and
    extended lazily, so a scheduler that stops at ``n = 3`` pays
    ``O(3^2)``, not ``O(L^2)`` — and a batch of items with an unchanged
    sort order pays for the DP once (see
    :meth:`repro_torch.core.engine.BatchContext.frontier`).
    """

    __slots__ = ("probs", "target", "_dp", "_n", "_j", "_out")

    def __init__(self, fail_probs, target: float):
        self.probs = np.asarray(fail_probs, dtype=np.float64)
        self.target = float(target)
        self._dp = np.zeros(self.probs.shape[0] + 1, dtype=np.float64)
        self._dp[0] = 1.0
        self._n = 0
        self._j = 0  # unbounded min parity of the current prefix
        self._out = np.full(self.probs.shape[0], -1, dtype=np.int64)

    def __len__(self) -> int:
        return int(self.probs.shape[0])

    def upto(self, n: int) -> np.ndarray:
        """Extend the DP through prefix length ``n``; returns the frontier
        array (entries past ``n`` are only valid once computed)."""
        dp, out, probs, target = self._dp, self._out, self.probs, self.target
        while self._n < n:
            i = self._n
            pi = probs[i]
            dp[1 : i + 2] = dp[1 : i + 2] * (1.0 - pi) + dp[: i + 1] * pi
            dp[0] *= 1.0 - pi
            self._n = i + 1
            # Adding a node can only lower the CDF at fixed P, so the min
            # parity is weakly increasing in the prefix length: resume the
            # scan from the previous prefix's value instead of a cumsum.
            j = self._j
            cdf = float(dp[: j + 1].sum())
            while cdf < target and j <= i:
                j += 1
                cdf += float(dp[j])
            self._j = j
            if j <= i:  # P is capped at n-1 (at least one data chunk)
                out[i] = j
        return out

    def min_parity(self, n: int) -> int:
        """Min parity for the first ``n`` nodes; ``-1`` if infeasible."""
        if n < 1 or n > len(self):
            return -1
        return int(self.upto(n)[n - 1])

    def upto_many(
        self, n_starts: int | None = None, nmax: int | None = None
    ) -> np.ndarray:
        """Batch variant of :meth:`upto` over *suffix starts*.

        ``out[s, m]`` is the smallest parity meeting ``target`` for the
        window ``probs[s : s + m + 1]`` (the length-``m+1`` prefix of the
        suffix starting at ``s``), or ``-1`` when infeasible or out of
        range.  One masked Poisson-binomial DP advances every suffix's
        distribution in lockstep, answering every ``(start,
        window-length)`` pair in ``O(n_starts * L^2)`` instead of one
        fresh DP per start.  This is the numpy reference twin of the
        JAX package's device DP for D-Rex SC's window enumeration: the property tests cross-check it against
        brute-force enumeration and against :meth:`upto`, pinning both
        implementations of the suffix-frontier recurrence.

        ``n_starts`` bounds the suffix starts (default: every start);
        ``nmax`` bounds the window length (default: unbounded).
        """
        L = len(self)
        S = L if n_starts is None else max(0, min(int(n_starts), L))
        W = L if nmax is None else max(0, min(int(nmax), L))
        out = np.full((S, W), -1, dtype=np.int64)
        if S == 0 or W == 0:
            return out
        starts = np.arange(S)
        dp = np.zeros((S, L + 1), dtype=np.float64)
        dp[:, 0] = 1.0
        rows = np.arange(S)
        for i in range(min(L, S - 1 + W)):
            pi = self.probs[i]
            # Window [s..i] exists once i >= s and stays within nmax.
            active = (starts <= i) & (i - starts < W)
            nd = dp * (1.0 - pi)
            nd[:, 1:] += dp[:, :-1] * pi
            dp = np.where(active[:, None], nd, dp)
            cdf = np.cumsum(dp, axis=1)
            feas = cdf >= self.target
            j = np.argmax(feas, axis=1)
            n_len = i - starts + 1
            ok = active & feas.any(axis=1) & (j <= n_len - 1)
            out[rows[ok], (i - starts)[ok]] = j[ok]
        return out


def parity_frontier(sorted_fail_probs, target: float) -> np.ndarray:
    """Vectorized one-pass frontier: ``out[n-1]`` is the min parity for
    the length-``n`` prefix of ``sorted_fail_probs`` (``-1`` infeasible).

    One exact Poisson-binomial DP over the whole sequence answers the
    feasibility question for *every* prefix — the primitive previously
    re-derived inline by GreedyLeastUsed, D-Rex LB and D-Rex SC.
    """
    fr = ParityFrontier(sorted_fail_probs, target)
    return fr.upto(len(fr)).copy()


def min_parity_for_target(
    node_fail_probs: Sequence[float], target: float, method: Method = "auto"
) -> int | None:
    """Smallest ``P`` such that the mapping meets ``target``; None if even
    P = N-1 (i.e. only one chunk must survive) is insufficient.

    Computes the DP once and reads off all CDF values, instead of one DP
    per candidate P — O(N^2) total instead of O(N^3).  (This is the
    whole-sequence special case of :func:`parity_frontier`, kept one-shot
    because non-prefix-structured callers never reuse intermediate
    prefixes.)
    """
    p = np.asarray(node_fail_probs, dtype=np.float64)
    n = p.shape[0]
    if n == 0:
        return None
    if method == "exact" or (method == "auto" and n <= _AUTO_EXACT_LIMIT):
        dp = np.zeros(n + 1, dtype=np.float64)
        dp[0] = 1.0
        for pi in p:
            dp[1:] = dp[1:] * (1.0 - pi) + dp[:-1] * pi
            dp[0] *= 1.0 - pi
        cdf = np.cumsum(dp)
        feas = np.nonzero(cdf[:n] >= target)[0]  # P can be at most n-1
        return int(feas[0]) if feas.size else None
    for parity in range(n):
        if _rna_cdf(p, parity) >= target:
            return parity
    return None


def rna_parity_frontier(
    sorted_fail_probs, target: float, n_lo: int, n_hi: int
) -> np.ndarray:
    """Min parity per prefix length under the RNA regime, moments hoisted.

    ``out[i]`` is the smallest parity whose refined-normal-approximation
    CDF meets ``target`` for the length-``n_lo + i`` prefix of
    ``sorted_fail_probs`` (``-1`` infeasible) — bit-for-bit identical to
    calling :func:`min_parity_for_target` per prefix in its ``auto``
    regime above ``_AUTO_EXACT_LIMIT`` (same elementwise products, same
    pairwise prefix summations, the shared :func:`_rna_cdf_from_moments`
    probe in the same scan order), but the O(n) moment sums are computed
    once per prefix instead of once per parity probe.  This is the
    host-side half of the GreedyMinStorage decision path
    (:mod:`repro_torch.core.greedy_kernel`): device transcendentals differ
    from libm in ulps, so the approximation regime stays on the CPU.
    """
    p = np.asarray(sorted_fail_probs, dtype=np.float64)
    w = p * (1.0 - p)
    g = w * (1.0 - 2.0 * p)
    n_lo = max(1, n_lo)
    out = np.full(max(0, n_hi - n_lo + 1), -1, dtype=np.int64)
    for i, n in enumerate(range(n_lo, n_hi + 1)):
        mu = float(p[:n].sum())
        var = float(w[:n].sum())
        if var <= 0.0:
            # All-deterministic trials: X == mu exactly (cf. _rna_cdf).
            for k in range(n):
                if (1.0 if k >= round(mu) else 0.0) >= target:
                    out[i] = k
                    break
            continue
        sigma = math.sqrt(var)
        gamma = float(g[:n].sum()) / (sigma**3)
        for k in range(n):
            if _rna_cdf_from_moments(mu, sigma, gamma, k) >= target:
                out[i] = k
                break
    return out


def max_parity_needed(target: float, worst_fail_prob: float) -> int:
    """Upper bound on parity ever useful: with i.i.d. ``worst_fail_prob``
    nodes, the number of failures concentrates at ``N*p``; beyond
    ``ceil(log(1-target)/log(p))`` extra parity the marginal availability
    gain is below float precision. Used to bound scheduler loops."""
    if worst_fail_prob <= 0.0:
        return 0
    if worst_fail_prob >= 1.0:
        return 10**9
    return max(1, math.ceil(math.log(max(1e-300, 1.0 - target)) / math.log(worst_fail_prob)))
