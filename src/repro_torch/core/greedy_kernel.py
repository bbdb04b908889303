"""The greedy baselines' batch scorers (paper §4.1-4.2) as float64 torch.

``GreedyMinStorage`` and ``GreedyLeastUsed`` score *prefixes of one
sorted node order*, so one masked DP answers every prefix: the per-prefix
Poisson-binomial parity frontier is one launch of the hand-written
kernel :func:`repro_torch.kernels.pb_frontier.frontier` with a single
start (the twin of ``ParityFrontier.upto_many(n_starts=1)``), capacity
checks become prefix-min tensors, and the whole scorer runs over a batch
of items sharing a cluster snapshot — which is what lets
``PlacementEngine.place_many`` drive both schedulers through
``place_batch``.  These are the JAX package's jitted
``_least_used_scores`` and ``_min_storage_scores``
(``src/repro/core/greedy_kernel.py:152,190``), ported op for op.

Two scheduler-specific wrinkles keep the scorers bit-for-bit equivalent
to the scalar numpy oracles (``place_scalar``), which remain the
reference:

* **GreedyMinStorage's RNA regime.**  The scalar path asks
  :func:`min_parity_for_target` with ``method="auto"``: exact DP for
  mappings of at most ``_AUTO_EXACT_LIMIT`` (64) nodes, Hong's refined
  normal approximation above.  The RNA uses libm ``erf``/``exp``, whose
  device counterparts differ in ulps, so the device computes the
  exact-DP region and takes the RNA frontiers as a *host-computed input
  tensor* (:func:`rna_frontier_row`, which calls the very same scalar
  code path).

* **GreedyMinStorage's capacity filter.**  The fixed point over K maps
  chunks onto the fastest nodes *among those with room*
  (``free >= size/K``).  While every node of the bw-sorted prefix fits
  (checked exactly via a prefix-min), the filtered mapping IS the prefix
  and the fixed point collapses to a closed form evaluated for every N
  at once.  Rows where the filter engages are flagged ``slow`` and
  finished on the host by the oracle's own per-N fixed point
  (``GreedyMinStorage._fixed_point_row``).

``GreedyLeastUsed`` needs neither: its frontier is always the exact DP
and its mapping is always the free-desc prefix.

**Failure-domain constraints.**  Under ``PlacementConstraints`` both
greedy schedulers hand these scorers the cap-admitted subsequence of
their own sorted orders; prefixes of an admitted order are subsets of a
cap-conforming set, so the scans are unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import pb_frontier

from . import shapes
from .reliability import _AUTO_EXACT_LIMIT, rna_parity_frontier

__all__ = ["kernel_available", "least_used_batch", "min_storage_batch", "rna_frontier_row"]


def kernel_available() -> bool:
    """True when the device scorer is built for this process: the
    ``pb_frontier`` kernel it launches has been compiled (or found
    compiled) and loaded, which its first launch on a card does.  The
    reference's counterpart says whether JAX imports."""
    return pb_frontier.loaded()


def rna_frontier_row(fail_sorted: np.ndarray, target: float, L: int) -> np.ndarray:
    """Host-side min-parity frontier for prefixes beyond the exact-DP limit.

    ``out[n]`` is the minimum parity for the length-``n`` prefix of
    ``fail_sorted`` (``-1`` infeasible), computed for
    ``n in (_AUTO_EXACT_LIMIT, L]`` exactly as the scalar oracle's
    :func:`min_parity_for_target` would under ``method="auto"`` (Hong's
    RNA with libm transcendentals; see
    :func:`repro_torch.core.reliability.rna_parity_frontier`).  The
    device scorer consumes this row verbatim for the approximation
    regime.  ``BatchContext.rna_frontier`` memoizes rows across the items
    and commit groups of a batch.
    """
    out = np.full(L + 1, -1, dtype=np.int64)
    if L > _AUTO_EXACT_LIMIT:
        out[_AUTO_EXACT_LIMIT + 1 :] = rna_parity_frontier(
            fail_sorted, target, _AUTO_EXACT_LIMIT + 1, L
        )
    return out


def _prefix_frontier(probs_b, target_b, L: int, width: int, n_steps: int):
    """Min parity of every prefix: ``out[b, i]`` for the length-``i+1``
    prefix, ``-1`` where infeasible, valid for ``i < n_steps`` (one
    kernel launch; the JAX package's ``_prefix_frontier``)."""
    probs = probs_b[:, :n_steps].contiguous()
    live = min(L, n_steps)
    shapes.record_compile(
        "pb_frontier", (probs.shape[0], 1, n_steps, live, width, probs.device.type)
    )
    return pb_frontier.frontier(probs, target_b, 1, live, width)[:, 0, :]


def _least_used_scores(L_pad: int, probs_b, size_b, target_b, free, L: int):
    """GreedyLeastUsed (Eq. 5): first N whose exact frontier admits
    ``K = N - max(1, P*) >= 2`` with the chunk fitting the prefix."""
    dev = probs_b.device
    n_arr = torch.arange(L_pad, device=dev) + 1
    mp = _prefix_frontier(probs_b, target_b, L, L_pad + 1, L_pad)
    p_star = torch.clamp(mp, min=1)
    k = n_arr - p_star
    k_safe = torch.clamp(k, min=1)
    chunk = size_b[:, None] / k_safe.to(torch.float64)
    feasible = (
        (n_arr >= 2)
        & (n_arr <= L)
        & (mp >= 0)
        & (k >= 2)
        & (free >= chunk)  # free-desc prefix: min free is node N-1
    )
    # First true: argmax over an integer cast (torch.argmax returns the
    # first maximal index; booleans are cast first, as CUDA needs).
    idx = torch.argmax(feasible.to(torch.int32), dim=1, keepdim=True)
    found = feasible.any(dim=1)
    zero = torch.zeros_like(idx[:, 0])
    return torch.stack([
        found.to(torch.int64),
        torch.where(found, n_arr[idx[:, 0]], zero),
        torch.where(found, k.gather(1, idx)[:, 0], zero),
        torch.where(found, p_star.gather(1, idx)[:, 0], zero),
    ])


def _min_storage_scores(
    L_pad: int,
    EXACT: int,
    probs_b,     # (B, L_pad) per-item fail probs in write-bw-desc order
    size_b,      # (B,)
    target_b,    # (B,)
    rna_b,       # (B, L_pad + 1): host RNA frontier, indexed by N
    free_bw,     # (L_pad,) free MB, write-bw-desc order (pad -1)
    L: int,
):
    """GreedyMinStorage (Eq. 4): the per-N fixed point over K in closed
    form wherever the bw-sorted prefix fits the chunk.  Returns per-(item,
    N) ``valid``/``slow``/``k``/``p``/``cost``, rows indexed by ``N - 1``."""
    dev = probs_b.device
    f64 = torch.float64
    i_idx = torch.arange(L_pad, device=dev)
    n_arr = i_idx + 1
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    fmin = torch.cummin(torch.where(i_idx < L, free_bw, inf), dim=0).values

    n_ex = min(L_pad, EXACT)
    mp_exact = _prefix_frontier(probs_b, target_b, L, n_ex + 1, n_ex)
    mp_exact = torch.cat(
        [mp_exact, mp_exact.new_full((mp_exact.shape[0], L_pad - n_ex), -1)], dim=1
    )
    # Frontier per prefix length N: exact DP for N <= EXACT, the
    # host-computed RNA row above (min_parity_for_target "auto").
    m_hat = torch.where(n_arr <= EXACT, mp_exact, rna_b[:, 1:])

    in_range = (n_arr >= 2) & (n_arr <= L)
    size = size_b[:, None]
    # first probe: K = N - 1 (the integer axis is cast to f64 first: an
    # int64 tensor minus a python float would promote to float32)
    chunk0 = size / (n_arr.to(f64) - 1.0)
    # Live nodes with free >= chunk0: the reference sums an (N, L) mask;
    # counting through the sorted live free values gives the same integer
    # in O(L log L) (count(f >= c) = L - count(f < c)).
    live_sorted = torch.sort(free_bw[:L]).values
    fitcnt0 = L - torch.searchsorted(live_sorted, chunk0.contiguous(), right=False)
    pfit0 = fmin >= chunk0               # whole prefix fits probe 1
    k1 = n_arr - m_hat                   # second probe: K = N - m_hat
    pfit1 = fmin >= size / torch.clamp(k1, min=1).to(f64)

    # Probe 1 accepts immediately when min parity is already <= 1;
    # otherwise the fixed point re-probes at K = N - m_hat, where an
    # unchanged (still-prefix) mapping reproduces m_hat and accepts.
    acc1 = pfit0 & (m_hat >= 0) & (m_hat <= 1)
    deeper = pfit0 & (m_hat >= 2) & (k1 >= 1)
    acc2 = deeper & pfit1
    fits = in_range & (fitcnt0 >= n_arr)
    valid = fits & (acc1 | acc2)
    slow = fits & ((~pfit0) | (deeper & ~pfit1))
    k = torch.where(acc1, n_arr - 1, k1)
    p = torch.where(acc1, 1, m_hat)
    cost = torch.where(valid, (size / k.to(f64)) * n_arr.to(f64), inf)
    return valid, slow, k, p, cost


def least_used_batch(
    probs_mat: np.ndarray,   # (B, L) per-item fail probs, free-desc order
    sizes: np.ndarray,       # (B,)
    targets: np.ndarray,     # (B,)
    free_s: np.ndarray,      # (L,) free MB in the same order
    device=None,
):
    """GreedyLeastUsed decisions for a batch sharing one cluster snapshot.

    Returns ``(ok, n, k, p)`` length-B numpy arrays: the first feasible
    prefix length and EC parameters per item (zeros where ``ok`` is
    False).  Pure function of its arguments; runs on ``device`` (``None``
    means CUDA).
    """
    dev = resolve_device(device)
    B, L = probs_mat.shape
    if L < 2 or B == 0:
        z = np.zeros(B, dtype=np.int64)
        return z.astype(bool), z, z, z
    L_pad = shapes.node_pad(L)
    shapes.record_compile("least_used_kernel", (B, L_pad, dev.type))
    pm = np.zeros((B, L_pad), dtype=np.float64)
    pm[:, :L] = probs_mat
    res = _least_used_scores(
        L_pad,
        torch.from_numpy(pm).to(dev),
        torch.from_numpy(np.asarray(sizes, dtype=np.float64)).to(dev),
        torch.from_numpy(np.asarray(targets, dtype=np.float64)).to(dev),
        torch.from_numpy(_pad_to(free_s, L_pad, -1.0)).to(dev),
        L,
    ).cpu().numpy()
    return res[0].astype(bool), res[1], res[2], res[3]


def _pad_to(a: np.ndarray, size: int, fill: float) -> np.ndarray:
    out = np.full(size, fill, dtype=np.float64)
    out[: a.shape[0]] = a
    return out


def min_storage_batch(
    probs_mat: np.ndarray,   # (B, L) per-item fail probs, write-bw-desc order
    sizes: np.ndarray,       # (B,)
    targets: np.ndarray,     # (B,)
    rna_rows: np.ndarray,    # (B, L + 1) host RNA frontier rows (by N)
    free_bw: np.ndarray,     # (L,) free MB in the same order
    device=None,
):
    """Per-(item, N) GreedyMinStorage scores for a batch sharing one
    cluster snapshot.

    Returns ``(valid, slow, k, p, cost)`` numpy arrays of shape ``(B, L)``
    with rows indexed by ``N - 1``; the caller finishes ``slow`` rows with
    the scalar fixed point and takes the min-cost row in ascending-N order
    (matching the oracle's strict-less tie-breaking).  Pure function;
    runs on ``device`` (``None`` means CUDA).
    """
    dev = resolve_device(device)
    B, L = probs_mat.shape
    if L < 2 or B == 0:
        shape = (B, max(L, 0))
        return (
            np.zeros(shape, dtype=bool),
            np.zeros(shape, dtype=bool),
            np.zeros(shape, dtype=np.int64),
            np.zeros(shape, dtype=np.int64),
            np.full(shape, np.inf),
        )
    L_pad = shapes.node_pad(L)
    shapes.record_compile("min_storage_kernel", (B, L_pad, dev.type))
    pm = np.zeros((B, L_pad), dtype=np.float64)
    pm[:, :L] = probs_mat
    rna = np.full((B, L_pad + 1), -1, dtype=np.int64)
    rna[:, : L + 1] = rna_rows
    valid, slow, k, p, cost = _min_storage_scores(
        L_pad,
        int(_AUTO_EXACT_LIMIT),
        torch.from_numpy(pm).to(dev),
        torch.from_numpy(np.asarray(sizes, dtype=np.float64)).to(dev),
        torch.from_numpy(np.asarray(targets, dtype=np.float64)).to(dev),
        torch.from_numpy(rna).to(dev),
        torch.from_numpy(_pad_to(free_bw, L_pad, -1.0)).to(dev),
        L,
    )
    ints = torch.stack([valid.to(torch.int64), slow.to(torch.int64), k, p]).cpu().numpy()
    return (
        ints[0, :, :L].astype(bool),
        ints[1, :, :L].astype(bool),
        ints[2, :, :L],
        ints[3, :, :L],
        cost[:, :L].cpu().numpy(),
    )
