"""D-Rex LB's (K, P) balance-penalty grid (Alg. 1) as float64 torch.

The port of the JAX package's jitted ``_lb_scores``
(``src/repro/core/lb_kernel.py:104``).  For each parity count P
(ascending) D-Rex LB scores every data-chunk count K by the balance
penalty of mapping the item onto the free-space-sorted prefix of K+P
nodes, and stops at the smallest feasible P (taking the best K there).
The grid is evaluated in two phases, neither of which materializes a
(K, N) float tensor:

1. **Smallest feasible P, O(L).**  At prefix length N the feasible K
   form the contiguous range ``[2, hi(N)]`` with
   ``hi(N) = N - max(1, mp(N))``, nonempty iff its largest K fits — one
   exact float capacity compare per column.  P* is a masked min.
2. **Penalties on the P* diagonal, O(L) memory.**  The per-K prefix sums
   of ``|free_i - chunk - f_avg|`` accumulate with an O(K) carry over
   node index, snapshotting each K row at its own diagonal column.
   "Strictly smallest penalty, earliest K on ties" is a min plus an
   exact-equality masked min over K.

**Exactness policy** (the reference's): every order-sensitive quantity
is fixed.  The parity-frontier rows, ``f_avg`` (numpy's pairwise mean)
and the out-of-mapping suffix penalties (a reversed ``np.cumsum``) are
host inputs computed exactly as the oracle computes them.  The carry is
a loop over nodes, ``run = run + |f_i - chunk - f_avg|`` vectorised over
K and items: the oracle's ``np.cumsum`` fixes left-to-right order, and
``torch.cumsum`` (which re-associates on CUDA) is never used.  Each
iteration is a few launches, so the loop's cost grows with the scanned
width; the top-M pre-filter keeps it at ``prefilter.lb_cap()`` nodes
whenever the sufficiency test allows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device

from . import shapes

__all__ = ["kernel_available", "lb_batch"]


def kernel_available() -> bool:
    """True when the device scorer is built for this process.  D-Rex LB's
    is float64 torch ops, with no kernel of its own to compile, so it is
    ready wherever a CUDA device is.  The reference's counterpart says
    whether JAX imports."""
    return torch.cuda.is_available()


def _lb_scores(
    L_pad: int,
    mp,          # (B, L_pad) host frontier: min parity per prefix length
    size_b,      # (B,)
    free,        # (L_pad,) free MB, free-desc order (pad -1)
    suffix,      # (L_pad + 1,) host suffix penalties by n (pad 0)
    f_avg: float,
    L: int,      # live-node count (padding masked via L)
):
    """D-Rex LB (Alg. 1) for a batch: per item, the winning (K, P).
    ``mp[row, n-1]`` is the min parity of the length-``n`` free-desc
    prefix (``-1`` infeasible), straight from the oracle's
    ``ParityFrontier``."""
    dev = mp.device
    f64 = torch.float64
    k_arr = torch.arange(L_pad, device=dev) + 2
    n_row = torch.arange(L_pad, device=dev) + 1
    big = L_pad + 2
    size = size_b[:, None]
    chunk = size / k_arr.to(f64)                     # (B, L_pad) by K
    # ---- phase 1: smallest feasible P (line 22), O(L)
    mp1 = torch.clamp(mp, min=1)
    hi = torch.where(mp >= 0, n_row - mp1, 0)
    col_ok = (
        (n_row <= L)
        & (hi >= 2)
        # same float predicate the oracle tests: free[n-1] >= size/K
        & (free >= size / torch.clamp(hi, min=1).to(f64))
    )
    p_star = torch.where(col_ok, mp1, big).amin(dim=1, keepdim=True)
    ok = p_star < big
    # ---- phase 2: penalties on the N = K + P* diagonal
    n_diag = torch.clamp(k_arr + p_star, 2, L_pad)
    mp_d = mp.gather(1, n_diag - 1)
    feas_d = (
        ok
        & (k_arr + p_star <= L)
        & (mp_d >= 0)
        & (mp_d <= p_star)
        & (free[n_diag - 1] >= chunk)
    )
    # Left-to-right carry over nodes (the oracle's np.cumsum order; never
    # torch.cumsum).  Snapshots at columns >= L only ever land on K with
    # K + P* > L, which feas_d masks, so the loop stops at L.
    run = torch.zeros_like(chunk)
    acc = torch.zeros_like(chunk)
    last = n_diag - 1
    for i in range(min(L, L_pad)):
        run = run + torch.abs((free[i] - chunk) - f_avg)
        acc = torch.where(last == i, run, acc)
    # lines 10-15: in-mapping prefix sum + precomputed suffix term.
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    bp = torch.where(feas_d, acc + suffix[n_diag], inf)
    bv = bp.amin(dim=1, keepdim=True)
    k_star = torch.where(feas_d & (bp == bv), k_arr, big).amin(dim=1)
    ok = ok[:, 0]
    p_star = p_star[:, 0]
    return torch.stack([
        ok.to(torch.int64),
        torch.where(ok, k_star, 0),
        torch.where(ok, p_star, 0),
    ])


def lb_batch(
    mp_rows: np.ndarray,     # (B, L) host ParityFrontier rows, by n - 1
    sizes: np.ndarray,       # (B,)
    free_s: np.ndarray,      # (L,) free MB, free-desc order
    f_avg: float,            # host-computed mean free over live nodes
    suffix: np.ndarray,      # (L + 1,) host-computed suffix penalties
    device=None,
):
    """D-Rex LB decisions for a batch sharing one cluster snapshot.

    Returns ``(ok, k, p)`` length-B numpy arrays: the winning EC
    parameters per item (zeros where ``ok`` is False — genuinely
    infeasible, since the host frontier rows are exact at every width;
    the mapping is always the free-desc prefix of ``k + p`` nodes).  Pure
    function of its arguments; runs on ``device`` (``None`` means CUDA).
    """
    dev = resolve_device(device)
    B, L = mp_rows.shape
    if L < 3 or B == 0:
        z = np.zeros(B, dtype=np.int64)
        return z.astype(bool), z, z
    L_pad = shapes.node_pad(L)
    shapes.record_compile("lb_kernel", (B, L_pad, dev.type))
    mp = np.full((B, L_pad), -1, dtype=np.int64)
    mp[:, :L] = mp_rows
    suf = np.zeros(L_pad + 1, dtype=np.float64)
    suf[: L + 1] = suffix
    free = np.full(L_pad, -1.0, dtype=np.float64)
    free[:L] = free_s
    res = _lb_scores(
        L_pad,
        torch.from_numpy(mp).to(dev),
        torch.from_numpy(np.asarray(sizes, dtype=np.float64)).to(dev),
        torch.from_numpy(free).to(dev),
        torch.from_numpy(suf).to(dev),
        float(f_avg),
        L,
    ).cpu().numpy()
    return res[0].astype(bool), res[1], res[2]
