"""D-Rex SC's (starts x window-lengths) scoring as float64 torch on a device.

``DRexSC`` enumerates up to ``MAX_MAPPINGS`` contiguous windows of the
free-space-sorted live nodes and scores each on (duration, storage,
saturation) before a Pareto-front selection (Alg. 2).  The scalar numpy
path (:meth:`DRexSC.place_scalar`) remains the reference oracle; this
module computes the same decision for a batch of items sharing one
cluster snapshot, as the JAX package's jitted ``_score_windows`` does
(``src/repro/core/sc_kernel.py:69``):

* the per-start Poisson-binomial parity frontiers are one launch of the
  hand-written kernel :func:`repro_torch.kernels.pb_frontier.frontier`
  over every (item, suffix start);
* capacity checks and bandwidth bottlenecks are prefix-min tensors;
* the enumerated windows (at most ``budget`` of them, in the scalar
  path's start-major order) are compacted to a fixed-width candidate
  axis, scored, and Pareto-masked — all eager float64 torch, op for op
  as the reference writes them.

Exactness traps, handled where they arise below: the compaction needs a
*stable* argsort; products and sums stay separate ops (no ``addcmul``,
``lerp`` or ``torch.compile``, which could fuse them into an FMA);
python-float scalars times integer tensors would promote to float32, so
integer operands are cast to float64 first; ``argmax`` returns the first
maximal index, as ``jnp.argmax`` does.

**Ordering at ulp distance.**  Two terms are not bitwise the numpy
oracle's: the saturation ``exp`` (the device's, not libm's) and the
in-window delta sum (torch's reduction order, not numpy's pairwise one).
The JAX package's program has the same two differences (XLA's ``exp``
and reduction); they can only matter where two candidates tie within an
ulp, and the decisions are held equal to the oracle's by the tests and
by ``chip_smoke.py`` at 10,000 nodes.  Should a flip appear, the remedy
is the reference's own: move the term to the host.

**Failure-domain constraints.**  Under ``PlacementConstraints`` the
candidate-node axis arrives already masked: ``DRexSC`` feeds this module
the cap-admitted subsequence of its free-descending order, with
per-domain representatives kept by ``prefilter.domain_slice``, and the
saturation scale stays anchored to the *cluster-wide* live count via
``n_live``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import pb_frontier

from . import shapes

__all__ = ["kernel_available", "score_windows_batch"]

#: bound on the elements of one item chunk's (candidates x nodes) and
#: (candidates x candidates) working tensors, so a batch at 10k nodes
#: stays within a few hundred MB of device memory.
_CHUNK_ELEMENTS = 1 << 26


def kernel_available() -> bool:
    """True when the device scorer is built for this process: the
    ``pb_frontier`` kernel it launches has been compiled (or found
    compiled) and loaded, which its first launch on a card does.  The
    reference's counterpart says whether JAX imports."""
    return pb_frontier.loaded()


def _shape_plan(L: int, budget: int) -> tuple[int, int]:
    """Static (S_pad, L_pad) for a live-node count: L padded through the
    shared hysteresis-banded buckets (:mod:`repro_torch.core.shapes`),
    starts covering every budgeted window."""
    L_pad = shapes.node_pad(L)
    if L_pad <= 64:
        return L_pad - 1, L_pad  # every start can matter; keep stable
    w = L - 1 - np.arange(L - 1)
    consider = min(int(w.sum()), budget)
    s_real = int(np.searchsorted(np.cumsum(w), consider) + 1)
    return min(L_pad - 1, shapes.start_pad(s_real)), L_pad


def _saturation(x, c, smin, inv_l: float, log_l: float):
    """Mirror of ``algorithms.saturation_score`` (elementwise, f64)."""
    span = torch.clamp(c - smin, min=1e-9)
    u = torch.clamp((x - smin) / span, 0.0, 1.0)
    return torch.clamp(inv_l * torch.exp(log_l * u), 0.0, 1.0)


def _progress(v, front):
    """Relative progress over the front (1 at the min, 0 at the max)."""
    inf = torch.tensor(math.inf, dtype=torch.float64, device=v.device)
    lo = torch.where(front, v, inf).amin(dim=1, keepdim=True)
    hi = torch.where(front, v, -inf).amax(dim=1, keepdim=True)
    return torch.where(hi - lo <= 1e-12, 0.0, (hi - v) / (hi - lo))


def _score_windows(
    S_pad: int,
    L_pad: int,
    budget: int,
    probs_b,     # (B, L_pad) per-item fail probs in free-desc order
    size_b,      # (B,)
    target_b,    # (B,)
    smin_b,      # (B,) running smallest-item anchor per item
    fbase_b,     # (B,) sum of per-node saturation over live nodes
    ssat_b,      # (B,) system saturation scalar
    free,        # (L_pad,) shared sorted cluster snapshot
    wb,
    rb,
    used,
    cap,
    L: int,      # live-node count (padding is masked via L)
    inv_l: float,
    log_l: float,
    tm: tuple,   # (e0, e_byte, e_mult, d0, d_byte, d_mult)
):
    dev = probs_b.device
    f64 = torch.float64
    inf = torch.tensor(math.inf, dtype=f64, device=dev)
    K_c = min(budget, S_pad * L_pad)  # enumerated windows <= budget
    s_idx = torch.arange(S_pad, device=dev)
    i_idx = torch.arange(L_pad, device=dev)
    act2 = i_idx[None, :] >= s_idx[:, None]  # (S, L): end >= start

    # Bottleneck bandwidth of window [s..i]: a running min over the
    # suffix starting at s (lax.cummin -> torch.cummin; exact).
    wb_min = torch.cummin(torch.where(act2, wb[None, :], inf), dim=1).values
    rb_min = torch.cummin(torch.where(act2, rb[None, :], inf), dim=1).values

    # Scalar enumeration order and budget: start s contributes
    # min(L-1-s, remaining budget) windows, starts in ascending order.
    w_full = torch.clamp(L - 1 - s_idx, min=0)
    cum_before = torch.cat([w_full.new_zeros(1), torch.cumsum(w_full, 0)[:-1]])
    allowed = torch.minimum(torch.clamp(budget - cum_before, min=0), w_full)
    win_idx = i_idx[None, :] - s_idx[:, None] - 1  # 0 <=> window n=2
    in_budget = (win_idx >= 0) & (win_idx < allowed[:, None])
    in_budget &= i_idx[None, :] <= L - 1

    # Compact the (S, L) window grid to a fixed candidate axis in the
    # scalar path's (start-major, length-minor) order.  Stable
    # compaction: torch.argsort is unstable unless asked, and only a
    # stable sort moves the <= budget enumerated windows to the front
    # unpermuted (jnp.argsort is stable).
    flat_order = torch.argsort(
        torch.where(in_budget.reshape(-1), 0, 1).to(torch.int32), stable=True
    )[:K_c]
    s_w = flat_order // L_pad
    i_w = flat_order % L_pad
    enumerated = in_budget.reshape(-1)[flat_order]
    n_w = i_w - s_w + 1
    n_wf = n_w.to(f64)
    in_win = (i_idx[None, :] >= s_w[:, None]) & (i_idx[None, :] <= i_w[:, None])
    wb_w, rb_w, free_w = wb_min[s_w, i_w], rb_min[s_w, i_w], free[i_w]
    e0, e_byte, e_mult, d0, d_byte, d_mult = (float(x) for x in tm)

    # ---- parity frontier of every suffix: one launch of the kernel ----
    shapes.record_compile(
        "pb_frontier", (probs_b.shape[0], S_pad, L_pad, L, L_pad + 1, dev.type)
    )
    cols = pb_frontier.frontier(probs_b, target_b, S_pad, L, L_pad + 1)

    B = probs_b.shape[0]
    per_item = K_c * (L_pad + K_c)
    step = max(1, _CHUNK_ELEMENTS // max(1, per_item))
    outs = []
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        size = size_b[b0:b1, None]
        smin = smin_b[b0:b1, None]
        mp = cols[b0:b1, s_w, i_w]  # (b, K_c) min parity per window

        p_star = torch.clamp(mp, min=1)
        k = n_w - p_star
        valid = enumerated & (mp >= 0) & (k >= 1)
        k_safe = torch.where(valid, k, 1)
        k_f = k_safe.to(f64)
        chunk = size / k_f
        # Mapping is free-desc sorted: the window min free is its last
        # node (index i).
        valid &= free_w >= chunk

        # Integer factors are cast to f64 before meeting a python float
        # (int64 * float would promote to float32); each product and sum
        # is its own op, left to right as the reference writes them.
        enc = torch.where(
            k_safe == 1,
            e0,
            (e0 + e_byte * size) + (e_mult * (n_wf - k_f)) * size,
        )
        dec = torch.where(
            k_safe == 1, d0, (d0 + d_byte * size) + (d_mult * k_f) * size
        )
        duration = ((chunk / wb_w + chunk / rb_w) + enc) + dec
        storage = chunk * n_wf

        # Saturation objective: base sum over all live nodes plus the
        # delta of the window's nodes at projected occupancy.
        sat_new = _saturation(
            used[None, None, :] + chunk[:, :, None], cap, smin[:, :, None], inv_l, log_l
        )
        sat_old = _saturation(used[None, :], cap, smin, inv_l, log_l)
        delta = ((sat_new - sat_old[:, None, :]) * in_win).sum(dim=2)
        del sat_new
        sat_obj = fbase_b[b0:b1, None] + delta

        # ---- Pareto front + relative-progress scoring (lines 11-17)
        dur_f = torch.where(valid, duration, inf)
        sto_f = torch.where(valid, storage, inf)
        sat_f = torch.where(valid, sat_obj, inf)
        n = b1 - b0
        le = torch.ones((n, K_c, K_c), dtype=torch.bool, device=dev)
        lt = torch.zeros((n, K_c, K_c), dtype=torch.bool, device=dev)
        for c in (dur_f, sto_f, sat_f):
            le &= c[:, None, :] <= c[:, :, None]
            lt |= c[:, None, :] < c[:, :, None]
        front = ~torch.any(le & lt, dim=2) & valid
        del le, lt

        score = (1.0 - ssat_b[b0:b1, None]) * _progress(dur_f, front) + (
            _progress(sto_f, front) + _progress(sat_f, front)
        ) / 2.0
        best = torch.argmax(torch.where(front, score, -inf), dim=1)
        bp = torch.clamp(mp.gather(1, best[:, None])[:, 0], min=1)
        nb = n_w[best]
        outs.append(torch.stack([valid.any(dim=1).to(torch.int64), s_w[best], nb, nb - bp, bp]))
    return torch.cat(outs, dim=1)


def score_windows_batch(
    probs_mat: np.ndarray,   # (B, L) per-item fail probs, free-desc order
    sizes: np.ndarray,       # (B,)
    targets: np.ndarray,     # (B,)
    smins: np.ndarray,       # (B,)
    fbase: np.ndarray,       # (B,)
    ssat: np.ndarray,        # (B,)
    free_s: np.ndarray,      # (L,) shared sorted cluster snapshot
    wb_s: np.ndarray,
    rb_s: np.ndarray,
    used_s: np.ndarray,
    cap_s: np.ndarray,
    budget: int,
    tm_params: tuple,        # (e0, e_byte, e_mult, d0, d_byte, d_mult)
    n_live: int | None = None,
    device=None,
):
    """Score every item's candidate windows against one shared snapshot.

    Returns ``(ok, s, n, k, p)`` length-B numpy arrays (``ok`` bool, the
    rest int64): the winning window start/length and EC parameters per
    item (undefined where ``ok`` is False).  Pure function of its
    arguments.  Runs on ``device`` (``None`` means CUDA); the inputs move
    to it once and the five outputs come back in one copy.

    ``n_live`` is the true live-node count when the node arrays are a
    top-M pre-filtered slice (see :mod:`repro_torch.core.prefilter`): the
    ``1/L`` / ``log L`` saturation scale is an Alg. 2 property of the
    *cluster*, so it must come from the caller.  Defaults to the array
    length (unfiltered call).
    """
    dev = resolve_device(device)
    B, L = probs_mat.shape
    if L < 2 or B == 0:
        z = np.zeros(B, dtype=np.int64)
        return z.astype(bool), z, z, z, z
    S_pad, L_pad = _shape_plan(L, budget)
    shapes.record_compile("sc_kernel", (B, S_pad, L_pad, int(budget), dev.type))

    def pad_nodes(a, fill):
        out = np.full(L_pad, fill, dtype=np.float64)
        out[:L] = a
        return torch.from_numpy(out).to(dev)

    def items(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev)

    pm = np.zeros((B, L_pad), dtype=np.float64)
    pm[:, :L] = probs_mat
    l_eff = max(2, L if n_live is None else int(n_live))
    res = _score_windows(
        S_pad,
        L_pad,
        int(budget),
        torch.from_numpy(pm).to(dev),
        items(sizes),
        items(targets),
        items(smins),
        items(fbase),
        items(ssat),
        pad_nodes(free_s, -1.0),
        pad_nodes(wb_s, 1.0),
        pad_nodes(rb_s, 1.0),
        pad_nodes(used_s, 0.0),
        pad_nodes(cap_s, 1.0),
        L,
        1.0 / l_eff,
        math.log(l_eff),
        tuple(float(x) for x in tm_params),
    ).cpu().numpy()
    return res[0].astype(bool), res[1], res[2], res[3], res[4]
