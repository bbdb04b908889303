"""Recurrent blocks of the port: RWKV6 time/channel mix (Finch) and the
Griffin RG-LRU block (RecurrentGemma).

The port of ``repro.models.recurrent``.  RWKV6: the projections and the
data-dependent decay run over the whole sequence at once; only the
rank-1 state recurrence S_t = diag(w_t) S_{t-1} + k_t^T v_t steps over
time, in f32, as a plain torch loop (``_rwkv_core_scan``).  RG-LRU: the
diagonal recurrence h_t = a_t h_{t-1} + b_t runs as the reference's
``jax.lax.associative_scan`` tree (``_associative_scan``), in log-depth.
Every expression mirrors the reference's, in the same dtypes.
"""

from __future__ import annotations

import torch

from repro_torch import prng

from .config import ModelConfig
from .layers import dense_init, gelu, ones, rms_norm, sigmoid, silu
from .sharding import constrain, local_region, matmul, reshape

# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

_TM_LORA = 32   # token-mix lora rank
_TD_LORA = 64   # decay lora rank


def init_rwkv6_tmix(cfg: ModelConfig, key, *, device, stack=()) -> dict:
    d = cfg.d_model
    h = d // cfg.rwkv_head_size
    hd = cfg.rwkv_head_size
    dt = cfg.dt
    kw = dict(device=device, stack=stack)
    ks = prng.split(key, 12)    # the reference's 12; ks[10:] stay unused
    return {
        "x_maa": torch.zeros((*stack, d), dtype=dt, device=device),
        "maa": torch.zeros((*stack, 5, d), dtype=dt, device=device),  # w,k,v,r,g
        "tm_w1": dense_init(ks[0], (d, 5 * _TM_LORA), dt, **kw),
        "tm_w2": dense_init(ks[1], (5, _TM_LORA, d), dt, in_axis=1, **kw),
        "td_w1": dense_init(ks[2], (d, _TD_LORA), dt, **kw),
        "td_w2": dense_init(ks[3], (_TD_LORA, d), dt, **kw),
        "decay_bias": torch.full((*stack, d), -6.0, dtype=dt, device=device),
        "bonus_u": dense_init(ks[4], (h, hd), dt, **kw),
        "wr": dense_init(ks[5], (d, d), dt, **kw),
        "wk": dense_init(ks[6], (d, d), dt, **kw),
        "wv": dense_init(ks[7], (d, d), dt, **kw),
        "wg": dense_init(ks[8], (d, d), dt, **kw),
        "wo": dense_init(ks[9], (d, d), dt, **kw),
        "ln_scale": ones((d,), dt, **kw),
    }


def rwkv6_tmix_axes() -> dict:
    return {
        "x_maa": (None,),
        "maa": (None, None),
        "tm_w1": ("embed", None),
        "tm_w2": (None, None, "embed"),
        "td_w1": ("embed", None),
        "td_w2": (None, "embed"),
        "decay_bias": (None,),
        "bonus_u": ("heads", None),
        "wr": ("embed", "mlp"),
        "wk": ("embed", "mlp"),
        "wv": ("embed", "mlp"),
        "wg": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
        "ln_scale": (None,),
    }


def _ddlerp(p, x, sx):
    """Data-dependent token-shift mixing (RWKV6's ddlerp)."""
    base = x + sx * p["x_maa"]
    lora = constrain(torch.tanh(matmul(base, p["tm_w1"])), ("batch", None, None))
    lora = reshape(lora, *lora.shape[:-1], 5, _TM_LORA)
    offs = constrain(torch.einsum("btsr,srd->sbtd", lora, p["tm_w2"]),
                     (None, "batch", None, None))  # (5,B,T,D)
    mixed = x[None] + sx[None] * (p["maa"][:, None, None, :] + offs)
    # split below: keep the five mixes whole on every shard
    return constrain(mixed, (None, "batch", None, None))  # order: w,k,v,r,g


def _rwkv_core_scan(r, k, v, w, u, s0, chunk: int = 1):
    """The WKV recurrence over time, in f32.

    r,k,v,w: (B,T,H,hd); u: (H,hd); s0: (B,H,hd,hd).  Returns y
    (B,T,H,hd) and the final state.

    The reference scans step by step (``chunk <= 1`` or T not a multiple
    of ``chunk``) or over chunks of unrolled steps; both are the same
    arithmetic, bit for bit, and so is this loop over T, which serves
    every ``chunk``."""
    del chunk
    s = s0
    ys = []
    bonus = u[None, :, :, None]
    for i in range(r.shape[1]):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]          # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], s + bonus * kv))
        s = w[:, i, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


_BTH = ("batch", None, "heads", None)
_STATE = ("batch", "heads", None, None)
#: the WKV loop on each shard's batch rows and heads (no communication).
_wkv = local_region(_rwkv_core_scan, (_BTH, _BTH, _BTH, _BTH, ("heads", None), _STATE),
                    (_BTH, _STATE))


def rwkv6_tmix(p, x, cfg: ModelConfig, state=None):
    """Full-sequence RWKV6 time-mix. state: None (zeros) or
    {"s": (B,H,hd,hd), "x_prev": (B,D)}. Returns (out, new_state)."""
    b, t, d = x.shape
    h = d // cfg.rwkv_head_size
    hd = cfg.rwkv_head_size
    if state is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
        s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    else:
        x_prev, s0 = state["x_prev"], state["s"]
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    sx = shifted - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)

    r = reshape(matmul(xr, p["wr"]), b, t, h, hd)
    k = reshape(matmul(xk, p["wk"]), b, t, h, hd)
    v = reshape(matmul(xv, p["wv"]), b, t, h, hd)
    g = silu(matmul(xg, p["wg"]))
    decay = p["decay_bias"].float() + (
        matmul(matmul(xw.float(), p["td_w1"].float()), p["td_w2"].float()))
    w = reshape(torch.exp(-torch.exp(decay)), b, t, h, hd)  # data-dependent decay

    y, s_final = _wkv(r.float(), k.float(), v.float(), w, p["bonus_u"].float(), s0)
    y = reshape(y, b, t, d).to(x.dtype)
    # per-head group norm
    y = rms_norm(
        reshape(y, b, t, h, hd), torch.ones((hd,), dtype=x.dtype, device=x.device),
        cfg.norm_eps,
    )
    y = reshape(y, b, t, d) * p["ln_scale"]
    out = matmul(y * g, p["wo"])
    new_state = {"s": s_final, "x_prev": x[:, -1, :]}
    return out, new_state


def init_rwkv6_cmix(cfg: ModelConfig, key, *, device, stack=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(device=device, stack=stack)
    ks = prng.split(key, 3)
    return {
        "mu_k": torch.zeros((*stack, d), dtype=cfg.dt, device=device),
        "mu_r": torch.zeros((*stack, d), dtype=cfg.dt, device=device),
        "wk": dense_init(ks[0], (d, f), cfg.dt, **kw),
        "wv": dense_init(ks[1], (f, d), cfg.dt, **kw),
        "wr": dense_init(ks[2], (d, d), cfg.dt, **kw),
    }


def rwkv6_cmix_axes() -> dict:
    return {
        "mu_k": (None,),
        "mu_r": (None,),
        "wk": ("embed", "mlp"),
        "wv": ("mlp", "embed"),
        "wr": ("embed", "mlp"),
    }


def rwkv6_cmix(p, x, cfg: ModelConfig, state=None):
    b, _, d = x.shape
    if state is None:
        x_prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    else:
        x_prev = state["x_prev"]
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    sx = shifted - x
    xk = x + sx * p["mu_k"]
    xr = x + sx * p["mu_r"]
    k = torch.square(torch.relu(matmul(xk, p["wk"])))
    kv = matmul(k, p["wv"])
    out = sigmoid(matmul(xr, p["wr"])) * kv
    return out, {"x_prev": x[:, -1, :]}


# ---------------------------------------------------------------------------
# Griffin RG-LRU recurrent block (RecurrentGemma)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def init_rglru_block(cfg: ModelConfig, key, *, device, stack=()) -> dict:
    d = cfg.d_model            # lru width == d_model for recurrentgemma-9b
    kw = dict(device=device, stack=stack)
    ks = prng.split(key, 6)
    return {
        "wx": dense_init(ks[0], (d, d), cfg.dt, **kw),
        "wy": dense_init(ks[1], (d, d), cfg.dt, **kw),
        "conv_w": dense_init(ks[2], (cfg.conv1d_width, d), cfg.dt, **kw),
        "conv_b": torch.zeros((*stack, d), dtype=cfg.dt, device=device),
        "wa": dense_init(ks[3], (d, d), cfg.dt, **kw),
        "wi": dense_init(ks[4], (d, d), cfg.dt, **kw),
        "a_param": torch.full((*stack, d), 0.7, dtype=torch.float32, device=device),
        "wo": dense_init(ks[5], (d, d), cfg.dt, **kw),
    }


def rglru_block_axes() -> dict:
    return {
        "wx": ("embed", "mlp"),
        "wy": ("embed", "mlp"),
        "conv_w": ("conv", "mlp"),
        "conv_b": ("mlp",),
        "wa": ("embed", "mlp"),
        "wi": ("embed", "mlp"),
        "a_param": ("mlp",),
        "wo": ("mlp", "embed"),
    }


def _temporal_conv(x, w, b, state=None):
    """Depthwise causal conv1d of width W. x: (B,T,D); state: (B,W-1,D).
    The taps are summed as the reference's Python ``sum`` adds them, from
    0, in the compute dtype, then the bias."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    t = x.shape[1]
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + t, :] * w[i]
    new_state = xp[:, -(width - 1):, :] if width > 1 else None
    return out + b, new_state


def _softplus(x):
    """``jax.nn.softplus``'s own expression, ``logaddexp(x, 0)`` (torch's
    ``softplus`` computes ``log1p(exp(x))`` and switches to ``x`` above a
    threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _combine(u, v):
    """The RG-LRU's associative operator on (a, b) pairs, ``u`` first."""
    au, bu = u
    av, bv = v
    return au * av, bu * av + bv


def _interleave(even, odd):
    """Elements of ``even`` at 0, 2, ... and of ``odd`` at 1, 3, ... (dim 1)."""
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]),
                      dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(elems):
    """``jax.lax.associative_scan(_combine, elems, axis=1)``, the same
    odd/even recursion: O(log T) levels of whole-tensor ops, where a
    serial loop issues O(T).  The products are re-associated as the
    reference's tree re-associates them; XLA may still fuse a multiply
    and add into an FMA where torch rounds twice, so the two agree to f32
    rounding, not bit for bit."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _rglru(a_gate, i_gate, x, a_param, h0):
    """h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * x_t), via associative scan."""
    log_a = -_RGLRU_C * _softplus(a_param) * sigmoid(a_gate)
    a = torch.exp(log_a)                             # (B,T,D) f32
    b = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=0.0)) * (i_gate * x)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, h_all = _associative_scan([a, b])
    return h_all, h_all[:, -1, :]


_BTD = ("batch", None, "mlp")
#: the RG-LRU scan on each shard's batch rows and channels.
_rglru_local = local_region(_rglru, (_BTD, _BTD, _BTD, ("mlp",), ("batch", "mlp")),
                            (_BTD, ("batch", "mlp")))


def rglru_block(p, x, cfg: ModelConfig, state=None):
    """Griffin recurrent block. state: {"h": (B,D) f32, "conv": (B,W-1,D)}."""
    gate = gelu(matmul(x, p["wy"]))
    xb = matmul(x, p["wx"])
    conv_state = None if state is None else state["conv"]
    xb, new_conv = _temporal_conv(xb, p["conv_w"], p["conv_b"], conv_state)
    a_gate = matmul(xb, p["wa"]).float()
    i_gate = sigmoid(matmul(xb, p["wi"])).float()
    h0 = None if state is None else state["h"]
    h, h_last = _rglru_local(a_gate, i_gate, xb.float(), p["a_param"], h0)
    out = matmul(h.to(x.dtype) * gate, p["wo"])
    return out, {"h": h_last, "conv": new_conv}
