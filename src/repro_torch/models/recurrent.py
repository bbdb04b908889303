"""Recurrent blocks of the port: RWKV6 time/channel mix (Finch).

The port of ``repro.models.recurrent`` for the serving path.  The
projections and the data-dependent decay run over the whole sequence at
once; only the rank-1 state recurrence S_t = diag(w_t) S_{t-1} + k_t^T
v_t steps over time, in f32, as a plain torch loop (``_rwkv_core_scan``).
Every expression mirrors the reference's, in the same dtypes.

The Griffin RG-LRU block waits for a later slice (``ROADMAP.md``,
Queue 1).
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import dense_init, ones, rms_norm, sigmoid, silu

# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

_TM_LORA = 32   # token-mix lora rank
_TD_LORA = 64   # decay lora rank


def init_rwkv6_tmix(cfg: ModelConfig, generator, *, device, stack=()) -> dict:
    d = cfg.d_model
    h = d // cfg.rwkv_head_size
    hd = cfg.rwkv_head_size
    dt = cfg.dt
    kw = dict(device=device, stack=stack)
    return {
        "x_maa": torch.zeros((*stack, d), dtype=dt, device=device),
        "maa": torch.zeros((*stack, 5, d), dtype=dt, device=device),  # w,k,v,r,g
        "tm_w1": dense_init(generator, (d, 5 * _TM_LORA), dt, **kw),
        "tm_w2": dense_init(generator, (5, _TM_LORA, d), dt, in_axis=1, **kw),
        "td_w1": dense_init(generator, (d, _TD_LORA), dt, **kw),
        "td_w2": dense_init(generator, (_TD_LORA, d), dt, **kw),
        "decay_bias": torch.full((*stack, d), -6.0, dtype=dt, device=device),
        "bonus_u": dense_init(generator, (h, hd), dt, **kw),
        "wr": dense_init(generator, (d, d), dt, **kw),
        "wk": dense_init(generator, (d, d), dt, **kw),
        "wv": dense_init(generator, (d, d), dt, **kw),
        "wg": dense_init(generator, (d, d), dt, **kw),
        "wo": dense_init(generator, (d, d), dt, **kw),
        "ln_scale": ones((d,), dt, **kw),
    }


def _ddlerp(p, x, sx):
    """Data-dependent token-shift mixing (RWKV6's ddlerp)."""
    base = x + sx * p["x_maa"]
    lora = torch.tanh(base @ p["tm_w1"])
    lora = lora.reshape(*lora.shape[:-1], 5, _TM_LORA)
    offs = torch.einsum("btsr,srd->sbtd", lora, p["tm_w2"])  # (5,B,T,D)
    mixed = x[None] + sx[None] * (p["maa"][:, None, None, :] + offs)
    return mixed  # order: w,k,v,r,g


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

    r = (xr @ p["wr"]).reshape(b, t, h, hd)
    k = (xk @ p["wk"]).reshape(b, t, h, hd)
    v = (xv @ p["wv"]).reshape(b, t, h, hd)
    g = silu(xg @ p["wg"])
    decay = p["decay_bias"].float() + (
        xw.float() @ p["td_w1"].float()
    ) @ p["td_w2"].float()
    w = torch.exp(-torch.exp(decay)).reshape(b, t, h, hd)  # data-dependent decay

    y, s_final = _rwkv_core_scan(
        r.float(), k.float(), v.float(), w, p["bonus_u"].float(), s0,
        chunk=cfg.rwkv_chunk,
    )
    y = y.reshape(b, t, d).to(x.dtype)
    # per-head group norm
    y = rms_norm(
        y.reshape(b, t, h, hd), torch.ones((hd,), dtype=x.dtype, device=x.device),
        cfg.norm_eps,
    ).reshape(b, t, d) * p["ln_scale"]
    out = (y * g) @ p["wo"]
    new_state = {"s": s_final, "x_prev": x[:, -1, :]}
    return out, new_state


def init_rwkv6_cmix(cfg: ModelConfig, generator, *, device, stack=()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(device=device, stack=stack)
    return {
        "mu_k": torch.zeros((*stack, d), dtype=cfg.dt, device=device),
        "mu_r": torch.zeros((*stack, d), dtype=cfg.dt, device=device),
        "wk": dense_init(generator, (d, f), cfg.dt, **kw),
        "wv": dense_init(generator, (f, d), cfg.dt, **kw),
        "wr": dense_init(generator, (d, d), cfg.dt, **kw),
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
    k = torch.square(torch.relu(xk @ p["wk"]))
    kv = k @ p["wv"]
    out = sigmoid(xr @ p["wr"]) * kv
    return out, {"x_prev": x[:, -1, :]}
