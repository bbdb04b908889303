"""Core neural layers of the port: norms, RoPE, GQA attention, MLP variants.

The port of ``repro.models.layers`` for the serving path: the dense
attention and MLP of ``block_pattern="attn"`` models.  Params are nested
dicts of tensors; ``init_*`` builds them, stacked along leading ``stack``
dims (the layer axis), from an explicit ``torch.Generator``.

Every apply function mirrors the JAX expression op for op, in the same
dtypes, so the rounding points are the reference's: the compute dtype
follows ``cfg.dt`` (bf16 by default), an einsum's output is rounded to
it, and only the norms, RoPE and the softmax run in f32.  The attention
is plain tensor ops, not ``scaled_dot_product_attention``: the reference
rounds the scores to the compute dtype before the f32 softmax and the
probabilities to it before the PV product, which a fused kernel does not.

Waiting for a later slice (``ROADMAP.md``, Queue 1): ``blockwise_sdpa``,
the cross-attention helpers, ring (griffin) decode and MoE.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .config import ModelConfig

#: what a config that needs a family not ported yet is told.
WAITS = ("not ported yet: {what} waits for ROADMAP.md Queue 1, LM stack "
         "item 2 (the other families)")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(WAITS.format(what=what))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, dtype, in_axis=0, *,
               device, stack=()) -> torch.Tensor:
    """N(0, 1/fan_in) in f32, cast to ``dtype``; ``fan_in`` is ``shape``'s
    ``in_axis`` extent (or the product over a tuple of axes).  Leading
    ``stack`` dims hold independent draws, made one slice at a time so
    the f32 draw never exceeds one layer."""
    axes = (in_axis,) if isinstance(in_axis, int) else in_axis
    fan_in = int(np.prod([shape[a] for a in axes]))
    std = 1.0 / math.sqrt(fan_in)
    out = torch.empty((*stack, *shape), dtype=dtype, device=device)
    for idx in np.ndindex(*stack):
        draw = torch.randn(tuple(shape), generator=generator, device=device,
                           dtype=torch.float32)
        out[idx] = (draw * std).to(dtype)
    return out


def ones(shape, dtype, *, device, stack=()) -> torch.Tensor:
    return torch.ones((*stack, *shape), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6, stats_only_f32: bool = False):
    dt = x.dtype
    if stats_only_f32:
        # f32 statistic, compute-dtype normalization.
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        inv = torch.rsqrt(var + eps).to(dt)
        return x * inv * scale.to(dt)
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE (half-rotation)
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., T, H, D); positions: (..., T) integer."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional qk-norm / local window)
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, generator, *, device, stack=()) -> dict:
    e, hd = cfg.d_model, cfg.dhead
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    kw = dict(device=device, stack=stack)
    p = {
        "wq": dense_init(generator, (e, nh, hd), cfg.dt, **kw),
        "wk": dense_init(generator, (e, nkv, hd), cfg.dt, **kw),
        "wv": dense_init(generator, (e, nkv, hd), cfg.dt, **kw),
        "wo": dense_init(generator, (nh, hd, e), cfg.dt, in_axis=(0, 1), **kw),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = ones((hd,), cfg.dt, **kw)
        p["k_norm"] = ones((hd,), cfg.dt, **kw)
    return p


def _proj_heads(x, w):
    """einsum ``"btd,dhk->bthk"`` as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _heads_out(x, w):
    """einsum ``"bthd,hde->bte"`` as one matmul."""
    h, d, e = w.shape
    return x.reshape(*x.shape[:-2], h * d) @ w.reshape(h * d, e)


def _qkv(p, x, cfg: ModelConfig, positions):
    """Self-attention's q, k, v (the reference's ``_qkv`` with
    ``x_kv = x`` and RoPE on; its cross-attention form waits)."""
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x, p["wk"])
    v = _proj_heads(x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Grouped scaled-dot-product attention.

    q: (B,T,Hq,D); k/v: (B,S,Hkv,D); mask: (T,S) bool or None.  Scores
    are rounded to the compute dtype, then f32 from the scaling through
    the softmax; probabilities are rounded to ``v.dtype``.
    """
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    q = q.reshape(b, t, hkv, g, d)
    scores = torch.einsum("bthgd,bshd->bhgts", q, k).float()
    scores = scores / math.sqrt(d)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(b, t, hq, d)


def causal_mask(t: int, s: int, window: int = 0, offset: int = 0, *, device=None):
    """(T, S) bool where query i attends key j iff j <= i+offset and, for a
    local window w, j > i+offset-w."""
    qi = torch.arange(t, device=device)[:, None] + offset
    kj = torch.arange(s, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def self_attention(q, k, v, cfg: ModelConfig, window: int = 0, q_offset: int = 0):
    """Causal self-attention: the reference's dense branch."""
    t, s = q.shape[1], k.shape[1]
    if (
        cfg.attn_impl == "blockwise"
        and t % min(cfg.attn_block_q, t) == 0
        and s % min(cfg.attn_block_kv, s) == 0
        and t > 1
    ):
        raise not_ported("attn_impl='blockwise' (blockwise_sdpa)")
    return _sdpa(q, k, v, causal_mask(t, s, window, offset=q_offset, device=q.device), cfg)


def attention_full(p, x, cfg: ModelConfig, positions, window: int = 0):
    """Full-sequence causal self-attention (forward / prefill)."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = self_attention(q, k, v, cfg, window=window)
    return _heads_out(out, p["wo"])


def attention_decode(p, x, cache, pos: int, cfg: ModelConfig, window: int = 0,
                     ring: bool = False):
    """One-token decode against a pre-allocated KV cache.

    x: (B,1,E); cache: {"k","v"}: (B,S,Hkv,D) holding absolute positions
    0..S-1; ``pos`` is the new token's position (RoPE uses it) and its
    write index, clamped to [0, S-1] as the reference's
    ``dynamic_update_slice`` clamps it: at ``pos >= S`` the token
    overwrites slot S-1 and every slot is valid.  The cache is updated in
    place.  Returns (out (B,1,E), cache)."""
    if ring:
        raise not_ported("ring-buffer decode (griffin local attention)")
    s = cache["k"].shape[1]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k1, v1 = _qkv(p, x, cfg, positions)
    widx = min(max(pos, 0), s - 1)
    cache["k"][:, widx] = k1[:, 0].to(cache["k"].dtype)
    cache["v"][:, widx] = v1[:, 0].to(cache["v"].dtype)
    kj = torch.arange(s, device=x.device)[None, :]
    valid = kj <= pos
    if window > 0:
        valid = valid & (kj > pos - window)
    out = _sdpa(q, cache["k"], cache["v"], valid, cfg)
    return _heads_out(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, generator, d_ff: Optional[int] = None, *,
             device, stack=()) -> dict:
    e = cfg.d_model
    f = d_ff or cfg.d_ff
    kw = dict(device=device, stack=stack)
    if cfg.activation == "squared_relu":
        return {
            "wi": dense_init(generator, (e, f), cfg.dt, **kw),
            "wo": dense_init(generator, (f, e), cfg.dt, **kw),
        }
    return {
        "wg": dense_init(generator, (e, f), cfg.dt, **kw),
        "wi": dense_init(generator, (e, f), cfg.dt, **kw),
        "wo": dense_init(generator, (f, e), cfg.dt, **kw),
    }


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA expands it, ``1 / (1 + exp(-x))``, each
    op rounded to ``x``'s dtype (``torch.sigmoid`` rounds once, and a
    bf16 result then differs in ~30% of elements)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, rounded after each op."""
    return x * sigmoid(x)


def gelu(x):
    """``jax.nn.gelu`` (its default tanh approximation), op for op."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
    return x * cdf


def mlp_apply(p, x, cfg: ModelConfig):
    if cfg.activation == "squared_relu":
        h = torch.square(torch.relu(x @ p["wi"]))
        return h @ p["wo"]
    act = silu if cfg.activation == "silu" else gelu
    g = act(x @ p["wg"])
    h = g * (x @ p["wi"])
    return h @ p["wo"]
