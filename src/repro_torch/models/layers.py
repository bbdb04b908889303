"""Core neural layers of the port: norms, RoPE, GQA attention, MLP variants.

The port of ``repro.models.layers``: the dense and local-window GQA
attention (self, ring-buffer decode and cross), the MLP variants and the
capacity-bounded top-k MoE.  Params are nested dicts of tensors;
``init_*`` builds them, stacked along leading ``stack`` dims (the layer
axis), from an explicit ``torch.Generator``.

Every apply function mirrors the JAX expression op for op, in the same
dtypes, so the rounding points are the reference's: the compute dtype
follows ``cfg.dt`` (bf16 by default), an einsum's output is rounded to
it, and only the norms, RoPE and the softmax run in f32.  The attention
is plain tensor ops, not ``scaled_dot_product_attention``: the reference
rounds the scores to the compute dtype before the f32 softmax and the
probabilities to it before the PV product, which a fused kernel does not.

Waiting for a later slice: ``blockwise_sdpa`` (``ROADMAP.md`` Queue 2
a4) and the MoE's ``shard_map`` dispatch, which only a mesh reaches
(Queue 1 item 4; the port has no mesh, so ``moe_apply`` always takes the
reference's one-device scatter path).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .config import ModelConfig

#: what a caller that reaches code not ported yet is told.
WAITS = "not ported yet: {what} waits for ROADMAP.md {item}"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(WAITS.format(what=what, item=item))


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


def init_attention(cfg: ModelConfig, generator, cross: bool = False, *, device,
                   stack=()) -> dict:
    e, hd = cfg.d_model, cfg.dhead
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    kw = dict(device=device, stack=stack)
    p = {
        "wq": dense_init(generator, (e, nh, hd), cfg.dt, **kw),
        "wk": dense_init(generator, (e, nkv, hd), cfg.dt, **kw),
        "wv": dense_init(generator, (e, nkv, hd), cfg.dt, **kw),
        "wo": dense_init(generator, (nh, hd, e), cfg.dt, in_axis=(0, 1), **kw),
    }
    if cfg.use_qk_norm and not cross:
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


def _qkv(p, x, cfg: ModelConfig, positions, x_kv=None, kv_positions=None,
         use_rope: bool = True):
    """q from ``x``, k and v from ``x_kv`` (default ``x``: self-attention),
    RoPE'd at ``positions`` and ``kv_positions`` (default ``positions``)."""
    x_kv = x if x_kv is None else x_kv
    q = _proj_heads(x, p["wq"])
    k = _proj_heads(x_kv, p["wk"])
    v = _proj_heads(x_kv, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions if kv_positions is None else kv_positions, cfg.rope_theta)
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
        raise not_ported("attn_impl='blockwise' (blockwise_sdpa)", "Queue 2 a4")
    return _sdpa(q, k, v, causal_mask(t, s, window, offset=q_offset, device=q.device), cfg)


def attention_full(p, x, cfg: ModelConfig, positions, window: int = 0):
    """Full-sequence causal self-attention (forward / prefill)."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = self_attention(q, k, v, cfg, window=window)
    return _heads_out(out, p["wo"])


def attention_decode(p, x, cache, pos: int, cfg: ModelConfig, window: int = 0,
                     ring: bool = False):
    """One-token decode against a pre-allocated KV cache.

    x: (B,1,E); cache: {"k","v"}: (B,S,Hkv,D); ``pos`` is the new token's
    position (RoPE uses it).  The cache is updated in place.

    ``ring=False``: the cache holds absolute positions 0..S-1 and ``pos``
    is the write index, clamped to [0, S-1] as the reference's
    ``dynamic_update_slice`` clamps it: at ``pos >= S`` the token
    overwrites slot S-1 and every slot is valid.

    ``ring=True`` (griffin's local attention): the cache is a rolling
    window of the last S positions, the write index is ``pos % S``, and
    every slot written so far is valid (slot j once ``j <= pos``, all of
    them once ``pos >= S``).

    Returns (out (B,1,E), cache)."""
    s = cache["k"].shape[1]
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k1, v1 = _qkv(p, x, cfg, positions)
    widx = pos % s if ring else min(max(pos, 0), s - 1)
    cache["k"][:, widx] = k1[:, 0].to(cache["k"].dtype)
    cache["v"][:, widx] = v1[:, 0].to(cache["v"].dtype)
    kj = torch.arange(s, device=x.device)[None, :]
    valid = kj <= pos
    if ring:
        valid = valid | (pos >= s)
    elif window > 0:
        valid = valid & (kj > pos - window)
    out = _sdpa(q, cache["k"], cache["v"], valid, cfg)
    return _heads_out(out, p["wo"]), cache


def attention_cross(p, x, enc_kv, cfg: ModelConfig):
    """Cross-attention against precomputed encoder K/V (the whisper
    decoder): no RoPE, no mask."""
    q = _proj_heads(x, p["wq"])
    out = _sdpa(q, enc_kv["k"], enc_kv["v"], None, cfg)
    return _heads_out(out, p["wo"])


def encode_cross_kv(p, enc_out, cfg: ModelConfig) -> dict:
    return {"k": _proj_heads(enc_out, p["wk"]), "v": _proj_heads(enc_out, p["wv"])}


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


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-bounded scatter dispatch)
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, generator, *, device, stack=()) -> dict:
    m = cfg.moe
    e, f = cfg.d_model, m.expert_d_ff
    ep = m.n_experts_padded   # GShard-style padding for even EP sharding
    kw = dict(device=device, stack=stack)
    p = {
        "router": dense_init(generator, (e, ep), torch.float32, **kw),
        "wg": dense_init(generator, (ep, e, f), cfg.dt, in_axis=1, **kw),
        "wi": dense_init(generator, (ep, e, f), cfg.dt, in_axis=1, **kw),
        "wo": dense_init(generator, (ep, f, e), cfg.dt, in_axis=1, **kw),
    }
    if m.n_shared_experts:
        p["shared"] = init_mlp(cfg, generator, d_ff=m.n_shared_experts * f, **kw)
    return p


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Routed slots each expert takes from ``s`` tokens: ``ceil(s*k/E *
    capacity_factor)`` over the unpadded expert count E, in Python floats.
    In decode s = B, so at B = 4 both MoE configs keep one slot an expert
    and drop the rest, as the reference does."""
    m = cfg.moe
    return int(math.ceil(s * m.experts_per_token / m.n_experts * m.capacity_factor))


def moe_route(p, xt, cfg: ModelConfig) -> dict:
    """The router of :func:`moe_apply` over tokens ``xt`` (S, D):
    ``probs`` (S, Ep) f32, the top-k ``ids`` and ``weights`` (S, k), each
    routed slot's ``slot`` in its expert's queue and whether it is kept
    (``keep``, both (S*k,), token-major), ``cap`` and the aux loss.

    The reference's expressions: the router product in f32 (TF32 must be
    off on the card, or routing choices flip), padded experts masked to
    -1e30 before the softmax, ``lax.top_k``'s order (on ties the lower
    expert first: a stable descending sort, which ``torch.topk`` does not
    promise), slots from an integer cumsum."""
    m = cfg.moe
    ep, k = m.n_experts_padded, m.experts_per_token
    logits = xt.float() @ p["router"].float()                  # (S, Ep)
    if ep != m.n_experts:   # padded experts never win routing
        pad = torch.arange(ep, device=xt.device) >= m.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    z = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = z / z.sum(dim=-1, keepdim=True)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[:, :k], top_ids[:, :k]              # (S, k)
    if m.norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # load-balancing auxiliary loss (Switch/GShard form)
    density = torch.nn.functional.one_hot(top_ids[:, 0], ep).float().mean(dim=0)
    aux = m.router_aux_coef * m.n_experts * torch.sum(density * probs.mean(dim=0))

    cap = moe_capacity(cfg, xt.shape[0])
    flat_ids = top_ids.reshape(-1)
    # position of each (token, slot) within its expert queue
    one_hot = torch.nn.functional.one_hot(flat_ids, ep)
    slot = torch.cumsum(one_hot, dim=0).gather(1, flat_ids[:, None])[:, 0] - 1
    return {"probs": probs, "ids": top_ids, "weights": top_w, "slot": slot,
            "keep": slot < cap, "cap": cap, "aux": aux}


def moe_apply(p, x, cfg: ModelConfig):
    """Top-k MoE with capacity-bounded scatter dispatch (GShard
    semantics): each expert takes at most :func:`moe_capacity` of the S =
    B*T tokens' routed slots, in token-major order, and drops the rest.
    Returns (out, aux_loss f32).

    The reference's one-device branch, op for op (routing in
    :func:`moe_route`).  Every expert runs its SwiGLU over all ``cap``
    slots, empty ones included.  Kept tokens have unique (expert, slot)
    pairs, so the dispatch is a plain index write; dropped ones are
    written to a spare slot ``cap`` that is cut off, which keeps it free
    of host syncs and of nondeterministic accumulation."""
    ep, k = cfg.moe.n_experts_padded, cfg.moe.experts_per_token
    b, t, e = x.shape
    s = b * t
    xt = x.reshape(s, e)
    r = moe_route(p, xt, cfg)
    cap, keep, slot = r["cap"], r["keep"], r["slot"]
    flat_ids, flat_w = r["ids"].reshape(-1), r["weights"].reshape(-1)
    slot_c = torch.where(keep, slot, 0)

    xe = xt.repeat_interleave(k, dim=0)                        # (S*k, D)
    spare = torch.zeros((ep, cap + 1, e), dtype=x.dtype, device=x.device)
    dispatched = spare.index_put((flat_ids, torch.where(keep, slot, cap)), xe)[:, :cap]

    g = silu(torch.bmm(dispatched, p["wg"]))
    h = g * torch.bmm(dispatched, p["wi"])
    out_e = torch.bmm(h, p["wo"])                              # (Ep, cap, D)

    gathered = out_e[flat_ids, slot_c]                         # (S*k, D)
    gathered = torch.where(keep[:, None], gathered, 0)
    combined = (gathered * flat_w[:, None].to(gathered.dtype)).reshape(s, k, e).sum(dim=1)
    out = combined.reshape(b, t, e)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg)
    return out, r["aux"]
