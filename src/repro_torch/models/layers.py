"""Core neural layers of the port: norms, RoPE, GQA attention, MLP variants.

The port of ``repro.models.layers``: the dense and local-window GQA
attention (self, ring-buffer decode and cross), the MLP variants and the
capacity-bounded top-k MoE.  Params are nested dicts of tensors;
``init_*`` builds them, stacked along leading ``stack`` dims (the layer
axis), from ``jax.random``-style keys (:mod:`repro_torch.prng`): one key
a slice of the stack, split as the reference splits them, so every leaf
holds the reference's draws.

Every apply function mirrors the JAX expression op for op, in the same
dtypes, so the rounding points are the reference's: the compute dtype
follows ``cfg.dt`` (bf16 by default), an einsum's output is rounded to
it, and only the norms, RoPE and the softmax run in f32.  The attention
is plain tensor ops, not ``scaled_dot_product_attention``: the reference
rounds the scores to the compute dtype before the f32 softmax and the
probabilities to it before the PV product, which a fused kernel does not.

Under a mesh (:mod:`repro_torch.models.sharding`) the same functions run
on DTensors: ``constrain`` lays out the reference's constrained
intermediates, ``reshape`` keeps head splits local to a shard, and the
MoE's ``shard_map`` dispatch runs per shard
(:mod:`repro_torch.models.moe_shardmap`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import prng

from .config import ModelConfig
from .sharding import (
    active_mesh,
    axis_names,
    axis_size,
    constrain,
    local_region,
    matmul,
    reshape,
)

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(key, shape, dtype, in_axis=0, *, device, stack=()) -> torch.Tensor:
    """``jax.random.normal(key, shape, f32) * std`` cast to ``dtype``, the
    reference's ``dense_init``: ``std = 1/sqrt(fan_in)`` in Python float
    (taken as f32 by the multiply), ``fan_in`` is ``shape``'s ``in_axis``
    extent (or the product over a tuple of axes).  ``key`` holds one key a
    slice of the leading ``stack`` dims, (*stack, 2); the whole stack is
    one draw of :func:`repro_torch.prng.normal`."""
    if tuple(np.shape(key)) != (*stack, 2):
        raise ValueError(f"dense_init of stack {tuple(stack)} needs keys of shape "
                         f"{(*stack, 2)}, got {np.shape(key)}")
    axes = (in_axis,) if isinstance(in_axis, int) else in_axis
    fan_in = int(np.prod([shape[a] for a in axes]))
    std = 1.0 / math.sqrt(fan_in)
    return prng.normal(key, shape, dtype, std=std, device=device)


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


def init_attention(cfg: ModelConfig, key, cross: bool = False, *, device,
                   stack=()) -> dict:
    e, hd = cfg.d_model, cfg.dhead
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    kw = dict(device=device, stack=stack)
    ks = prng.split(key, 6)
    p = {
        "wq": dense_init(ks[0], (e, nh, hd), cfg.dt, **kw),
        "wk": dense_init(ks[1], (e, nkv, hd), cfg.dt, **kw),
        "wv": dense_init(ks[2], (e, nkv, hd), cfg.dt, **kw),
        "wo": dense_init(ks[3], (nh, hd, e), cfg.dt, in_axis=(0, 1), **kw),
    }
    if cfg.use_qk_norm and not cross:
        p["q_norm"] = ones((hd,), cfg.dt, **kw)
        p["k_norm"] = ones((hd,), cfg.dt, **kw)
    return p


def attention_axes(cfg: ModelConfig, cross: bool = False) -> dict:
    a = {
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv_heads", None),
        "wv": ("embed", "kv_heads", None),
        "wo": ("heads", None, "embed"),
    }
    if cfg.use_qk_norm and not cross:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


def _proj_heads(x, w):
    """einsum ``"btd,dhk->bthk"`` as one matmul."""
    d, h, k = w.shape
    return reshape(matmul(x, reshape(w, d, h * k)), *x.shape[:-1], h, k)


def _heads_out(x, w):
    """einsum ``"bthd,hde->bte"`` as one matmul."""
    h, d, e = w.shape
    return matmul(reshape(x, *x.shape[:-2], h * d), reshape(w, h * d, e))


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


def _per_shard_heads(fn):
    """``fn(q, k, v, *rest)`` (an attention over (B, T, H, D) heads) run on
    each shard's batch rows and heads under a mesh: attention needs no
    communication.  Where the KV heads are replicated but the query heads
    sharded (fewer KV heads than the model axis), each shard takes the KV
    heads its query heads read."""

    def body(q, k, v, *rest, hq, hkv, rank):
        hq_loc, hkv_loc = q.shape[2], k.shape[2]
        if hkv_loc == hkv and hq_loc < hq:
            g = hq // hkv
            lo, hi = rank * hq_loc // g, ((rank + 1) * hq_loc - 1) // g + 1
            k, v = k[:, :, lo:hi], v[:, :, lo:hi]
        return fn(q, k, v, *rest)

    def wrapped(q, k, v, *rest):
        mesh = active_mesh()
        if mesh is None or not isinstance(q, DTensor):
            return fn(q, k, v, *rest)
        rank = mesh.get_local_rank("model") if "model" in axis_names(mesh) else 0
        heads, kv = ("batch", None, "heads", None), ("batch", None, "kv_heads", None)
        rest_axes = tuple((None,) * r.ndim if isinstance(r, torch.Tensor) else None
                          for r in rest)
        region = local_region(
            functools.partial(body, hq=q.shape[2], hkv=k.shape[2], rank=rank),
            (heads, kv, kv, *rest_axes), (heads,))
        return region(q, k, v, *rest)

    return functools.wraps(fn)(wrapped)


@_per_shard_heads
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


def _dot_f32(spec: str, a, b):
    """An einsum with f32 products and accumulation (XLA's
    ``preferred_element_type=f32``): bf16 operands are widened exactly
    first."""
    return torch.einsum(spec, a.float(), b.float())


def blockwise_sdpa(q, k, v, cfg: ModelConfig, window: int = 0, q_offset: int = 0):
    """Flash-style streaming attention, the reference's jnp program.

    Query blocks of ``attn_block_q`` rows, each with an online softmax
    (running max ``m``, denominator ``l``, f32 accumulator) over every KV
    block of ``attn_block_kv`` rows in order, so the (T, S) scores are
    never materialized.  Scores and the PV product are f32 (bf16 operands
    widened), masked to -1e30 by masks built from block indices (causal,
    ``window``, ``q_offset``); probabilities are rounded to ``v.dtype``
    before the PV product; the output divides by ``max(l, 1e-30)``.  When
    something is differentiated each query block's body is recomputed in
    the backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint``),
    keeping residuals at O(T*D)."""
    return _blockwise(q, k, v, cfg, window, q_offset)


@_per_shard_heads
def _blockwise(q, k, v, cfg: ModelConfig, window: int, q_offset: int):
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bq = min(cfg.attn_block_q, t)
    bk = min(cfg.attn_block_kv, s)
    assert t % bq == 0 and s % bk == 0, (t, s, bq, bk)
    nq, nk = t // bq, s // bk
    scale = 1.0 / math.sqrt(d)
    qb = q.reshape(b, nq, bq, hkv, g, d)
    kb = k.reshape(b, nk, bk, hkv, d)
    vb = v.reshape(b, nk, bk, hkv, d)

    def one_q_block(q_blk, kb, vb, qi):
        qpos = q_offset + qi * bq + torch.arange(bq, device=q.device)
        m = torch.full((b, hkv, g, bq), -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kpos = kj * bk + torch.arange(bk, device=q.device)
            sc = _dot_f32("bqhgd,bkhd->bhgqk", q_blk, kb[:, kj]) * scale
            valid = kpos[None, :] <= qpos[:, None]
            if window > 0:
                valid &= kpos[None, :] > qpos[:, None] - window
            sc = torch.where(valid, sc, -1e30)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = _dot_f32("bhgqk,bkhd->bhgqd", p.to(v.dtype), vb[:, kj])
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4).to(q.dtype)          # (b,bq,hkv,g,d)

    remat = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    blocks = []
    for qi in range(nq):
        if remat:
            blocks.append(checkpoint(one_q_block, qb[:, qi], kb, vb, qi,
                                     use_reentrant=False, preserve_rng_state=False))
        else:
            blocks.append(one_q_block(qb[:, qi], kb, vb, qi))
    return torch.stack(blocks, dim=1).reshape(b, t, hq, d)


def self_attention(q, k, v, cfg: ModelConfig, window: int = 0, q_offset: int = 0):
    """Causal self-attention dispatch: dense vs blockwise per config (the
    blockwise path needs t > 1 and block sizes that divide the lengths)."""
    t, s = q.shape[1], k.shape[1]
    if (
        cfg.attn_impl == "blockwise"
        and t % min(cfg.attn_block_q, t) == 0
        and s % min(cfg.attn_block_kv, s) == 0
        and t > 1
    ):
        return blockwise_sdpa(q, k, v, cfg, window=window, q_offset=q_offset)
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


def init_mlp(cfg: ModelConfig, key, d_ff: Optional[int] = None, *,
             device, stack=()) -> dict:
    e = cfg.d_model
    f = d_ff or cfg.d_ff
    kw = dict(device=device, stack=stack)
    ks = prng.split(key, 3)
    if cfg.activation == "squared_relu":
        return {
            "wi": dense_init(ks[0], (e, f), cfg.dt, **kw),
            "wo": dense_init(ks[1], (f, e), cfg.dt, **kw),
        }
    return {
        "wg": dense_init(ks[0], (e, f), cfg.dt, **kw),
        "wi": dense_init(ks[1], (e, f), cfg.dt, **kw),
        "wo": dense_init(ks[2], (f, e), cfg.dt, **kw),
    }


def mlp_axes(cfg: ModelConfig) -> dict:
    if cfg.activation == "squared_relu":
        return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    return {
        "wg": ("embed", "mlp"),
        "wi": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
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
        h = torch.square(torch.relu(matmul(x, p["wi"])))
        return matmul(h, p["wo"])
    act = silu if cfg.activation == "silu" else gelu
    g = act(matmul(x, p["wg"]))
    h = constrain(g * matmul(x, p["wi"]), ("batch", None, "mlp"))
    return matmul(h, p["wo"])


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-bounded scatter dispatch)
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, key, *, device, stack=()) -> dict:
    m = cfg.moe
    e, f = cfg.d_model, m.expert_d_ff
    ep = m.n_experts_padded   # GShard-style padding for even EP sharding
    kw = dict(device=device, stack=stack)
    ks = prng.split(key, 5)
    p = {
        "router": dense_init(ks[0], (e, ep), torch.float32, **kw),
        "wg": dense_init(ks[1], (ep, e, f), cfg.dt, in_axis=1, **kw),
        "wi": dense_init(ks[2], (ep, e, f), cfg.dt, in_axis=1, **kw),
        "wo": dense_init(ks[3], (ep, f, e), cfg.dt, in_axis=1, **kw),
    }
    if m.n_shared_experts:
        p["shared"] = init_mlp(cfg, ks[4], d_ff=m.n_shared_experts * f, **kw)
    return p


def moe_axes(cfg: ModelConfig) -> dict:
    a = {
        "router": ("embed", "experts"),
        "wg": ("experts", "embed", "expert_mlp"),
        "wi": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }
    if cfg.moe.n_shared_experts:
        a["shared"] = mlp_axes(cfg)
    return a


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Routed slots each expert takes from ``s`` tokens: ``ceil(s*k/E *
    capacity_factor)`` over the unpadded expert count E, in Python floats.
    In decode s = B, so at B = 4 both MoE configs keep one slot an expert
    and drop the rest, as the reference does."""
    m = cfg.moe
    return int(math.ceil(s * m.experts_per_token / m.n_experts * m.capacity_factor))


def router_probs(router, xt, cfg: ModelConfig):
    """The router over tokens ``xt`` (S, D): ``probs`` (S, Ep) f32 and the
    top-k ``weights`` and ``ids`` (S, k).

    The reference's expressions: the router product in f32 (TF32 must be
    off on the card, or routing choices flip), padded experts masked to
    -1e30 before the softmax, ``lax.top_k``'s order (on ties the lower
    expert first: a stable descending sort, which ``torch.topk`` does not
    promise)."""
    m = cfg.moe
    ep, k = m.n_experts_padded, m.experts_per_token
    logits = xt.float() @ router.float()                       # (S, Ep)
    if ep != m.n_experts:   # padded experts never win routing
        pad = torch.arange(ep, device=xt.device) >= m.n_experts
        logits = torch.where(pad[None, :], -1e30, logits)
    z = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = z / z.sum(dim=-1, keepdim=True)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[:, :k], top_ids[:, :k]              # (S, k)
    if m.norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    return probs, top_w, top_ids


def moe_aux(probs, top_ids, cfg: ModelConfig):
    """The load-balancing auxiliary loss (Switch/GShard form)."""
    m = cfg.moe
    density = torch.nn.functional.one_hot(top_ids[:, 0], m.n_experts_padded).float().mean(dim=0)
    return m.router_aux_coef * m.n_experts * torch.sum(density * probs.mean(dim=0))


def moe_slots(flat_ids, ep: int):
    """Each routed slot's position in its expert's queue, token-major, from
    an integer cumsum."""
    one_hot = torch.nn.functional.one_hot(flat_ids, ep)
    return torch.cumsum(one_hot, dim=0).gather(1, flat_ids[:, None])[:, 0] - 1


def moe_route(p, xt, cfg: ModelConfig) -> dict:
    """The router of :func:`moe_apply` over tokens ``xt`` (S, D):
    ``probs`` (S, Ep) f32, the top-k ``ids`` and ``weights`` (S, k), each
    routed slot's ``slot`` in its expert's queue and whether it is kept
    (``keep``, both (S*k,), token-major), ``cap`` and the aux loss."""
    probs, top_w, top_ids = router_probs(p["router"], xt, cfg)
    cap = moe_capacity(cfg, xt.shape[0])
    slot = moe_slots(reshape(top_ids, -1), cfg.moe.n_experts_padded)
    return {"probs": probs, "ids": top_ids, "weights": top_w, "slot": slot,
            "keep": slot < cap, "cap": cap, "aux": moe_aux(probs, top_ids, cfg)}


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
    of host syncs and of nondeterministic accumulation.

    Under an active mesh that has a ``"model"`` axis dividing the padded
    expert count, ``moe_dispatch="shard_map"`` takes the per-shard
    dispatch (:mod:`repro_torch.models.moe_shardmap`, local capacity);
    the aux loss stays global."""
    ep, k = cfg.moe.n_experts_padded, cfg.moe.experts_per_token
    b, t, e = x.shape
    s = b * t
    xt = reshape(x, s, e)
    if cfg.moe_dispatch == "shard_map":
        from .moe_shardmap import moe_apply_shardmap

        mesh = active_mesh()
        if mesh is not None and "model" in axis_names(mesh) \
                and ep % axis_size(mesh, "model") == 0:
            probs, top_w, top_ids = router_probs(p["router"], xt, cfg)
            combined = moe_apply_shardmap(p, xt, top_w, top_ids, cfg, mesh)
            out = reshape(combined, b, t, e)
            if "shared" in p:
                out = out + mlp_apply(p["shared"], x, cfg)
            return out, moe_aux(probs, top_ids, cfg)
    r = moe_route(p, xt, cfg)
    cap, keep, slot = r["cap"], r["keep"], r["slot"]
    flat_ids, flat_w = reshape(r["ids"], -1), reshape(r["weights"], -1)
    slot_c = torch.where(keep, slot, 0)

    xe = xt.repeat_interleave(k, dim=0)                        # (S*k, D)
    spare = torch.zeros((ep, cap + 1, e), dtype=x.dtype, device=x.device)
    dispatched = spare.index_put((flat_ids, torch.where(keep, slot, cap)), xe)[:, :cap]
    dispatched = constrain(dispatched, ("experts", None, None))

    g = silu(torch.bmm(dispatched, p["wg"]))
    h = g * torch.bmm(dispatched, p["wi"])
    out_e = constrain(torch.bmm(h, p["wo"]), ("experts", None, None))  # (Ep, cap, D)

    gathered = out_e[flat_ids, slot_c]                         # (S*k, D)
    gathered = torch.where(keep[:, None], gathered, 0)
    combined = reshape(gathered * flat_w[:, None].to(gathered.dtype), s, k, e).sum(dim=1)
    out = reshape(combined, b, t, e)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, cfg)
    return out, r["aux"]
