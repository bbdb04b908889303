"""Model assembly of the port: init / forward / loss / prefill / decode.

The port of ``repro.models.model`` for all ten architectures: the
``"attn"`` pattern (dense GQA transformers: qwen3, yi, nemotron,
chameleon; the MoE transformers qwen2-moe and qwen3-moe; whisper's
encoder-decoder), ``"rwkv6"`` and ``"griffin"`` (RecurrentGemma's (R, R,
A) groups and a recurrent tail).  Params are the reference's tree — nested
dicts, and in griffin's groups a list (``groups.rec``), whose layer
leaves are stacked ``(n_layers, ...)`` tensors — and a layer is a view of
each; the layer loop is a Python loop where the reference scans.  The
tree helpers visit dict keys sorted and lists in index order, which is
``jax.tree.flatten``'s order.  Logits are computed in the compute dtype
and only then cast to f32, as the reference's heads do.

Training: ``loss_fn`` is differentiated by ``torch.autograd``.
``forward`` splits each stacked leaf once (``unbind``, whose backward is
one ``stack``) and, when something is differentiated, runs each layer's
block under the config's remat policy (``_maybe_remat``): ``"full"``
recomputes the block in the backward, ``"minimal"`` keeps its weight
products (``aten.mm``) and recomputes the rest, ``"none"`` keeps
everything.  The three give the same bits.

Every entry point takes ``device=``: ``None`` means CUDA (and raises
without a card), ``"cpu"`` runs on the CPU.  A param or state tensor on
another device than the one asked for raises; nothing is moved behind
the caller's back but the host token ids.

An MoE block's aux loss is summed over layers into ``forward``'s second
output and ``loss_fn``'s loss.

Under a mesh (DTensor params and inputs inside ``activate_mesh``) the
same code runs on DTensors: ``param_axes`` and ``serve_state_axes`` give
every leaf's logical axes, the residual stream and the logits are
constrained as the reference constrains them, attention and the
recurrences run on each shard's rows and heads, and ``loss_fn`` picks the
gold logit with a masked sum where the vocab is sharded.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from torch.distributed.tensor import DTensor

from repro_torch import prng
from repro_torch._device import resolve_device

from .config import ModelConfig
from .layers import (
    _heads_out,
    attention_axes,
    _qkv,
    _sdpa,
    attention_cross,
    attention_decode,
    dense_init,
    encode_cross_kv,
    init_attention,
    init_mlp,
    init_moe,
    mlp_apply,
    mlp_axes,
    moe_apply,
    moe_axes,
    ones,
    rms_norm,
    self_attention,
)
from .sharding import constrain, matmul
from .recurrent import (
    init_rglru_block,
    init_rwkv6_cmix,
    init_rwkv6_tmix,
    rglru_block,
    rglru_block_axes,
    rwkv6_cmix,
    rwkv6_cmix_axes,
    rwkv6_tmix,
    rwkv6_tmix_axes,
)


def rms_norm_cfg(x, scale, cfg):
    return rms_norm(x, scale, cfg.norm_eps, stats_only_f32=cfg.norm_stats_only_f32)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block pattern the reference does not know."""
    if cfg.block_pattern not in ("attn", "rwkv6", "griffin"):
        raise ValueError(f"unknown block_pattern {cfg.block_pattern!r}")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of its structure
    in ``rest`` (a leaf there may be anything that is not a dict or a
    list, such as a logical-axes tuple or a sharding)."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.flatten``'s order: dict keys sorted, list
    items in index order."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def _layers(tree) -> list:
    """Every layer of a stacked tree, views of each leaf split once:
    ``unbind``'s backward is one ``stack`` a leaf, where ``n`` indexings
    would add ``n`` full-size gradients."""
    split = tree_map(lambda x: x.unbind(0), tree)
    n = len(tree_leaves(split)[0])
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


def _stack(trees: list):
    """Inverse of :func:`_layers`."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


def _device_for(cfg: ModelConfig, device, *trees) -> torch.device:
    """The device of an entry point's call; every tensor of ``trees``
    must already be there."""
    check_supported(cfg)
    dev = resolve_device(device)
    for tree in trees:
        for leaf in tree_leaves(tree):
            if leaf.device.type != dev.type or (
                dev.index is not None and leaf.device.index != dev.index
            ):
                raise ValueError(
                    f"a tensor of shape {tuple(leaf.shape)} is on {leaf.device}, "
                    f"not on {dev}: move the params and state there first"
                )
    return dev


def _tokens(tokens, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=dev).long()


def _frames(frames, cfg: ModelConfig, dev: torch.device) -> torch.Tensor:
    """An encoder-decoder's frame embeddings (B, n_frames, d_model): host
    arrays are moved to ``dev``; a tensor must be there already."""
    if frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass frames "
                         "(B, n_frames, d_model)")
    if isinstance(frames, torch.Tensor):
        _device_for(cfg, dev, frames)
        return frames
    return torch.as_tensor(frames, device=dev)


def _griffin_depths(cfg: ModelConfig) -> tuple[int, int]:
    """(number of (R, R, A) groups, number of trailing recurrent layers)."""
    n_groups = cfg.n_layers // 3
    return n_groups, cfg.n_layers - 3 * n_groups


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn_block(cfg: ModelConfig, key, kw) -> dict:
    """An attention block, the reference's ``_init_block``: ``split(key,
    8)``, self-attention from ``ks[0]``, the MLP or MoE from ``ks[1]`` and
    (in a decoder) cross-attention from ``ks[2]``."""
    d = cfg.d_model
    ks = prng.split(key, 8)
    p = {
        "norm1": ones((d,), cfg.dt, **kw),
        "attn": init_attention(cfg, ks[0], **kw),
        "norm2": ones((d,), cfg.dt, **kw),
    }
    if cfg.moe is not None:
        p["moe"] = init_moe(cfg, ks[1], **kw)
    else:
        p["mlp"] = init_mlp(cfg, ks[1], **kw)
    if cfg.is_encdec:
        p["norm_x"] = ones((d,), cfg.dt, **kw)
        p["xattn"] = init_attention(cfg, ks[2], cross=True, **kw)
    return p


def _init_rec_block(cfg: ModelConfig, rg_key, mlp_key, kw) -> dict:
    """A griffin recurrent block: the RG-LRU, then an MLP."""
    d = cfg.d_model
    return {
        "norm1": ones((d,), cfg.dt, **kw),
        "rg": init_rglru_block(cfg, rg_key, **kw),
        "norm2": ones((d,), cfg.dt, **kw),
        "mlp": init_mlp(cfg, mlp_key, **kw),
    }


def _init_layers(cfg: ModelConfig, key, device) -> dict:
    """Every decoder block's params, stacked ``(n_layers, ...)`` from the
    layer keys ``split(key, n_layers)`` (the reference's ``_stacked``)."""
    kw = dict(device=device, stack=(cfg.n_layers,))
    keys = prng.split(key, cfg.n_layers)
    d = cfg.d_model
    if cfg.block_pattern == "rwkv6":
        ks = prng.split(keys, 8)
        return {
            "norm1": ones((d,), cfg.dt, **kw),
            "tmix": init_rwkv6_tmix(cfg, ks[0], **kw),
            "norm2": ones((d,), cfg.dt, **kw),
            "cmix": init_rwkv6_cmix(cfg, ks[1], **kw),
        }
    return _init_attn_block(cfg, keys, kw)


def init_params(cfg: ModelConfig, key, device=None) -> dict:
    """The reference's param tree (same paths, shapes, dtypes), drawn from
    ``key`` (:func:`repro_torch.prng.PRNGKey`) down the reference's key
    tree, so every leaf holds ``repro.models.init_params(cfg, key)``'s
    values; on ``device`` (``None`` = CUDA, through the ``threefry_normal``
    kernel, one launch a leaf).  ``device="meta"`` builds the shapes only."""
    check_supported(cfg)
    dev = resolve_device(device)
    k_emb, k_layers, k_head, k_enc, k_tail = prng.split(key, 5)
    params: dict[str, Any] = {
        "embed": dense_init(k_emb, (cfg.vocab_size, cfg.d_model), cfg.dt,
                            in_axis=1, device=dev),
        "final_norm": ones((cfg.d_model,), cfg.dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(k_head, (cfg.d_model, cfg.vocab_size),
                                       cfg.dt, device=dev)
    if cfg.block_pattern == "griffin":
        n_groups, n_tail = _griffin_depths(cfg)
        kw = dict(device=dev, stack=(n_groups,))
        ks = prng.split(prng.split(k_layers, n_groups), 6)
        params["groups"] = {
            "rec": [_init_rec_block(cfg, ks[i], ks[i + 2], kw) for i in range(2)],
            "attn": {
                "norm1": ones((cfg.d_model,), cfg.dt, **kw),
                "attn": init_attention(cfg, ks[4], **kw),
                "norm2": ones((cfg.d_model,), cfg.dt, **kw),
                "mlp": init_mlp(cfg, ks[5], **kw),
            },
        }
        if n_tail:
            params["tail"] = _init_rec_block(cfg, *prng.split(prng.split(k_tail, n_tail), 2),
                                             dict(device=dev, stack=(n_tail,)))
    else:
        params["layers"] = _init_layers(cfg, k_layers, dev)
    if cfg.is_encdec:
        enc_cfg = cfg.with_(use_qk_norm=False)
        n_enc = cfg.encoder.n_layers
        kw = dict(device=dev, stack=(n_enc,))
        keys = prng.split(k_enc, n_enc)
        params["enc_layers"] = {
            "norm1": ones((cfg.d_model,), cfg.dt, **kw),
            "attn": init_attention(enc_cfg, keys, **kw),
            "norm2": ones((cfg.d_model,), cfg.dt, **kw),
            "mlp": init_mlp(enc_cfg, prng.fold_in(keys, 1), **kw),
        }
        params["enc_norm"] = ones((cfg.d_model,), cfg.dt, device=dev)
    return params


# ---------------------------------------------------------------------------
# logical axes (the sharding rules' input)
# ---------------------------------------------------------------------------


def _block_axes(cfg: ModelConfig) -> dict:
    if cfg.block_pattern == "rwkv6":
        return {
            "norm1": (None,),
            "tmix": rwkv6_tmix_axes(),
            "norm2": (None,),
            "cmix": rwkv6_cmix_axes(),
        }
    a = {
        "norm1": (None,),
        "attn": attention_axes(cfg),
        "norm2": (None,),
    }
    if cfg.moe is not None:
        a["moe"] = moe_axes(cfg)
    else:
        a["mlp"] = mlp_axes(cfg)
    if cfg.is_encdec:
        a["norm_x"] = (None,)
        a["xattn"] = attention_axes(cfg, cross=True)
    return a


def _rec_tail_axes(cfg: ModelConfig) -> dict:
    return {
        "norm1": (None,),
        "rg": rglru_block_axes(),
        "norm2": (None,),
        "mlp": mlp_axes(cfg),
    }


def _griffin_group_axes(cfg: ModelConfig) -> dict:
    rec = _rec_tail_axes(cfg)
    return {
        "rec": [rec, rec],
        "attn": {
            "norm1": (None,),
            "attn": attention_axes(cfg),
            "norm2": (None,),
            "mlp": mlp_axes(cfg),
        },
    }


def _stack_axes(axes_tree):
    """Prepend the 'layers' logical axis to every leaf's axes tuple."""
    return tree_map(lambda ax: ("layers", *ax), axes_tree)


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of :func:`init_params`' tree."""
    axes: dict[str, Any] = {
        "embed": ("vocab", "embed"),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if cfg.block_pattern == "griffin":
        axes["groups"] = _stack_axes(_griffin_group_axes(cfg))
        if cfg.n_layers % 3:
            axes["tail"] = _stack_axes(_rec_tail_axes(cfg))
    else:
        axes["layers"] = _stack_axes(_block_axes(cfg))
    if cfg.is_encdec:
        axes["enc_layers"] = _stack_axes(
            {
                "norm1": (None,),
                "attn": attention_axes(cfg),
                "norm2": (None,),
                "mlp": mlp_axes(cfg),
            }
        )
        axes["enc_norm"] = (None,)
    return axes


def serve_state_axes(cfg: ModelConfig, state) -> Any:
    """Logical axes for every serve-state leaf: (layers, batch, ...) with
    kv-head sharding where present."""

    def leaf_axes(x):
        if x.ndim == 5:  # (L, B, S, kv, hd) or rwkv s (L,B,H,hd,hd)
            if x.shape[-1] == x.shape[-2]:
                return ("layers", "batch", "heads", None, None)
            return ("layers", "batch", None, "kv_heads", None)
        if x.ndim == 4:
            return ("layers", "batch", None, None)
        if x.ndim == 3:
            return ("layers", "batch", None)
        return tuple([None] * x.ndim)

    return tree_map(leaf_axes, state)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _head(params, x, cfg: ModelConfig):
    """Logits in the compute dtype, then f32 (the reference's order)."""
    x = rms_norm_cfg(x, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return matmul(x, head).float()


def _rwkv_block(cfg, lp, h, state=None):
    tm, cm = (None, None) if state is None else (state["tmix"], state["cmix"])
    o, tm = rwkv6_tmix(lp["tmix"], rms_norm_cfg(h, lp["norm1"], cfg), cfg, tm)
    h = h + o
    o, cm = rwkv6_cmix(lp["cmix"], rms_norm_cfg(h, lp["norm2"], cfg), cfg, cm)
    return h + o, {"tmix": tm, "cmix": cm}


def _rec_block(cfg, lp, h, state=None):
    """A griffin recurrent block -> (h, {"h", "conv"})."""
    o, state = rglru_block(lp["rg"], rms_norm_cfg(h, lp["norm1"], cfg), cfg, state)
    h = h + o
    return h + mlp_apply(lp["mlp"], rms_norm_cfg(h, lp["norm2"], cfg), cfg), state


def _ffn(cfg, lp, h, sp: bool = False):
    """An attention block's MLP or MoE -> (h, aux loss, or None without MoE).
    ``sp``: the residual stream is T-sharded (sequence parallelism)."""
    h2 = rms_norm_cfg(h, lp["norm2"], cfg)
    if sp:
        h2 = constrain(h2, ("batch", None, None))          # gather T
    if "moe" in lp:
        mo, aux = moe_apply(lp["moe"], h2, cfg)
    else:
        mo, aux = mlp_apply(lp["mlp"], h2, cfg), None
    if sp:
        mo = constrain(mo, ("batch", "seq_sp", None))      # reduce-scatter
    return h + mo, aux


def _attn_block(cfg, lp, h, positions, enc_out=None):
    """An attention block over the whole sequence -> (h, aux or None,
    its self-attention K/V, its cross-attention K/V or None).

    Under sequence parallelism the residual stream and the norms live
    T-sharded over the model axis; the constraints bracket attention and
    the MLP with a gather and a reduce-scatter (identities without a
    mesh)."""
    sp = cfg.seq_parallel
    if sp:
        h = constrain(h, ("batch", "seq_sp", None))
    hin = rms_norm_cfg(h, lp["norm1"], cfg)
    if sp:
        hin = constrain(hin, ("batch", None, None))
    q, k, v = _qkv(lp["attn"], hin, cfg, positions)
    k = constrain(k, ("batch", None, "kv_heads", None))
    v = constrain(v, ("batch", None, "kv_heads", None))
    att = _heads_out(self_attention(q, k, v, cfg, window=cfg.attn_window), lp["attn"]["wo"])
    if sp:
        att = constrain(att, ("batch", "seq_sp", None))
    h = h + att
    xkv = None
    if enc_out is not None:
        xh = rms_norm_cfg(h, lp["norm_x"], cfg)
        if sp:
            xh = constrain(xh, ("batch", None, None))
        xkv = encode_cross_kv(lp["xattn"], enc_out, cfg)
        xo = attention_cross(lp["xattn"], xh, xkv, cfg)
        h = h + (constrain(xo, ("batch", "seq_sp", None)) if sp else xo)
    h, aux = _ffn(cfg, lp, h, sp)
    return h, aux, {"k": k, "v": v}, xkv


def _embed(params, tokens, cfg: ModelConfig):
    """The token embeddings in the compute dtype, batch-sharded under a
    mesh.  A row lookup (``embedding``): its backward sums a token's
    rows as DTensor's vocab-sharded lookup does on every torch version."""
    return constrain(torch.nn.functional.embedding(tokens, params["embed"]).to(cfg.dt),
                     ("batch", None, None))


def _positions(b: int, t: int, dev) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=dev)[None, :].expand(b, t)


def _ring_layout(kv: dict, t: int, win: int) -> dict:
    """Prefill's K/V as a ring of ``win`` slots: slot j holds the position
    p with p % win == j, so decode (write index pos % win) continues
    seamlessly; a prompt shorter than the window sits at slots 0..t-1."""
    if t >= win:
        return {n: torch.roll(a[:, -win:], t % win, dims=1) for n, a in kv.items()}
    return {n: torch.cat([a, a.new_zeros((a.shape[0], win - t, *a.shape[2:]))], dim=1)
            for n, a in kv.items()}


# ---------------------------------------------------------------------------
# backward-dtype barrier and remat policy
# ---------------------------------------------------------------------------


class _GradToBf16(torch.autograd.Function):
    """Identity whose cotangent is cast to bf16 — stops the f32 loss
    cotangent from promoting the whole backward pass to f32."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def _grad_to_bf16(x):
    return _GradToBf16.apply(x)


#: what ``remat="minimal"`` keeps: the weight products, the counterpart of
#: ``dots_with_no_batch_dims_saveable`` (attention's batched einsums run
#: as ``bmm`` and are recomputed).
_SAVED_UNDER_MINIMAL = [torch.ops.aten.mm.default]


def _maybe_remat(fn, cfg: ModelConfig):
    """A block ``fn(h, lp)`` under the config's remat policy.  Where
    nothing is differentiated, nothing is saved, so ``fn`` runs plain."""
    if cfg.remat == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "minimal":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _SAVED_UNDER_MINIMAL)

    def wrapped(h, lp):
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in [h, *tree_leaves(lp)])):
            return fn(h, lp)
        return checkpoint(fn, h, lp, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def _encode(params, frames, cfg: ModelConfig):
    """The whisper encoder over given frame embeddings (the reference's
    stub frontend): bidirectional self-attention with RoPE over frame
    positions, no mask."""
    x = frames.to(cfg.dt)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)

    def block(h, lp):
        hin = rms_norm_cfg(h, lp["norm1"], cfg)
        q, k, v = _qkv(lp["attn"], hin, cfg, positions)
        h = h + _heads_out(_sdpa(q, k, v, None, cfg), lp["attn"]["wo"])
        return h + mlp_apply(lp["mlp"], rms_norm_cfg(h, lp["norm2"], cfg), cfg)

    block = _maybe_remat(block, cfg)
    for lp in _layers(params["enc_layers"]):
        x = block(x, lp)
    return rms_norm_cfg(x, params["enc_norm"], cfg)


def forward(params, tokens, cfg: ModelConfig, frames=None, device=None):
    """Full-sequence causal forward -> (logits (B, T, V) f32, aux loss f32:
    the MoE blocks' summed, else 0).  An encoder-decoder needs ``frames``
    (B, n_frames, d_model); other models ignore them."""
    dev = _device_for(cfg, device, params)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = _positions(b, t, dev)
    enc_out = _encode(params, _frames(frames, cfg, dev), cfg) if cfg.is_encdec else None
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    if cfg.block_pattern == "griffin":
        def group(h, gp):
            for rp in gp["rec"]:
                h = _rec_block(cfg, rp, h)[0]
            return _attn_block(cfg, gp["attn"], h, positions)[0]

        group = _maybe_remat(group, cfg)
        for gp in _layers(params["groups"]):
            x = group(x, gp)
        if "tail" in params:
            tail = _maybe_remat(lambda h, rp: _rec_block(cfg, rp, h)[0], cfg)
            for rp in _layers(params["tail"]):
                x = tail(x, rp)
    elif cfg.block_pattern == "rwkv6":
        block = _maybe_remat(lambda h, lp: _rwkv_block(cfg, lp, h)[0], cfg)
        for lp in _layers(params["layers"]):
            x = block(x, lp)
    else:
        block = _maybe_remat(lambda h, lp: _attn_block(cfg, lp, h, positions, enc_out)[:2],
                             cfg)
        for lp in _layers(params["layers"]):
            x, a = block(x, lp)
            if a is not None:
                aux = aux + a
    if cfg.seq_parallel:
        x = constrain(x, ("batch", None, None))
    if cfg.bwd_bf16:
        x = _grad_to_bf16(x)
    return constrain(_head(params, x, cfg), ("batch", None, "vocab")), aux


def loss_fn(params, batch, cfg: ModelConfig, device=None):
    """Cross-entropy LM loss. batch: {"tokens", "labels"[, "frames"]}.
    Returns ``(nll + aux, {"nll", "aux"})``, f32 scalars."""
    logits, aux = forward(params, batch["tokens"], cfg, batch.get("frames"), device=device)
    labels = _tokens(batch["labels"], logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # DTensor cannot gather along the vocab-sharded dim: pick the gold
        # logit by a masked sum, exact (every other term is +0.0)
        hit = torch.arange(logits.shape[-1], device=labels.device) == labels[..., None]
        gold = torch.where(hit, logits, 0.0).sum(dim=-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    # batch-sharded per token, so the mean's gradient stays sharded too
    nll = constrain(logz - gold, ("batch", None)).mean()
    return nll + aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving: state init / decode / prefill
# ---------------------------------------------------------------------------


def init_serve_state(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    """Zero-initialized decode state, the reference's tree.  Griffin's
    local attention keeps a ring of ``min(attn_window or cache_len,
    cache_len)`` slots; an encoder-decoder also holds its cross-attention
    K/V over ``encoder.n_frames`` frames."""
    check_supported(cfg)
    dev = resolve_device(device)
    n, d = cfg.n_layers, cfg.d_model

    def zeros(shape, dtype=cfg.dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def kv(layers, length):
        shape = (layers, batch, length, cfg.n_kv_heads, cfg.dhead)
        return {"k": zeros(shape), "v": zeros(shape)}

    def rec(layers):
        return {"h": zeros((layers, batch, d), torch.float32),
                "conv": zeros((layers, batch, cfg.conv1d_width - 1, d))}

    if cfg.block_pattern == "rwkv6":
        hs = cfg.rwkv_head_size
        return {
            "layers": {
                "tmix": {"s": zeros((n, batch, d // hs, hs, hs), torch.float32),
                         "x_prev": zeros((n, batch, d))},
                "cmix": {"x_prev": zeros((n, batch, d))},
            }
        }
    if cfg.block_pattern == "griffin":
        n_groups, n_tail = _griffin_depths(cfg)
        win = min(cfg.attn_window or cache_len, cache_len)
        state = {"groups": {"rec": [rec(n_groups) for _ in range(2)],
                            "attn": kv(n_groups, win)}}
        if n_tail:
            state["tail"] = rec(n_tail)
        return state
    state = {"layers": kv(n, cache_len)}
    if cfg.is_encdec:
        state["cross_kv"] = kv(n, cfg.encoder.n_frames)
    return state


def decode_step(params, token, pos: int, state, cfg: ModelConfig, device=None):
    """One-token decode.  token: (B, 1) ids; pos: the number of tokens
    already in the state (also the KV cache's write index; griffin's ring
    writes at ``pos % window``).

    Returns (logits (B, V) f32, new_state); ``state`` is left unchanged."""
    dev = _device_for(cfg, device, params, state)
    x = _embed(params, _tokens(token, dev), cfg)
    pos = int(pos)
    if cfg.block_pattern == "rwkv6":
        new = []
        for lp, st in zip(_layers(params["layers"]), _layers(state["layers"])):
            x, st = _rwkv_block(cfg, lp, x, st)
            new.append(st)
        new_state = {"layers": _stack(new)}
    elif cfg.block_pattern == "griffin":
        ring = {n: a.clone() for n, a in state["groups"]["attn"].items()}
        rec = []
        # the per-group views write through to ``ring``
        for gp, sts, cache in zip(_layers(params["groups"]),
                                  _layers(state["groups"]["rec"]), _layers(ring)):
            new = []
            for rp, st in zip(gp["rec"], sts):
                x, st = _rec_block(cfg, rp, x, st)
                new.append(st)
            rec.append(new)
            ap = gp["attn"]
            o, _ = attention_decode(ap["attn"], rms_norm_cfg(x, ap["norm1"], cfg), cache,
                                    pos, cfg, ring=True)
            x = _ffn(cfg, ap, x + o)[0]
        new_state = {"groups": {"rec": _stack(rec), "attn": ring}}
        if "tail" in params:
            tail = []
            for rp, st in zip(_layers(params["tail"]), _layers(state["tail"])):
                x, st = _rec_block(cfg, rp, x, st)
                tail.append(st)
            new_state["tail"] = _stack(tail)
    else:
        kv = {n: a.clone() for n, a in state["layers"].items()}
        layers = _layers(params["layers"])
        cross = _layers(state["cross_kv"]) if cfg.is_encdec else [None] * len(layers)
        # the per-layer views write through to ``kv``
        for lp, cache, xkv in zip(layers, _layers(kv), cross):
            o, _ = attention_decode(lp["attn"], rms_norm_cfg(x, lp["norm1"], cfg),
                                    cache, pos, cfg, window=cfg.attn_window)
            x = x + o
            if xkv is not None:
                x = x + attention_cross(lp["xattn"], rms_norm_cfg(x, lp["norm_x"], cfg),
                                        xkv, cfg)
            x = _ffn(cfg, lp, x)[0]
        new_state = {**state, "layers": kv}
    return _head(params, x, cfg)[:, 0, :], new_state


def prefill(params, tokens, cfg: ModelConfig, frames=None, device=None):
    """Full forward that also materializes the serve state.

    Returns (last-token logits (B, V) f32, state).  For attention models
    the KV cache length equals the prompt length (the serving engine
    copies it into a cache sized for the whole output); an
    encoder-decoder's state also holds each layer's cross-attention K/V,
    computed here once from ``frames``.  Griffin's local attention leaves
    a ring of ``attn_window or T`` slots (``_ring_layout``)."""
    dev = _device_for(cfg, device, params)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = _positions(b, t, dev)
    enc_out = _encode(params, _frames(frames, cfg, dev), cfg) if cfg.is_encdec else None
    if cfg.block_pattern == "rwkv6":
        states = []
        for lp in _layers(params["layers"]):
            x, st = _rwkv_block(cfg, lp, x)
            states.append(st)
        state = {"layers": _stack(states)}
    elif cfg.block_pattern == "griffin":
        win = cfg.attn_window or t
        groups = []
        for gp in _layers(params["groups"]):
            rec = []
            for rp in gp["rec"]:
                x, st = _rec_block(cfg, rp, x)
                rec.append(st)
            x, _, kv, _ = _attn_block(cfg, gp["attn"], x, positions)
            groups.append({"rec": rec, "attn": _ring_layout(kv, t, win)})
        state = {"groups": _stack(groups)}
        if "tail" in params:
            tail = []
            for rp in _layers(params["tail"]):
                x, st = _rec_block(cfg, rp, x)
                tail.append(st)
            state["tail"] = _stack(tail)
    else:
        states, cross = [], []
        for lp in _layers(params["layers"]):
            x, _, kv, xkv = _attn_block(cfg, lp, x, positions, enc_out)
            states.append(kv)
            cross.append(xkv)
        state = {"layers": _stack(states)}
        if cfg.is_encdec:
            state["cross_kv"] = _stack(cross)
    logits = _head(params, x[:, -1:, :], cfg)[:, 0, :]
    return logits, state


__all__ = [
    "check_supported",
    "decode_step",
    "forward",
    "init_params",
    "init_serve_state",
    "loss_fn",
    "param_axes",
    "prefill",
    "serve_state_axes",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]
