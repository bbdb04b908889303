"""Model assembly of the port: init / forward / loss / prefill / decode.

The port of ``repro.models.model`` for two block patterns: ``"attn"``
(dense GQA transformers: qwen3, yi, nemotron, chameleon) and
``"rwkv6"``.  Params are the reference's tree — a nested dict whose layer
leaves are stacked ``(n_layers, ...)`` tensors — and a layer is a view of
each; the layer loop is a Python loop where the reference scans.  Logits
are computed in the compute dtype and only then cast to f32, as the
reference's heads do.

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

Griffin, MoE and encoder-decoder configs raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch._device import resolve_device

from .config import ModelConfig
from .layers import (
    _heads_out,
    _qkv,
    attention_decode,
    attention_full,
    dense_init,
    init_attention,
    init_mlp,
    mlp_apply,
    not_ported,
    ones,
    rms_norm,
    self_attention,
)
from .recurrent import init_rwkv6_cmix, init_rwkv6_tmix, rwkv6_cmix, rwkv6_tmix


def rms_norm_cfg(x, scale, cfg):
    return rms_norm(x, scale, cfg.norm_eps, stats_only_f32=cfg.norm_stats_only_f32)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family this slice does not port."""
    if cfg.block_pattern == "griffin":
        raise not_ported(f"{cfg.name}: block_pattern='griffin' (RG-LRU, ring attention)")
    if cfg.moe is not None:
        raise not_ported(f"{cfg.name}: MoE")
    if cfg.is_encdec:
        raise not_ported(f"{cfg.name}: the encoder-decoder (whisper)")
    if cfg.block_pattern not in ("attn", "rwkv6"):
        raise ValueError(f"unknown block_pattern {cfg.block_pattern!r}")


def tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """The tree of ``like``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def _layers(tree, n: int) -> list:
    """Every layer of a stacked tree, views of each leaf split once:
    ``unbind``'s backward is one ``stack`` a leaf, where ``n`` indexings
    would add ``n`` full-size gradients."""
    split = tree_map(lambda x: x.unbind(0), tree)
    return [tree_map(lambda parts: parts[i], split) for i in range(n)]


def _stack(trees: list):
    """Inverse of :func:`_layers`."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
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


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_layers(cfg: ModelConfig, generator, device) -> dict:
    """Every decoder block's params, stacked ``(n_layers, ...)``."""
    kw = dict(device=device, stack=(cfg.n_layers,))
    d = cfg.d_model
    if cfg.block_pattern == "rwkv6":
        return {
            "norm1": ones((d,), cfg.dt, **kw),
            "tmix": init_rwkv6_tmix(cfg, generator, **kw),
            "norm2": ones((d,), cfg.dt, **kw),
            "cmix": init_rwkv6_cmix(cfg, generator, **kw),
        }
    return {
        "norm1": ones((d,), cfg.dt, **kw),
        "attn": init_attention(cfg, generator, **kw),
        "norm2": ones((d,), cfg.dt, **kw),
        "mlp": init_mlp(cfg, generator, **kw),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """The reference's param tree (same paths, shapes, dtypes and init
    distributions), drawn from ``generator``, on ``device``.  The values
    are torch's draws, not ``jax.random``'s: carry a JAX-made tree across
    with :func:`repro_torch.models.interop.params_from_numpy`.
    ``device="meta"`` builds the shapes only."""
    check_supported(cfg)
    dev = resolve_device(device)
    params: dict[str, Any] = {
        "embed": dense_init(generator, (cfg.vocab_size, cfg.d_model), cfg.dt,
                            in_axis=1, device=dev),
        "final_norm": ones((cfg.d_model,), cfg.dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                                       cfg.dt, device=dev)
    params["layers"] = _init_layers(cfg, generator, dev)
    return params


# ---------------------------------------------------------------------------
# forward / prefill / decode
# ---------------------------------------------------------------------------


def _head(params, x, cfg: ModelConfig):
    """Logits in the compute dtype, then f32 (the reference's order)."""
    x = rms_norm_cfg(x, params["final_norm"], cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float()


def _rwkv_block(cfg, lp, h, state=None):
    tm, cm = (None, None) if state is None else (state["tmix"], state["cmix"])
    o, tm = rwkv6_tmix(lp["tmix"], rms_norm_cfg(h, lp["norm1"], cfg), cfg, tm)
    h = h + o
    o, cm = rwkv6_cmix(lp["cmix"], rms_norm_cfg(h, lp["norm2"], cfg), cfg, cm)
    return h + o, {"tmix": tm, "cmix": cm}


def _positions(b: int, t: int, dev) -> torch.Tensor:
    return torch.arange(t, dtype=torch.int32, device=dev)[None, :].expand(b, t)


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


def forward(params, tokens, cfg: ModelConfig, frames=None, device=None):
    """Full-sequence causal forward -> (logits (B, T, V) f32, aux loss)."""
    if frames is not None:
        raise not_ported("frames (the encoder-decoder)")
    dev = _device_for(cfg, device, params)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.dt)
    positions = _positions(b, t, dev)

    def block(h, lp):
        if cfg.block_pattern == "rwkv6":
            return _rwkv_block(cfg, lp, h)[0]
        h = h + attention_full(lp["attn"], rms_norm_cfg(h, lp["norm1"], cfg), cfg,
                               positions, window=cfg.attn_window)
        return h + mlp_apply(lp["mlp"], rms_norm_cfg(h, lp["norm2"], cfg), cfg)

    block = _maybe_remat(block, cfg)
    for lp in _layers(params["layers"], cfg.n_layers):
        x = block(x, lp)
    if cfg.bwd_bf16:
        x = _grad_to_bf16(x)
    return _head(params, x, cfg), torch.zeros((), dtype=torch.float32, device=dev)


def loss_fn(params, batch, cfg: ModelConfig, device=None):
    """Cross-entropy LM loss. batch: {"tokens", "labels"}.  Returns
    ``(nll + aux, {"nll", "aux"})``, f32 scalars."""
    logits, aux = forward(params, batch["tokens"], cfg, batch.get("frames"), device=device)
    labels = _tokens(batch["labels"], logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + aux, {"nll": nll, "aux": aux}


def init_serve_state(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> dict:
    """Zero-initialized decode state, the reference's tree."""
    check_supported(cfg)
    dev = resolve_device(device)
    n, d = cfg.n_layers, cfg.d_model
    if cfg.block_pattern == "rwkv6":
        hs = cfg.rwkv_head_size
        return {
            "layers": {
                "tmix": {
                    "s": torch.zeros((n, batch, d // hs, hs, hs), dtype=torch.float32,
                                     device=dev),
                    "x_prev": torch.zeros((n, batch, d), dtype=cfg.dt, device=dev),
                },
                "cmix": {"x_prev": torch.zeros((n, batch, d), dtype=cfg.dt, device=dev)},
            }
        }
    kv = (n, batch, cache_len, cfg.n_kv_heads, cfg.dhead)
    return {"layers": {"k": torch.zeros(kv, dtype=cfg.dt, device=dev),
                       "v": torch.zeros(kv, dtype=cfg.dt, device=dev)}}


def decode_step(params, token, pos: int, state, cfg: ModelConfig, device=None):
    """One-token decode.  token: (B, 1) ids; pos: the number of tokens
    already in the state (also the KV cache's write index).

    Returns (logits (B, V) f32, new_state); ``state`` is left unchanged."""
    dev = _device_for(cfg, device, params, state)
    x = params["embed"][_tokens(token, dev)].to(cfg.dt)
    pos = int(pos)
    ls = state["layers"]
    if cfg.block_pattern == "rwkv6":
        new = []
        for lp, st in zip(_layers(params["layers"], cfg.n_layers), _layers(ls, cfg.n_layers)):
            x, st = _rwkv_block(cfg, lp, x, st)
            new.append(st)
        new_state = {"layers": _stack(new)}
    else:
        kv = {"k": ls["k"].clone(), "v": ls["v"].clone()}
        # the per-layer views write through to ``kv``
        for lp, cache in zip(_layers(params["layers"], cfg.n_layers),
                             _layers(kv, cfg.n_layers)):
            o, _ = attention_decode(lp["attn"], rms_norm_cfg(x, lp["norm1"], cfg),
                                    cache, pos, cfg, window=cfg.attn_window)
            x = x + o
            x = x + mlp_apply(lp["mlp"], rms_norm_cfg(x, lp["norm2"], cfg), cfg)
        new_state = {"layers": kv}
    return _head(params, x, cfg)[:, 0, :], new_state


def prefill(params, tokens, cfg: ModelConfig, frames=None, device=None):
    """Full forward that also materializes the serve state.

    Returns (last-token logits (B, V) f32, state).  For attention models
    the KV cache length equals the prompt length (the serving engine
    copies it into a cache sized for the whole output)."""
    if frames is not None:
        raise not_ported("frames (the encoder-decoder)")
    dev = _device_for(cfg, device, params)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.dt)
    positions = _positions(b, t, dev)
    states = []
    for lp in _layers(params["layers"], cfg.n_layers):
        if cfg.block_pattern == "rwkv6":
            x, st = _rwkv_block(cfg, lp, x)
            states.append(st)
            continue
        hin = rms_norm_cfg(x, lp["norm1"], cfg)
        q, k, v = _qkv(lp["attn"], hin, cfg, positions)
        att = self_attention(q, k, v, cfg, window=cfg.attn_window)
        x = x + _heads_out(att, lp["attn"]["wo"])
        x = x + mlp_apply(lp["mlp"], rms_norm_cfg(x, lp["norm2"], cfg), cfg)
        states.append({"k": k, "v": v})
    logits = _head(params, x[:, -1:, :], cfg)[:, 0, :]
    return logits, {"layers": _stack(states)}


__all__ = [
    "check_supported",
    "decode_step",
    "forward",
    "init_params",
    "init_serve_state",
    "loss_fn",
    "prefill",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]
