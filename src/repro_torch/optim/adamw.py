"""AdamW with f32 master weights over bf16 compute params.

The port of ``repro.optim.adamw``: functional (not ``torch.optim.AdamW``,
whose order of operations differs), over the reference's trees (nested
dicts of tensors).  The arithmetic follows the reference term by term:
the global norm summed over the leaves in tree order, ``b1 * m + (1 -
b1) * g``, bias corrections ``1 - b**t`` in f32, ``w - lr * (mhat /
(sqrt(vhat) + eps) + wd * w)``, and the params cast from ``master``.

``adamw_update`` updates the moments, the master copy and the params in
place, leaf by leaf (the counterpart of the reference's donated state):
at full width that keeps one leaf's f32 temporaries alive at a time, not
a second copy of the whole state.  The returned state holds the same
tensors as the one given, so the one given is consumed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.model import tree_leaves, tree_map

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    #: cosine decay horizon; 0 disables scheduling (constant lr after warmup)
    decay_steps: int = 10_000


class OptState(NamedTuple):
    step: torch.Tensor       # 0-dim int32
    mu: Any                  # first moment (f32, like params)
    nu: Any                  # second moment (f32)
    master: Any              # f32 master copy of params


def adamw_init(params) -> OptState:
    """Zero moments and an f32 master copy, each leaf its own buffer, on
    the params' device."""
    zeros = lambda t: tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), t)
    master = tree_map(lambda x: x.to(torch.float32, copy=True), params)
    dev = tree_leaves(params)[0].device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    zeros(params), zeros(params), master)


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (the count of updates already made),
    an f32 scalar: linear warmup, then cosine decay to a tenth."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1.0) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.decay_steps > 0:
        frac = torch.clamp(step / cfg.decay_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return cfg.lr * warm * (0.1 + 0.9 * cos)
    return cfg.lr * warm


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the f32 sum of squares, summed over the leaves in tree order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(f32 grads scaled to a global norm of at most ``max_norm``, the
    norm before scaling)."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: OptState, params):
    """One AdamW step, in place.  Returns (params, state, metrics): the
    given params and state tensors updated, a new ``step``, and the f32
    ``grad_norm`` and ``lr``."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1.0 - b1**t
    bc2 = 1.0 - b2**t
    leaves = zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                 tree_leaves(state.master), tree_leaves(params))
    for g, m, v, w, p in leaves:
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        denom = torch.sqrt(v / bc2).add_(cfg.eps)      # sqrt(vhat) + eps
        upd = (m / bc1).div_(denom)                     # mhat / (...)
        del denom
        upd.add_(cfg.weight_decay * w).mul_(lr)         # lr * (... + wd * w)
        w.sub_(upd)
        p.copy_(w)
    return params, OptState(step, state.mu, state.nu, state.master), {
        "grad_norm": gnorm,
        "lr": lr,
    }
