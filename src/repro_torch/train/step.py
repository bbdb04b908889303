"""The train step and train-state plumbing, on one device.

The port of ``repro.train.step`` for ``mesh=None``: ``make_train_step``
returns ``step(state, batch) -> (state, metrics)`` computing what the
reference's ``train_step`` computes — ``loss_fn``'s value and its
gradients (``torch.autograd``), optional EF-int8 compression, one AdamW
update — on the device the state lives on.

The step consumes the state it is given, as the reference's donated
state: params, moments, master copy and compression residuals are updated
in place and the returned state holds the same tensors.  Keep a copy of a
state that must outlive the next step.

A mesh (FSDP x TP sharding, ``train_state_shardings``,
``batch_shardings``, ``reshard_state``) waits for ``ROADMAP.md`` Queue 1,
item 4.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import (
    AdamWConfig,
    CompressionState,
    OptState,
    adamw_init,
    adamw_update,
    compress_decompress,
    compression_init,
)

__all__ = ["TrainState", "init_train_state", "make_train_step"]


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    comp: Optional[CompressionState]


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     compression: bool = False, device=None) -> TrainState:
    """Params drawn from ``generator`` on ``device`` (``None`` = CUDA;
    ``"meta"`` gives the shapes only), zero moments, an f32 master copy,
    and zero residuals when ``compression``."""
    params = init_params(cfg, generator, device=device)
    return TrainState(
        params=params,
        opt=adamw_init(params),
        comp=compression_init(params) if compression else None,
    )


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh=None,
    compression: bool = False,
):
    """``step(state, batch) -> (state, metrics)`` with f32 ``loss``,
    ``nll``, ``grad_norm`` and ``lr``; the batch's tensors on the state's
    device."""
    if mesh is not None:
        raise NotImplementedError(
            "not ported yet: a sharded train step (mesh) waits for ROADMAP.md "
            "Queue 1, item 4 (mesh, dry run and roofline)")

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        # Fresh leaves over the same storage: autograd differentiates
        # them, and the state's own tensors stay plain.
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(tree_unflatten(state.params, live), batch, cfg,
                                device=leaves[0].device)
        grads = tree_unflatten(state.params, torch.autograd.grad(loss, live))
        del live
        comp = state.comp
        if compression:
            grads, comp = compress_decompress(grads, comp)
        new_params, new_opt, om = adamw_update(opt_cfg, grads, state.opt, state.params)
        out_metrics = {
            "loss": loss.detach().to(torch.float32),
            "nll": metrics["nll"].detach().to(torch.float32),
            "grad_norm": om["grad_norm"],
            "lr": om["lr"],
        }
        return TrainState(new_params, new_opt, comp), out_metrics

    return train_step
