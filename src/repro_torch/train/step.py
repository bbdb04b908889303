"""The train step and train-state plumbing, on one device or a mesh.

The port of ``repro.train.step``: ``make_train_step`` returns
``step(state, batch) -> (state, metrics)`` computing what the reference's
``train_step`` computes — ``loss_fn``'s value and its gradients
(``torch.autograd``), optional EF-int8 compression, one AdamW update — on
the device the state lives on.

The step consumes the state it is given, as the reference's donated
state: params, moments, master copy and compression residuals are updated
in place and the returned state holds the same tensors.  Keep a copy of a
state that must outlive the next step.

With a ``mesh`` (a ``DeviceMesh`` named ``("data", "model")`` or
``("pod", "data", "model")``) the state's leaves are DTensors laid out as
:func:`train_state_shardings` says — FSDP over the data axes (the
logical "embed" rule), tensor parallelism over "model" — and the batch
is sharded over the data axes (:func:`batch_shardings`).  The step lays
out any plain leaf or batch tensor it is given (the counterpart of
``jit``'s ``in_shardings``), runs the same program on DTensors under the
mesh (``activate_mesh``), and brings each gradient to its param's layout
before the update (the FSDP reduce-scatter).  On a one-rank mesh it
computes the mesh-less step's bits.  :func:`reshard_state` moves a state
onto another mesh (an elastic restart).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models import init_params, loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import param_axes, tree_leaves, tree_map, tree_unflatten
from repro_torch.models.sharding import (
    NamedSharding,
    PartitionSpec as P,
    activate_mesh,
    axis_names,
    placements_for,
    tree_shardings,
)
from repro_torch.optim import (
    AdamWConfig,
    CompressionState,
    OptState,
    adamw_init,
    adamw_update,
    compress_decompress,
    compression_init,
)

__all__ = [
    "TrainState",
    "batch_shardings",
    "full_tensor",
    "init_train_state",
    "lay_out",
    "make_train_step",
    "reshard_state",
    "train_state_shardings",
]


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


def train_state_shardings(cfg: ModelConfig, mesh, compression: bool = False) -> TrainState:
    """NamedShardings for the full TrainState (params + moments + master)."""
    shapes = init_params(cfg, torch.Generator(), device="meta")
    p_sh = tree_shardings(param_axes(cfg), shapes, mesh)
    scalar = NamedSharding(mesh, P())
    opt_sh = OptState(step=scalar, mu=p_sh, nu=p_sh, master=p_sh)
    comp_sh = CompressionState(error=p_sh) if compression else None
    return TrainState(params=p_sh, opt=opt_sh, comp=comp_sh)


def batch_shardings(cfg: ModelConfig, mesh) -> dict:
    dp = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    tok = NamedSharding(mesh, P(dp, None))
    out = {"tokens": tok, "labels": tok}
    if cfg.is_encdec:
        out["frames"] = NamedSharding(mesh, P(dp, None, None))
    return out


def lay_out(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` as a DTensor laid out as ``sharding`` says.  A plain tensor is
    the whole value on every rank: each takes its shard (on a one-rank
    mesh the tensor itself, no copy).  A DTensor on an equal mesh is
    redistributed; one on another mesh is gathered first, leaf by leaf."""
    mesh = sharding.mesh
    placements = placements_for(sharding.spec, mesh, x.shape)
    if isinstance(x, DTensor):
        if x.device_mesh != mesh:
            x = full_tensor(x)
        elif tuple(x.placements) == placements:
            return x
        else:
            return x.redistribute(mesh, placements)
    if mesh.size() == 1:
        return DTensor.from_local(x, mesh, placements, run_check=False)
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def full_tensor(x):
    """A DTensor's whole value as a plain tensor (on a one-rank mesh its
    local tensor, no copy); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    if x.device_mesh.size() == 1:
        return x.to_local()
    return x.full_tensor()


def _leaf_device(state: TrainState) -> torch.device:
    return tree_leaves(state.params)[0].device


def _map_state(fn, state: TrainState, shardings: TrainState) -> TrainState:
    opt = OptState(*(tree_map(fn, a, b) for a, b in zip(state.opt, shardings.opt)))
    comp = None if state.comp is None else CompressionState(
        tree_map(fn, state.comp.error, shardings.comp.error))
    return TrainState(tree_map(fn, state.params, shardings.params), opt, comp)


def reshard_state(state: TrainState, cfg: ModelConfig, new_mesh,
                  compression: bool = False) -> TrainState:
    """Elastic rescale: move a TrainState (plain tensors, or DTensors on
    another mesh) onto ``new_mesh``.  Shardings are recomputed from the
    logical axes, so any mesh whose axes divide the dims works."""
    return _map_state(lay_out, state, train_state_shardings(cfg, new_mesh, compression))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    mesh=None,
    compression: bool = False,
):
    """``step(state, batch) -> (state, metrics)`` with f32 ``loss``,
    ``nll``, ``grad_norm`` and ``lr``; the batch's tensors on the state's
    device.  With a ``mesh``, the state comes out as DTensors on it and
    the metrics as plain tensors."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, not {type(mesh).__name__}")

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        # Fresh leaves over the same storage: autograd differentiates
        # them, and the state's own tensors stay plain.
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_fn(tree_unflatten(state.params, live), batch, cfg,
                                device=leaves[0].device)
        grads = torch.autograd.grad(full_tensor(loss), live)
        if mesh is not None:   # each gradient in its param's layout
            grads = [g.redistribute(p.device_mesh, p.placements)
                     if tuple(g.placements) != tuple(p.placements) else g
                     for g, p in zip(grads, leaves)]
        grads = tree_unflatten(state.params, grads)
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

    if mesh is None:
        return train_step
    st_sh = train_state_shardings(cfg, mesh, compression)
    b_sh = batch_shardings(cfg, mesh)

    def sharded_step(state: TrainState, batch):
        with activate_mesh(mesh):
            state = _map_state(lay_out, state, st_sh)
            batch = {k: lay_out(torch.as_tensor(v, device=_leaf_device(state)), b_sh[k])
                     for k, v in batch.items()}
            state, metrics = train_step(state, batch)
        return state, {k: full_tensor(v) for k, v in metrics.items()}

    return sharded_step
