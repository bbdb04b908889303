"""A ``TrainState`` as a flat state dict, and carried across from the
JAX package.

* :func:`train_state_dict` names every leaf by its dotted path in the
  state — ``params.*``, ``opt.step``, ``opt.mu.*``, ``opt.nu.*``,
  ``opt.master.*``, then ``comp.error.*`` when compression is on — in the
  order of ``jax.tree.flatten`` over the reference's ``TrainState``.
  These are the checkpoint's leaf names, so the port's save of a state
  has the leaves, groups and chunk bytes of the JAX package's save of the
  same bytes, and a JAX-written checkpoint restores under these names
  (``repro_torch.checkpoint.interop.import_manifest``).
* :func:`train_state_from_dict` is its inverse.
* :func:`train_state_from_numpy` turns the JAX package's ``TrainState``,
  its leaves brought to the host as numpy arrays (ml_dtypes ``bfloat16``
  included), into the port's, bit for bit.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.checkpoint.interop import state_dict_from_numpy
from repro_torch.models.interop import flatten_params, unflatten_params
from repro_torch.optim import CompressionState, OptState

from .step import TrainState, full_tensor

__all__ = ["train_state_dict", "train_state_from_dict", "train_state_from_numpy"]

_OPT_TREES = ("mu", "nu", "master")


def _named(state) -> list[tuple[str, object]]:
    """(dotted name, leaf) of every leaf of a TrainState-like structure."""
    out = [(f"params.{n}", t) for n, t in flatten_params(state.params).items()]
    out.append(("opt.step", state.opt.step))
    for field in _OPT_TREES:
        tree = flatten_params(getattr(state.opt, field))
        out += [(f"opt.{field}.{n}", t) for n, t in tree.items()]
    if state.comp is not None:
        out += [(f"comp.error.{n}", t) for n, t in flatten_params(state.comp.error).items()]
    return out


def train_state_dict(state: TrainState) -> dict[str, torch.Tensor]:
    """The state's leaves under their dotted names (the tensors are the
    state's own, no copy).  A DTensor leaf is gathered to its whole value
    (on a one-rank mesh its local tensor, still no copy), so a sharded
    state saves the leaves a mesh-less one does."""
    return {n: full_tensor(t) for n, t in _named(state)}


def _subtree(d: Mapping[str, torch.Tensor], prefix: str) -> dict:
    return unflatten_params({n[len(prefix):]: t for n, t in d.items()
                             if n.startswith(prefix)})


def train_state_from_dict(d: Mapping[str, torch.Tensor], like: TrainState) -> TrainState:
    """The TrainState of ``like``'s structure (any device, ``meta``
    included) holding the tensors of ``d``, a state dict with
    :func:`train_state_dict`'s names in its order."""
    want = [n for n, _ in _named(like)]
    if list(d) != want:
        raise ValueError("state structure mismatch: the leaf names differ from "
                         "train_state_dict(like)'s")
    opt = OptState(d["opt.step"], *(_subtree(d, f"opt.{f}.") for f in _OPT_TREES))
    comp = None if like.comp is None else CompressionState(_subtree(d, "comp.error."))
    return TrainState(_subtree(d, "params."), opt, comp)


def train_state_from_numpy(state, device=None) -> TrainState:
    """The JAX package's TrainState with numpy leaves (``params``,
    ``opt.step``, ``opt.mu`` / ``nu`` / ``master``, ``comp`` or ``None``)
    as the port's on ``device`` (``None`` = CUDA), holding the same
    bytes."""
    named = [(n, np.asarray(a)) for n, a in _named(state)]
    return train_state_from_dict(state_dict_from_numpy(named, device=device), state)

