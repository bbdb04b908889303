"""Model params as a flat state dict, and carried across from the JAX
package.

* :func:`flatten_params` names every leaf by its path in the tree,
  dotted (``"layers.tmix.wk"``; a list item by its index, as in
  ``"groups.rec.0.rg.wx"``), in ``jax.tree`` order (dict keys sorted at
  every level, list items in index order): the names the checkpoint
  manifest stores, and the JAX package's own paths for the same model.
* :func:`unflatten_params` is its inverse: a node whose keys are exactly
  ``"0"``, ``"1"``, ... becomes a list again.
* :func:`params_from_numpy` turns the JAX package's params, brought to
  the host as a nested dict of numpy arrays (ml_dtypes ``bfloat16``
  included), into the port's, bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.checkpoint.interop import state_dict_from_numpy

__all__ = ["flatten_params", "unflatten_params", "params_from_numpy"]


def _flatten(tree: Mapping | list, prefix: str = "") -> list[tuple[str, Any]]:
    items = enumerate(tree) if isinstance(tree, list) else ((k, tree[k]) for k in sorted(tree))
    out = []
    for key, node in items:
        if "." in str(key):
            raise ValueError(f"a param key holds a dot: {key!r}")
        name = f"{prefix}{key}"
        if isinstance(node, (Mapping, list)):
            out.extend(_flatten(node, name + "."))
        else:
            out.append((name, node))
    return out


def _lists(node):
    """``node`` with every dict keyed ``"0"``, ``"1"``, ... made a list."""
    if not isinstance(node, dict):
        return node
    if node and sorted(node) == sorted(map(str, range(len(node)))):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def flatten_params(params: Mapping) -> dict[str, torch.Tensor]:
    """An ordered state dict of the tree's leaves under their dotted paths.
    The tensors are the params' own (no copy)."""
    return dict(_flatten(params))


def unflatten_params(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The nested params tree of a state dict made by
    :func:`flatten_params` (the tensors are the state dict's own)."""
    tree: dict = {}
    for name, leaf in state_dict.items():
        *parents, last = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return _lists(tree)


def params_from_numpy(tree: Mapping, device=None) -> dict:
    """The JAX package's params (a nested dict of numpy arrays) as the
    port's params on ``device`` (``None`` = CUDA), holding the same bytes."""
    named = [(name, np.asarray(a)) for name, a in _flatten(tree)]
    return unflatten_params(state_dict_from_numpy(named, device=device))
