"""Carry state between the JAX package and the port.

Nothing here computes: these helpers only let one state, or one
checkpoint, be held by both packages.

* :func:`state_dict_from_numpy` turns the JAX package's host leaves
  (numpy arrays, ml_dtypes ``bfloat16`` included, as raw bits) into the
  port's ``state_dict``.
* :func:`import_manifest` registers a manifest the JAX package's
  ``DRexCheckpointer`` wrote with a port checkpointer whose fabric holds
  the same chunks (for example a :class:`StorageFabric` that loaded the
  same ``persist_dir``), so the port can restore it.
"""

from __future__ import annotations

import copy
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

from .manager import DRexCheckpointer, torch_dtype

__all__ = ["state_dict_from_numpy", "import_manifest"]


def state_dict_from_numpy(
    named_arrays: Mapping[str, np.ndarray] | Iterable[tuple[str, np.ndarray]],
    device: str | torch.device = "cuda",
) -> dict[str, torch.Tensor]:
    """``{name: array}`` (or ``(name, array)`` pairs, order kept) -> a
    state dict of tensors on ``device`` holding the same bytes."""
    dev = resolve_device(device)
    items = named_arrays.items() if isinstance(named_arrays, Mapping) else named_arrays
    out: dict[str, torch.Tensor] = {}
    for name, arr in items:
        arr = np.asarray(arr)
        dtype = torch_dtype(arr.dtype.name)
        if arr.size == 0:
            out[str(name)] = torch.empty(arr.shape, dtype=dtype, device=dev)
            continue
        raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy()
        out[str(name)] = torch.from_numpy(raw).view(dtype).reshape(arr.shape).to(dev)
    return out


def import_manifest(
    checkpointer: DRexCheckpointer,
    step: int,
    manifest: dict,
    names: Optional[Sequence[str]] = None,
) -> dict:
    """Register the JAX package's manifest for ``step`` with
    ``checkpointer`` and return the port's form of it.

    The JAX manifest lists leaves in tree order without names; ``names``
    gives them (default ``leaf_0``, ``leaf_1``, ...).  Empty leaves
    (``None``) are dropped.  Dtype names are numpy's, which
    :func:`~repro_torch.checkpoint.manager.torch_dtype` reads."""
    leaves = manifest["leaves"]
    if names is None:
        names = [f"leaf_{i}" for i in range(len(leaves))]
    if len(names) != len(leaves):
        raise ValueError(f"{len(names)} names for {len(leaves)} leaves")
    port_leaves = []
    for name, meta in zip(names, leaves):
        if meta is None:
            continue
        torch_dtype(meta["dtype"])  # raises on a dtype torch lacks
        port_leaves.append({
            "name": str(name),
            "shape": list(meta["shape"]),
            "dtype": str(meta["dtype"]),
            "groups": copy.deepcopy(meta["groups"]),
        })
    port = {"step": int(manifest.get("step", step)), "leaves": port_leaves}
    with checkpointer._meta_lock:
        checkpointer._manifests[step] = port
    return port
