"""Mesh construction: a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names.

The port of ``repro.launch.mesh``.  A mesh lives on a process group of
exactly as many ranks as it has devices: the caller starts the group
(``torch.distributed.init_process_group``) with its address, world size
and rank.  The one exception is :func:`make_local_mesh` on one device:
when no group exists it starts a one-rank group over an in-process
``HashStore`` (NCCL on CUDA, gloo on the CPU), the counterpart of JAX
needing none.  The dry run's 256- and 512-rank meshes live on torch's
fake process group (``repro_torch.launch.dryrun``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch._device import resolve_device

__all__ = ["make_local_mesh", "make_mesh", "make_production_mesh"]


def _device_type(device) -> str:
    return resolve_device(device).type


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose world size must be the product of ``shape``;
    ``device=None`` means CUDA."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of "
                           f"{math.prod(shape)} ranks; none is started")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    dev = _device_type(device)
    if dev == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_world_size() not in (256, 512):
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError("the production mesh needs a process group of 256 or "
                           f"512 ranks; it has {have}")
    return make_mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """A (data, model) mesh over the ranks of this host's process group.
    With no group and ``data * model == 1``, starts a one-rank group."""
    if not dist.is_initialized() and data * model == 1:
        dev = _device_type(device)
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((data, model), ("data", "model"), device)
