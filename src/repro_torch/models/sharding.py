"""Logical-axis sharding rules (MaxText-style) for single- and multi-pod
meshes, resolved onto a ``torch.distributed`` ``DeviceMesh``.

The port of ``repro.models.sharding``.  Parameters and activations are
annotated with tuples of *logical* axis names; :func:`logical_to_spec`
resolves them to a :class:`PartitionSpec` against a rule table, dropping
mesh axes that do not divide the concrete dimension (whisper-tiny's 6
heads on a 16-way model axis fall back to replication).  A spec maps to
DTensor placements: a dim sharded over mesh axis ``a`` is ``Shard(dim)``
on ``a``, every other mesh dim is ``Replicate()``.

:func:`logical_to_spec` reads only the axis names and each axis's size,
so it takes a ``DeviceMesh`` (``mesh_dim_names``, ``size(i)``) or any
stand-in with ``axis_names`` and a ``shape`` mapping, as the dry run's
and the tests' meshes are.

:func:`constrain` is the counterpart of ``with_sharding_constraint``:
under the active mesh it redistributes a DTensor to the spec's
placements (a plain tensor, or no mesh, passes through unchanged).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "RULES_SINGLE_POD",
    "RULES_MULTI_POD",
    "PartitionSpec",
    "NamedSharding",
    "activate_mesh",
    "active_mesh",
    "axis_names",
    "axis_size",
    "constrain",
    "is_axes_leaf",
    "local_region",
    "logical_to_spec",
    "matmul",
    "named_sharding",
    "placements_for",
    "reshape",
    "rules_for",
    "tree_shardings",
]

# logical axis -> mesh axes (in priority order), per mesh flavor
RULES_SINGLE_POD: dict[str, tuple[str, ...]] = {
    "batch": ("data",),
    "seq": (),
    "embed": ("data",),          # FSDP: params+optimizer sharded over data
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_mlp": (),
    "expert_cap": (),
    "layers": (),
    "conv": (),
    "frames": (),
    "state": ("model",),
    "seq_sp": ("model",),   # Megatron-style sequence parallelism
}

RULES_MULTI_POD: dict[str, tuple[str, ...]] = {
    **RULES_SINGLE_POD,
    "batch": ("pod", "data"),
    "embed": ("pod", "data"),    # FSDP over the full DP extent
}


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (not sharded), a mesh axis name, or a
    tuple of them (sharded over their product, major axis first).  As in
    JAX, a one-name tuple is the name and an empty one is ``None``."""

    def __new__(cls, *entries):
        norm = [e[0] if isinstance(e, tuple) and len(e) == 1 else
                None if e == () else e for e in entries]
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return int(shape[name])
    return int(shape[axis_names(mesh).index(name)])


def rules_for(mesh) -> dict[str, tuple[str, ...]]:
    return RULES_MULTI_POD if "pod" in axis_names(mesh) else RULES_SINGLE_POD


def logical_to_spec(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[Mapping[str, tuple[str, ...]]] = None,
) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec, checking divisibility."""
    rules = rules or rules_for(mesh)
    used: set[str] = set()
    out = []
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        axes = []
        extent = 1
        for mesh_axis in rules.get(name, ()):
            if mesh_axis in used:
                continue
            size = axis_size(mesh, mesh_axis)
            if dim % (extent * size) == 0:
                axes.append(mesh_axis)
                extent *= size
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def placements_for(spec: Sequence, mesh, shape: Optional[Sequence[int]] = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on each
    mesh dim that shards tensor dim ``dim``, ``Replicate()`` elsewhere.
    Given the ``shape``, a dim of size 1 (which only size-1 mesh axes can
    divide) counts as replicated, as DTensor's views need."""
    names = axis_names(mesh)
    out: list[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[dim] == 1):
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec resolved against a mesh: the counterpart of
    ``jax.sharding.NamedSharding``, with its DTensor placements."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def named_sharding(logical: Sequence[Optional[str]], shape: Sequence[int],
                   mesh) -> NamedSharding:
    return NamedSharding(mesh, logical_to_spec(logical, shape, mesh))


def is_axes_leaf(x) -> bool:
    """Is ``x`` one leaf of a logical-axes tree (a tuple of names)?"""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_shardings(logical_tree, shape_tree, mesh):
    """Map parallel trees of logical-axis tuples and shaped leaves (tensors,
    or anything with ``.shape``) to :class:`NamedSharding`s."""
    if is_axes_leaf(logical_tree):
        return named_sharding(logical_tree, tuple(shape_tree.shape), mesh)
    if isinstance(logical_tree, Mapping):
        return {k: tree_shardings(logical_tree[k], shape_tree[k], mesh)
                for k in logical_tree}
    return [tree_shardings(a, s, mesh) for a, s in zip(logical_tree, shape_tree)]


_ACTIVE_MESH: list[Optional[Any]] = [None]


def active_mesh():
    return _ACTIVE_MESH[0]


class activate_mesh:
    """Explicit ambient-mesh scope for ``constrain`` and the MoE dispatch.
    The train/serve builders activate the mesh around the step; code that
    never activates one gets no-op constraints.  Inside the scope a plain
    tensor met by a DTensor op counts as replicated (the model's own
    constants: positions, masks, zero states)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self.prev = _ACTIVE_MESH[0]
        _ACTIVE_MESH[0] = self.mesh
        self.replication = implicit_replication()
        self.replication.__enter__()
        return self.mesh

    def __exit__(self, *exc):
        self.replication.__exit__(*exc)
        _ACTIVE_MESH[0] = self.prev
        return False


class _Redistribute(torch.autograd.Function):
    """A DTensor laid out as ``placements``, and its gradient too (the
    transpose of a sharding constraint is the same constraint)."""

    @staticmethod
    def forward(ctx, x, placements):
        # the gradient of a partial sum is replicated
        ctx.grad_placements = tuple(Replicate() if isinstance(p, Partial) else p
                                    for p in placements)
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.grad_placements:
            g = g.redistribute(g.device_mesh, ctx.grad_placements)
        return g, None


def _constrain_placements(x, placements):
    placements = tuple(placements)
    if tuple(x.placements) == placements and not x.requires_grad:
        return x
    return _Redistribute.apply(x, placements)


def constrain(x, logical: Sequence[Optional[str]], mesh=None):
    """Lay ``x`` (and its gradient) out as its logical axes say under the
    active mesh: the counterpart of ``with_sharding_constraint``.  A plain
    tensor, or no mesh, passes through."""
    mesh = mesh or _ACTIVE_MESH[0]
    if mesh is None or not isinstance(x, DTensor):
        return x
    return _constrain_placements(x, placements_for(
        logical_to_spec(logical, x.shape, x.device_mesh), x.device_mesh, x.shape))


def _view_groups(src, dst) -> list[tuple[list[int], list[int]]]:
    """Adjacent dims of ``src`` and ``dst`` grouped by equal products."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        ins, outs, pi, pj = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while pi != pj:
            if pi < pj:
                ins.append(i)
                pi *= src[i]
                i += 1
            else:
                outs.append(j)
                pj *= dst[j]
                j += 1
        groups.append((ins, outs))
    if groups:   # trailing size-1 dims
        groups[-1][0].extend(range(i, len(src)))
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def reshape(x, *shape):
    """``x.reshape(*shape)``; a DTensor is first laid out so that the view
    is local on every shard (a dim stays sharded only if it leads its
    group of merged or split dims and both sizes divide evenly), and its
    gradient is held to the same layout."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    shape = list(shape[0] if len(shape) == 1 and not isinstance(shape[0], int) else shape)
    if -1 in shape:
        k = shape.index(-1)
        shape[k] = x.numel() // max(1, -math.prod(shape))
    mesh = x.device_mesh
    owner = {}
    for ins, outs in _view_groups(list(x.shape), shape):
        for d in ins:
            owner[d] = (ins, outs)
    extent: dict[int, int] = {}
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            extent[p.dim] = extent.get(p.dim, 1) * mesh.size(i)
    pl_in, pl_out = [], []
    for p in x.placements:
        if isinstance(p, Shard):
            ins, outs = owner[p.dim]
            ext = extent[p.dim]
            if (p.dim == ins[0] and x.shape[p.dim] > 1 and shape[outs[0]] > 1
                    and x.shape[p.dim] % ext == 0 and shape[outs[0]] % ext == 0):
                pl_in.append(p)
                pl_out.append(Shard(outs[0]))
                continue
            p = Replicate()
        pl_in.append(p)
        pl_out.append(p)
    y = _constrain_placements(x, pl_in).reshape(shape)
    return _constrain_placements(y, pl_out)


@dataclasses.dataclass(frozen=True)
class Summed:
    """An output of a :func:`local_region` that each shard holds a part of,
    summed over the mesh axes ``over`` (``shard_map``'s ``psum`` left to
    the caller); laid out as ``logical`` on the other axes."""

    logical: tuple
    over: tuple


def _lay_out(x, mesh, placements):
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh, placements)
    return x


def local_region(fn, in_axes, out_axes):
    """``fn`` run on each shard's local tensors: the counterpart of
    ``shard_map`` for a sharding-transparent region.

    ``in_axes`` gives each positional argument's logical axes (``None``
    passes the argument through: a non-tensor, or ``None``); ``out_axes``
    gives each output's, or a :class:`Summed` for an output that is a
    partial sum over some axes.  An output's logical names must name dims
    of the inputs: it is sharded as they are.  With no DTensor argument
    (no mesh), ``fn`` runs as it is.  Otherwise each tensor argument is
    redistributed to its spec's placements under the active mesh, ``fn``
    runs on the local shards, and its outputs become DTensors again.
    Autograd flows through: an argument replicated over a mesh axis along
    which the work is split (an input is sharded or an output summed) gets
    a partial gradient there, as each shard computed a different part."""

    def wrapped(*args):
        mesh = _ACTIVE_MESH[0]
        if mesh is None or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        names = axis_names(mesh)
        split: set[int] = set()
        for ax in out_axes:
            if isinstance(ax, Summed):
                split.update(names.index(a) for a in ax.over)
        by_name: dict[str, tuple[str, ...]] = {}
        ins, in_pl = [], []
        for a, ax in zip(args, in_axes):
            if ax is None or not isinstance(a, torch.Tensor):
                ins.append(a)
                in_pl.append(None)
                continue
            spec = logical_to_spec(ax, a.shape, mesh)
            for name, entry in zip(ax, spec):
                if name is not None:
                    by_name.setdefault(name, () if entry is None else
                                       (entry,) if isinstance(entry, str) else entry)
            pl = placements_for(spec, mesh, a.shape)
            split.update(i for i, p in enumerate(pl) if isinstance(p, Shard))
            ins.append(_lay_out(a, mesh, pl))
            in_pl.append(pl)
        local = []
        for a, pl in zip(ins, in_pl):
            if pl is None:
                local.append(a)
                continue
            grad_pl = [Partial() if (isinstance(p, Replicate) and i in split) else p
                       for i, p in enumerate(pl)]
            local.append(a.to_local(grad_placements=grad_pl))
        out = fn(*local)
        single = not isinstance(out, tuple)
        outs = []
        for o, ax in zip((out,) if single else out, out_axes):
            if o is None:
                outs.append(None)
                continue
            logical, over = (ax.logical, ax.over) if isinstance(ax, Summed) else (ax, ())
            pl: list[Any] = [Replicate()] * len(names)
            shape = list(o.shape)
            for dim, name in enumerate(logical):
                for a in by_name.get(name, ()) if name is not None else ():
                    pl[names.index(a)] = Shard(dim)
                    shape[dim] *= axis_size(mesh, a)
            for a in over:
                pl[names.index(a)] = Partial()
            stride = torch.empty(shape, device="meta").stride()
            outs.append(DTensor.from_local(o.contiguous(), mesh, pl, run_check=False,
                                           shape=torch.Size(shape), stride=stride))
        return outs[0] if single else tuple(outs)

    return wrapped


def _plan_matmul(xp: list, wp: list) -> tuple[list, list]:
    """Placements of ``x`` (rows, D) and ``w`` (D, F) for a local product,
    mesh dim by mesh dim, the FSDP x TP plan GSPMD takes: a weight sharded
    on its contraction dim (FSDP) is gathered unless ``x`` is sharded
    there too (row-parallel TP: the product is a partial sum); a weight
    sharded on its output dim (column-parallel TP) needs ``x`` whole on
    that mesh dim; a partial ``x`` is summed first."""
    xp, wp = list(xp), list(wp)
    for i, (xs, ws) in enumerate(zip(xp, wp)):
        if isinstance(xs, Partial):
            xs = xp[i] = Replicate()
        x_con, w_con = xs == Shard(1), ws == Shard(0)
        if w_con and not x_con:
            wp[i] = Replicate()
        elif x_con and not w_con:
            if ws == Shard(1):
                xp[i] = Replicate()
            else:
                wp[i] = Shard(0)
        if wp[i] == Shard(1) and xp[i] != Replicate():
            xp[i] = Replicate()
    return xp, wp


def matmul(x, w):
    """``x @ w`` for activations ``x`` (..., D) and a weight ``w`` (D, F).
    On DTensors ``x`` is flattened to rows with :func:`reshape` (as
    ``matmul`` itself folds them) and both operands are laid out for a
    local product (:func:`_plan_matmul`), which DTensor's own choice,
    which weighs only bytes moved, may not be: it can pick a full-size
    partial product.  A partial product is all-reduced before it is
    returned."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x @ w
    lead = x.shape[:-1]
    x2 = reshape(x, -1, x.shape[-1])
    xp, wp = _plan_matmul(x2.placements, w.placements)
    y = _constrain_placements(x2, xp) @ _constrain_placements(w, wp)
    # a row-parallel product is summed at once, in its own dtype, as
    # GSPMD reduces a dot's output
    y = _constrain_placements(y, [Replicate() if isinstance(p, Partial) else p
                                  for p in y.placements])
    return reshape(y, *lead, w.shape[-1]) if len(lead) > 1 else y
