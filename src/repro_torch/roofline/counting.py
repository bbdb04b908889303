"""FLOP, byte and collective counting of a traced torch program.

The port of ``repro.roofline.jaxpr_flops`` and of the collective
accounting of ``repro.roofline.hlo_analysis``.  There is no jaxpr to walk
in torch: the program runs (on fake tensors, which allocate nothing) under
dispatch modes that see every aten op it issues, loops unrolled, the
backward pass and remat recompute included.

* :func:`count_fn_flops`: matmul FLOPs (2*M*N*K) from
  ``torch.utils.flop_counter.FlopCounterMode``, and one FLOP per output
  element of every other op that computes (views, copies, casts, index
  reads and writes, concatenation and constant fills are free, as the
  reference's ``_ZERO_COST`` primitives are).
* :class:`TraceStats`: what one rank does under a mesh — the bytes each
  local op reads and writes (an unfused sum; nothing fuses in eager
  torch), its matmul FLOPs, the bytes of every collective by type (its
  input, as the reference counts an HLO collective's operands), and the
  peak of live tensor bytes.  It lets DTensor ops desugar first, as
  ``CommDebugMode`` does, so it sees the local ops and the collectives
  DTensor issues.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

__all__ = ["FlopCount", "TraceStats", "count_fn_flops"]

@dataclasses.dataclass
class FlopCount:
    dot_flops: float = 0.0
    elementwise_flops: float = 0.0

    @property
    def total(self) -> float:
        return self.dot_flops + self.elementwise_flops


#: ops that move, view, cast or fill data without arithmetic.
_ZERO_COST = {
    "alias", "as_strided", "cat", "clone", "constant_pad_nd", "copy", "copy_",
    "detach", "embedding", "empty", "empty_like", "empty_strided", "expand",
    "fill", "fill_", "flip", "full", "full_like", "gather", "index", "index_put",
    "index_put_", "index_select", "lift_fresh", "lift_fresh_copy", "new_empty", "new_full", "new_ones", "new_zeros", "ones", "ones_like", "permute",
    "repeat", "repeat_interleave", "roll", "scalar_tensor", "scatter", "select",
    "select_backward", "slice", "slice_backward", "slice_scatter", "split",
    "split_with_sizes", "squeeze", "stack", "t", "transpose", "unbind", "unfold",
    "unsqueeze", "view", "_unsafe_view", "_to_copy", "arange", "zeros",
    "zeros_like", "_reshape_alias", "reshape", "contiguous", "unsafe_split",
    "index_select_backward", "narrow", "diagonal", "movedim",
    "scatter_add", "index_add", "_local_scalar_dense", "item", "set_", "resize_",
    "embedding_dense_backward", "_unsafe_index",
}

#: ops that allocate or fill without reading an input.
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "_c10d_functional.broadcast": "collective-permute",
}


def _name(func) -> str:
    return func.overloadpacket.__name__.lstrip("_") if func.namespace == "aten" \
        else func.overloadpacket.__name__


def _is_zero_cost(func) -> bool:
    return func.overloadpacket.__name__ in _ZERO_COST or _name(func) in _ZERO_COST


def _tensors(tree) -> list[torch.Tensor]:
    out = []
    for x in torch.utils._pytree.tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _has_subclass(types) -> bool:
    return any(t is not torch.Tensor and not issubclass(t, torch._subclasses.FakeTensor)
               for t in types)


class _ElementwiseCounter(TorchDispatchMode):
    """One FLOP per output element of each computing op that is not a
    matmul (those are :class:`FlopCounterMode`'s)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in flop_registry and not _is_zero_cost(func):
            self.flops += float(sum(t.numel() for t in _tensors(out)))
        return out


def count_fn_flops(fn, *args, **kwargs) -> FlopCount:
    """FLOPs of ``fn(*args)``: run it (on fake or meta tensors to allocate
    nothing) and count the matmuls and the other computing ops."""
    with FlopCounterMode(display=False) as fc, _ElementwiseCounter() as ec:
        fn(*args, **kwargs)
    return FlopCount(float(fc.get_total_flops()), ec.flops)


class TraceStats(TorchDispatchMode):
    """Per-rank counters of a traced program (see the module docstring).
    ``live_bytes`` starts at ``resident`` (the arguments the program holds
    throughout) and follows every tensor an op creates until it is freed.

    DTensor works out an op's global output shape by running the op on
    global-shape fake tensors; those runs are not the rank's work and are
    not counted (DTensor's ``ShardingPropagator._propagate_tensor_meta_
    non_cached`` is wrapped while the mode is on)."""

    def __init__(self, resident: int = 0):
        super().__init__()
        self.memory_bytes = 0.0
        self.dot_flops = 0.0
        self.collective_bytes: dict[str, float] = defaultdict(float)
        self.n_collectives = 0
        self.live_bytes = resident
        self.peak_bytes = resident
        self._in_meta = 0

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            raise RuntimeError(f"TraceStats needs DTensor's ShardingPropagator.{name}, "
                               f"which this torch ({torch.__version__}) lacks")
        real = getattr(ShardingPropagator, name)

        def meta_only(prop, *a, **kw):
            self._in_meta += 1
            try:
                return real(prop, *a, **kw)
            finally:
                self._in_meta -= 1

        self._unwrap = lambda: setattr(ShardingPropagator, name, real)
        setattr(ShardingPropagator, name, meta_only)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unwrap()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_subclass(types):
            return NotImplemented      # let DTensor desugar into local ops
        if self._in_meta:
            return func(*args, **(kwargs or {}))
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "_c10d_functional" or ns == "c10d_functional":
            kind = _COLLECTIVES.get(func.overloadpacket.__name__)
            if kind is not None:
                nb = float(sum(_nbytes(t) for t in _tensors(args)))
                self.collective_bytes[kind] += nb
                self.n_collectives += 1
                self.memory_bytes += nb + sum(_nbytes(t) for t in _tensors(out))
            return out
        if func.overloadpacket in flop_registry:
            self.dot_flops += float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
        if func.namespace == "prim" or _name(func) in _NO_TRAFFIC:
            return out
        if not func._schema.is_mutable and not _is_view(func):
            written = _tensors(out)
            self.memory_bytes += sum(_nbytes(t) for t in _tensors(args)) + \
                sum(_nbytes(t) for t in written)
            for t in written:
                n = _nbytes(t)
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        elif func._schema.is_mutable:
            self.memory_bytes += sum(_nbytes(t) for t in _tensors(args))
        return out

    def summary(self) -> dict:
        return {
            "memory_bytes": self.memory_bytes,
            "dot_flops": self.dot_flops,
            "collective_bytes": dict(self.collective_bytes),
            "n_collectives": self.n_collectives,
            "peak_bytes": self.peak_bytes,
        }


def _is_view(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)
