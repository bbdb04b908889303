"""Error-feedback int8 gradient compression.

The port of ``repro.optim.compression``: each gradient leaf, plus its
carried residual, is quantized to int8 with a per-tensor scale
(``amax / 127``; ``torch.round`` rounds half to even as ``jnp.round``
does) and dequantized; the residual is carried to the next step.  The
results are bit-equal to the reference's as XLA computes it: the scale
as a product with ``1 / 127`` and the residual as one FMA (a ``max`` is
exact in any order).

``compress_decompress`` writes the new residual into the state's buffers
in place (the counterpart of the reference's donated state) and returns
the dequantized f32 gradients.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.models.model import tree_leaves, tree_map, tree_unflatten

__all__ = ["CompressionState", "compression_init", "compress_decompress"]


class CompressionState(NamedTuple):
    error: Any  # per-parameter f32 residual buffers


def compression_init(params) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), params))


#: ``1 / 127`` in f32.  XLA rewrites the reference's ``amax / 127.0`` (a
#: division by a constant) as a product with the constant's reciprocal,
#: which rounds differently from the division in some cases.
_INV_127 = float(np.float32(1.0 / 127.0))


def _quantize(x: torch.Tensor):
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_decompress(grads, state: CompressionState):
    """Apply EF-int8 to every gradient leaf.  Returns (grads', state):
    ``grads'`` f32, ``state`` the given one with its residuals updated."""
    out = []
    for g, e in zip(tree_leaves(grads), tree_leaves(state.error)):
        g32 = g.to(torch.float32) + e
        q, scale = _quantize(g32)
        deq = q.to(torch.float32) * scale
        # XLA fuses the residual's multiply and subtract into one FMA (one
        # rounding).  In f64 the product of an int8 and an f32 is exact, and
        # so is its difference from g32 (the two lie within a step of each
        # other), so rounding once to f32 gives the FMA's bits.
        e.copy_(g32.double() - q.double() * scale.double())
        out.append(deq)
    return tree_unflatten(grads, out), state
