"""Hand-written CUDA kernel for the EC coding hot spot, with its plain
PyTorch version."""

from . import ops, ref
from .ops import DEFAULT_BLOCK_BYTES
from .rs_bitmatmul import gf_bitmatmul

__all__ = ["ops", "ref", "gf_bitmatmul", "DEFAULT_BLOCK_BYTES"]
