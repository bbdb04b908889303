"""Erasure-coding layer: GF(2^8) Cauchy Reed-Solomon (host matrices) +
item-level codec built on the CUDA kernel and its plain PyTorch version."""

from .gf256 import (
    cauchy_matrix,
    decode_matrix,
    generator_matrix,
    gf_inv,
    gf_mat_inv,
    gf_matmul,
    gf_mul,
    gf_to_bitmatrix,
)
from .codec import ECCodec, encode_item, decode_item, encode_batch, plan_cohorts

__all__ = [
    "gf_mul",
    "gf_inv",
    "gf_matmul",
    "gf_mat_inv",
    "cauchy_matrix",
    "generator_matrix",
    "decode_matrix",
    "gf_to_bitmatrix",
    "ECCodec",
    "encode_item",
    "decode_item",
    "encode_batch",
    "plan_cohorts",
]
