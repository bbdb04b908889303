"""Optimizers of the port: AdamW with f32 master weights, global-norm
clipping, and optional error-feedback int8 gradient compression."""

from .adamw import AdamWConfig, OptState, adamw_init, adamw_update, clip_by_global_norm
from .compression import CompressionState, compress_decompress, compression_init

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "CompressionState",
    "compression_init",
    "compress_decompress",
]
