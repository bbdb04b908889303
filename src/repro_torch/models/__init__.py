"""Model zoo of the port: the dense and MoE GQA transformers, whisper's
encoder-decoder (``block_pattern="attn"``), RWKV6 and Griffin, for
serving and training (``loss_fn``), on one device or, with DTensor
params under ``sharding.activate_mesh``, on a mesh."""

from .config import EncoderConfig, ModelConfig, MoEConfig
from .interop import flatten_params, params_from_numpy, unflatten_params
from .model import (
    decode_step,
    forward,
    init_params,
    init_serve_state,
    loss_fn,
    param_axes,
    prefill,
    serve_state_axes,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "EncoderConfig",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_serve_state",
    "param_axes",
    "serve_state_axes",
    "params_from_numpy",
    "flatten_params",
    "unflatten_params",
]
