"""Model zoo of the port: the dense and MoE GQA transformers, whisper's
encoder-decoder (``block_pattern="attn"``), RWKV6 and Griffin, for
serving and training (``loss_fn``), on one device."""

from .config import EncoderConfig, ModelConfig, MoEConfig
from .interop import flatten_params, params_from_numpy, unflatten_params
from .model import decode_step, forward, init_params, init_serve_state, loss_fn, prefill

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
    "params_from_numpy",
    "flatten_params",
    "unflatten_params",
]
