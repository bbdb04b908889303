"""Model zoo of the port: the dense GQA transformers
(``block_pattern="attn"``) and RWKV6, for serving and training
(``loss_fn``).  Griffin, MoE and the encoder-decoder wait for later
slices (``ROADMAP.md``)."""

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
