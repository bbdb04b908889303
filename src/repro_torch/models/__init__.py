"""Model zoo of the port: the serving path of the dense GQA transformers
(``block_pattern="attn"``) and RWKV6.  Griffin, MoE, the encoder-decoder
and training (``loss_fn``) wait for later slices (``ROADMAP.md``)."""

from .config import EncoderConfig, ModelConfig, MoEConfig
from .interop import flatten_params, params_from_numpy, unflatten_params
from .model import decode_step, forward, init_params, init_serve_state, prefill

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "EncoderConfig",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "init_serve_state",
    "params_from_numpy",
    "flatten_params",
    "unflatten_params",
]
