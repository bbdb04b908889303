"""whisper-tiny [audio]: 4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.

Encoder-decoder; conv/mel frontend is a STUB — inputs are precomputed
frame embeddings (B, 1500, 384) per the assignment. [arXiv:2212.04356]
"""

from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    activation="gelu",
    block_pattern="attn",
    encoder=EncoderConfig(n_layers=4, n_frames=1500),
)

SMOKE = CONFIG.with_(
    name="whisper-tiny-smoke",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    encoder=EncoderConfig(n_layers=2, n_frames=16),
)
