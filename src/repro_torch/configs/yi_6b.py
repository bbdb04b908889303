"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA. [arXiv:2403.04652]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    activation="silu",
    rope_theta=5_000_000.0,
)

SMOKE = CONFIG.with_(
    name="yi-6b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
