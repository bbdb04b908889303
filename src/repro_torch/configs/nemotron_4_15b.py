"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP. [arXiv:2402.16819]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=256_000,
    activation="squared_relu",
)

SMOKE = CONFIG.with_(
    name="nemotron-4-15b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=256,
)
