"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — GQA, squared-ReLU MLP. [arXiv:2402.16819]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    activation="squared_relu",
)

SMOKE = CONFIG.with_(
    name="nemotron-4-340b-smoke",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=256,
)
