"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early fusion; VQ image-token frontend is a STUB (image
patches arrive as token ids in the unified vocab). [arXiv:2405.09818]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=65_536,
    activation="silu",
    use_qk_norm=True,      # chameleon's qk-norm is load-bearing at 34B
)

SMOKE = CONFIG.with_(
    name="chameleon-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
)
