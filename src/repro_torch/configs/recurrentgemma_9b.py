"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attention, pattern (R,R,A).
[arXiv:2402.19427]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,           # 12 x (R,R,A) groups + 2 trailing recurrent
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    activation="gelu",
    block_pattern="griffin",
    attn_window=2048,
    conv1d_width=4,
)

SMOKE = CONFIG.with_(
    name="recurrentgemma-smoke",
    n_layers=5,            # 1 group + 2 tail
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    attn_window=8,
)
