"""rwkv6-1.6b [ssm] Finch: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — data-dependent decay. [arXiv:2404.05892]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # = d_model / rwkv_head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    block_pattern="rwkv6",
    rwkv_head_size=64,
    # chunked WKV recurrence (bit-exact vs per-step scan; §Perf hillclimb
    # winner: memory term -69% on train_4k)
    rwkv_chunk=16,
)

SMOKE = CONFIG.with_(
    name="rwkv6-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    rwkv_head_size=16,
)
