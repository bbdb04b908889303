"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,               # per-expert ffn dim
    vocab_size=151_936,
    activation="silu",
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_experts=128, experts_per_token=8, expert_d_ff=768, norm_topk=True
    ),
    # explicit shard_map dispatch: one combine-psum per layer instead of
    # GSPMD dispatch-buffer all-reduces (§Perf: collective -89%)
    moe_dispatch="shard_map",
)

SMOKE = CONFIG.with_(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    moe=MoEConfig(n_experts=8, experts_per_token=2, expert_d_ff=96),
)
