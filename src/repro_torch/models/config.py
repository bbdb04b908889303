"""Model configuration for the ten assigned architectures.

One dataclass drives every family; ``block_pattern`` selects the layer
algebra (full attention, RWKV6 time-mix, Griffin RG-LRU/local-attn mix,
encoder-decoder).

The port's copy of ``repro.models.config``: the same dataclasses, fields,
defaults and parameter counts; ``ModelConfig.dt`` is a ``torch.dtype``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    expert_d_ff: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    norm_topk: bool = True
    #: pad the expert dimension to this size (0 = no padding) so expert
    #: parallelism shards evenly on meshes the true count doesn't divide
    #: (GShard-style padding; padded experts are masked out of routing).
    pad_experts_to: int = 0

    @property
    def n_experts_padded(self) -> int:
        return max(self.n_experts, self.pad_experts_to)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style audio encoder; the conv frontend is a stub — inputs
    are precomputed frame embeddings (B, n_frames, d_model)."""

    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    activation: str = "silu"       # silu (gated) | gelu (gated) | squared_relu
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    block_pattern: str = "attn"    # attn | rwkv6 | griffin | encdec
    attn_window: int = 0           # 0 = global causal; >0 local window
    moe: Optional[MoEConfig] = None
    encoder: Optional[EncoderConfig] = None
    rwkv_head_size: int = 64
    #: WKV recurrence chunk (1 = per-step scan; >1 = chunked, §Perf)
    rwkv_chunk: int = 1
    conv1d_width: int = 4          # griffin temporal conv
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"        # compute/param dtype
    tie_embeddings: bool = False
    #: remat policy for scan-over-layers: none|minimal|full
    remat: str = "full"
    #: Megatron-style sequence parallelism: residual stream + norms run
    #: T-sharded over the model axis; gathers/reduce-scatters bracket the
    #: attention and MLP blocks (beyond-paper §Perf optimization).
    seq_parallel: bool = False
    #: all-reduce TP partial sums in bf16 instead of f32 (halves the TP
    #: collective bytes; bf16 accumulation on the reduced dots)
    tp_reduce_bf16: bool = False
    #: MoE dispatch: "scatter" (global-view GSPMD) | "shard_map" (explicit
    #: per-shard dispatch: one combine-psum per layer instead of GSPMD's
    #: dispatch-buffer all-reduces; beyond-paper §Perf optimization)
    moe_dispatch: str = "scatter"
    #: RMSNorm: keep only the variance statistic in f32 and normalize in
    #: the compute dtype — halves the d_model-wide f32 elementwise chains
    #: the norm backward otherwise creates (beyond-paper §Perf)
    norm_stats_only_f32: bool = False
    #: cast the loss cotangent to bf16 before it backpropagates through
    #: the layer stack: activation gradients (and their TP all-reduces)
    #: run in bf16 instead of promoted f32 (beyond-paper §Perf; weight
    #: gradients still accumulate in f32 inside the dots / optimizer)
    bwd_bf16: bool = False
    #: attention implementation: dense | blockwise (flash-style streaming)
    attn_impl: str = "dense"
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    #: max decode positions a KV cache supports (set by the serve shape)
    max_cache_len: int = 4096

    @property
    def dhead(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dt(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    @property
    def sub_quadratic(self) -> bool:
        """True if a 500k-token context is served without a full-attention
        KV cache (SSM state and/or bounded-window attention)."""
        return self.block_pattern in ("rwkv6", "griffin")

    def griffin_pattern(self) -> list[str]:
        """Layer types for block_pattern='griffin': (R, R, A) repeating,
        trailing remainder recurrent (DESIGN.md §5)."""
        kinds = []
        for i in range(self.n_layers):
            kinds.append("attn" if i % 3 == 2 else "rec")
        return kinds

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        e, h = self.d_model, self.dhead
        att = e * self.n_heads * h + 2 * e * self.n_kv_heads * h + self.n_heads * h * e
        if self.activation == "squared_relu":
            mlp = 2 * e * self.d_ff
        else:
            mlp = 3 * e * self.d_ff
        if self.moe:
            m = self.moe
            emlp = 3 * e * m.expert_d_ff
            mlp = m.n_experts * emlp + e * m.n_experts
            if m.n_shared_experts:
                mlp += 3 * e * (m.n_shared_experts * m.expert_d_ff)
        if self.block_pattern == "rwkv6":
            # r,k,v,g,o + decay/mix loras + channel mix
            blk = 5 * e * e + 2 * e * self.d_ff + e * self.d_ff
        elif self.block_pattern == "griffin":
            kinds = self.griffin_pattern()
            n_rec = sum(1 for k in kinds if k == "rec")
            n_att = len(kinds) - n_rec
            rec = 3 * e * e + self.conv1d_width * e
            per_att = att
            blk_total = n_rec * (rec + mlp) + n_att * (per_att + mlp)
            emb = self.vocab_size * e * (1 if self.tie_embeddings else 2)
            return blk_total + emb
        else:
            blk = att + mlp
        total = self.n_layers * blk
        if self.is_encdec:
            total += self.encoder.n_layers * (att + mlp)
            total += self.n_layers * (att)  # cross-attention
        emb = self.vocab_size * e * (1 if self.tie_embeddings else 2)
        return total + emb

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed-in experts)."""
        if not self.moe:
            return self.n_params()
        m = self.moe
        e = self.d_model
        emlp = 3 * e * m.expert_d_ff
        dense_like = self.n_params() - self.n_layers * (m.n_experts * emlp)
        return dense_like + self.n_layers * (m.experts_per_token * emlp)
