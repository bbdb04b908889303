"""The tensors of a DeepSeek-V2(-Lite) state dict that one expert-parallel
rank writes to its checkpoint, as ``DeepseekV2ForCausalLM.state_dict()``
names and orders them (Hugging Face ``modeling_deepseek.py``: a decoder
layer registers ``self_attn``, ``mlp``, ``input_layernorm``,
``post_attention_layernorm``; an MoE block ``experts``, ``gate``,
``shared_experts``; with ``ep_size`` > 1 a rank holds the routed experts
``rank * n / ep_size`` to ``(rank + 1) * n / ep_size - 1``).  Every other
tensor is held alike by every rank and written by each.  Plain Python:
the checkpoint cell's payload table is checked against it.
"""

from __future__ import annotations

import math

__all__ = ["leaves", "param_count"]


def _mlp(prefix: str, hidden: int, width: int) -> list:
    return [(f"{prefix}.gate_proj.weight", (width, hidden)),
            (f"{prefix}.up_proj.weight", (width, hidden)),
            (f"{prefix}.down_proj.weight", (hidden, width))]


def _attention(prefix: str, c: dict) -> list:
    h, heads = c["hidden_size"], c["num_attention_heads"]
    q_dim = heads * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"])
    if c.get("q_lora_rank") is None:
        q = [(f"{prefix}.q_proj.weight", (q_dim, h))]
    else:
        r = c["q_lora_rank"]
        q = [(f"{prefix}.q_a_proj.weight", (r, h)),
             (f"{prefix}.q_a_layernorm.weight", (r,)),
             (f"{prefix}.q_b_proj.weight", (q_dim, r))]
    kv = c["kv_lora_rank"]
    return q + [
        (f"{prefix}.kv_a_proj_with_mqa.weight", (kv + c["qk_rope_head_dim"], h)),
        (f"{prefix}.kv_a_layernorm.weight", (kv,)),
        (f"{prefix}.kv_b_proj.weight", (heads * (c["qk_nope_head_dim"] + c["v_head_dim"]), kv)),
        (f"{prefix}.o_proj.weight", (h, heads * c["v_head_dim"])),
    ]


def leaves(config: dict, ep_size: int = 1, ep_rank: int = 0) -> list[tuple[str, tuple]]:
    """(name, shape) of every tensor rank ``ep_rank`` of ``ep_size``
    writes, in ``state_dict`` order, for a model config with the published
    keys (``n_routed_experts`` is the model's whole count)."""
    c = config
    h = c["hidden_size"]
    n_exp = c["n_routed_experts"]
    if n_exp % ep_size or not 0 <= ep_rank < ep_size:
        raise ValueError(f"{n_exp} experts cannot be shared by rank {ep_rank} of {ep_size}")
    per_rank = n_exp // ep_size
    out = [("model.embed_tokens.weight", (c["vocab_size"], h))]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out += _attention(f"{p}.self_attn", c)
        moe = i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0
        if moe:
            for e in range(ep_rank * per_rank, (ep_rank + 1) * per_rank):
                out += _mlp(f"{p}.mlp.experts.{e}", h, c["moe_intermediate_size"])
            out.append((f"{p}.mlp.gate.weight", (n_exp, h)))
            if c.get("n_shared_experts"):
                out += _mlp(f"{p}.mlp.shared_experts", h,
                            c["moe_intermediate_size"] * c["n_shared_experts"])
        else:
            out += _mlp(f"{p}.mlp", h, c["intermediate_size"])
        out += [(f"{p}.input_layernorm.weight", (h,)),
                (f"{p}.post_attention_layernorm.weight", (h,))]
    out.append(("model.norm.weight", (h,)))
    if not c.get("tie_word_embeddings"):
        out.append(("lm_head.weight", (c["vocab_size"], h)))
    return out


def param_count(table) -> int:
    return sum(math.prod(shape) for _, shape in table)
