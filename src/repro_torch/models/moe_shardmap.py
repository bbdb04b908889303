"""shard_map MoE dispatch (opt-in via ``moe_dispatch="shard_map"``).

The port of ``repro.models.moe_shardmap``.  Under a mesh the data plane
is explicit per shard:

  * x is replicated across the model axis within each data shard, so
    "dispatch to the model shard owning expert e" is a local slice;
  * each model shard runs its E/n_model experts over the local tokens;
  * the only collective on the way out is one all-reduce of the combined
    token outputs (B_loc, T, D) over the model axis per layer.

Capacity semantics: per-(data-shard, expert) queues (local capacity
``ceil(S_loc * k / Ep * capacity_factor)``, over the *padded* expert
count), the standard large-scale variant of GShard capacity.  FSDP'd
expert weights are all-gathered over the data axes on entry to the shard
(the gather GSPMD would insert).

The per-shard body (:func:`_local_moe`) runs on local tensors through
:func:`repro_torch.models.sharding.local_region`; its output is a partial
sum over ``"model"``, which the caller's constraint all-reduces.
"""

from __future__ import annotations

import functools
import math

import torch

from .config import ModelConfig
from .sharding import Summed, axis_size, constrain, local_region

__all__ = ["moe_apply_shardmap"]


def _local_moe(xt, top_w, top_ids, wg, wi, wo, *, cfg: ModelConfig, n_model: int,
               shard: int):
    """Per-shard body. xt: (S_loc, D) tokens and their routing, top_w /
    top_ids (S_loc, k); wg/wi/wo: (Ep/n_model, D, F) / (Ep/n_model, F, D),
    this shard's experts, gathered over the data axes.  Returns this
    shard's part of the combined outputs (S_loc, D)."""
    from .layers import moe_slots, silu

    m = cfg.moe
    ep, k = m.n_experts_padded, m.experts_per_token
    s_loc, d = xt.shape
    cap = int(math.ceil(s_loc * k / ep * m.capacity_factor))
    flat_ids, flat_w = top_ids.reshape(-1), top_w.reshape(-1)
    slot = moe_slots(flat_ids, ep)
    keep = slot < cap
    slot_c = torch.where(keep, slot, 0)

    xe = xt.repeat_interleave(k, dim=0)                        # (S*k, D)
    spare = torch.zeros((ep, cap + 1, d), dtype=xt.dtype, device=xt.device)
    dispatched = spare.index_put((flat_ids, torch.where(keep, slot, cap)), xe)[:, :cap]

    # keep only this model shard's experts (x is replicated over 'model',
    # so this is a free slice, not a communication)
    e_loc = ep // n_model
    local = dispatched[shard * e_loc:(shard + 1) * e_loc]
    g = silu(torch.bmm(local, wg))
    h = g * torch.bmm(local, wi)
    out_e = torch.bmm(h, wo)                                   # (E_loc, cap, D)

    # back into the full-Ep layout (zeros elsewhere), gather the per-token
    # results, weight them; the caller sums the partials over 'model'
    full = torch.cat([out_e.new_zeros((shard * e_loc, cap, d)), out_e,
                      out_e.new_zeros((ep - (shard + 1) * e_loc, cap, d))])
    gathered = torch.where(keep[:, None], full[flat_ids, slot_c], 0)
    return (gathered * flat_w[:, None].to(gathered.dtype)).reshape(s_loc, k, d).sum(dim=1)


def moe_apply_shardmap(p, xt, top_w, top_ids, cfg: ModelConfig, mesh):
    """Drop-in for the expert part of ``moe_apply`` (shared experts and the
    aux loss stay in the global-view caller).  xt: (S, D) global tokens;
    top_w / top_ids: their routing (S, k), computed once in the global
    view, where the reference's shards each recompute their own tokens'
    (the same values).  Returns the combined outputs (S, D)."""
    n_model = axis_size(mesh, "model")
    shard = mesh.get_local_rank("model") if hasattr(mesh, "get_local_rank") else 0
    body = functools.partial(_local_moe, cfg=cfg, n_model=n_model, shard=shard)
    tokens = ("batch", None)
    experts = ("experts", None, None)
    region = local_region(body, (tokens, tokens, tokens, experts, experts, experts),
                          (Summed(tokens, ("model",)),))
    out = region(xt, top_w, top_ids, p["wg"], p["wi"], p["wo"])
    return constrain(out, tokens)          # the psum over 'model'
