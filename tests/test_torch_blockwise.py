"""The port's blockwise attention (``repro_torch.models.layers.
blockwise_sdpa``) held against the JAX package's ``blockwise_sdpa``.

Inputs come from a numpy seed.  Tolerances, on max abs error as a share
of the reference's max |x|:

* f32: ``F32_TOL`` = 1e-5, for the output and for the gradients of q, k
  and v (``jax.grad`` against ``torch.autograd``): the two differ only in
  summation order and in where XLA fuses a multiply-add.
* bf16: ``BF16_TOL`` = 1e-2 of the output's max, a little over one bf16
  ulp at the max: both widen bf16 operands exactly and accumulate in f32,
  then round the output to bf16, so only the last rounding may flip.

The dispatch (``self_attention``) takes the blockwise path under the
reference's conditions only: ``attn_impl="blockwise"``, t > 1 and block
sizes that divide the lengths.  A smoke config's forward with
``attn_impl="blockwise"`` is held to the reference's in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as JL
from repro.models import forward as j_forward
from repro.models import init_params as j_init

import repro_torch.configs as tconfigs
import repro_torch.models.layers as TL
from repro_torch.models import forward, params_from_numpy

F32_TOL = 1e-5
BF16_TOL = 1e-2

#: (b, t, s, hq, hkv, d, block_q, block_kv, window, q_offset)
CASES = {
    "causal_one_block": (2, 16, 16, 4, 4, 8, 16, 16, 0, 0),
    "causal_nq_nk": (2, 32, 32, 4, 4, 8, 8, 16, 0, 0),
    "gqa_g4": (1, 32, 32, 8, 2, 16, 8, 8, 0, 0),
    "window": (2, 32, 32, 4, 2, 8, 8, 8, 12, 0),
    "q_offset": (1, 16, 48, 4, 4, 8, 8, 16, 0, 32),
    "window_offset_gqa": (2, 16, 64, 6, 2, 8, 4, 16, 20, 48),
}


def inputs(case: str, seed: int = 0):
    b, t, s, hq, hkv, d = CASES[case][:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    gy = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    return q, k, v, gy


def cfgs(case: str, dtype: str = "float32"):
    bq, bk = CASES[case][6:8]
    base = jconfigs.get_config("qwen3_8b", True).with_(
        attn_block_q=bq, attn_block_kv=bk, attn_impl="blockwise", dtype=dtype)
    tbase = tconfigs.get_config("qwen3_8b", True).with_(
        attn_block_q=bq, attn_block_kv=bk, attn_impl="blockwise", dtype=dtype)
    return base, tbase


def of_max(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_f32_matches_reference(case):
    window, q_offset = CASES[case][8:]
    q, k, v, _ = inputs(case)
    jc, tc = cfgs(case)
    want = np.asarray(JL.blockwise_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                                        window=window, q_offset=q_offset))
    got = TL.blockwise_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            tc, window=window, q_offset=q_offset).numpy()
    assert got.shape == want.shape
    assert of_max(got, want) <= F32_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_f32_match_jax_grad(case):
    window, q_offset = CASES[case][8:]
    q, k, v, gy = inputs(case)
    jc, tc = cfgs(case)

    def jloss(q, k, v):
        out = JL.blockwise_sdpa(q, k, v, jc, window=window, q_offset=q_offset)
        return jnp.sum(out * jnp.asarray(gy))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = TL.blockwise_sdpa(tq, tk, tv, tc, window=window, q_offset=q_offset)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(gy))
    for g, w in zip(got, want):
        assert of_max(g.numpy(), np.asarray(w)) <= F32_TOL


@pytest.mark.parametrize("case", ["causal_nq_nk", "gqa_g4", "window_offset_gqa"])
def test_forward_bf16_within_bound(case):
    window, q_offset = CASES[case][8:]
    q, k, v, _ = inputs(case)
    jc, tc = cfgs(case, "bfloat16")
    want = np.asarray(JL.blockwise_sdpa(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), jc,
        window=window, q_offset=q_offset).astype(jnp.float32))
    got = TL.blockwise_sdpa(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                            tc, window=window, q_offset=q_offset)
    assert got.dtype == torch.bfloat16
    assert of_max(got.float().numpy(), want) <= BF16_TOL


def test_backward_recomputes_each_query_block():
    """The per-q-block body runs again in the backward pass (the
    ``jax.checkpoint`` counterpart): the number of f32 score products
    doubles for the forward's blocks."""
    q, k, v, gy = inputs("causal_nq_nk")
    _, tc = cfgs("causal_nq_nk")
    calls = []
    real = TL._dot_f32

    def spy(spec, a, b):
        calls.append(spec)
        return real(spec, a, b)

    TL._dot_f32 = spy
    try:
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = TL.blockwise_sdpa(tq, tk, tv, tc)
        fwd = len(calls)
        torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(gy))
    finally:
        TL._dot_f32 = real
    nq, nk = 32 // 8, 32 // 16
    assert fwd == 2 * nq * nk
    assert len(calls) == 2 * fwd


@pytest.mark.parametrize("t,s,bq,bk,blockwise", [
    (1, 16, 8, 8, False),       # a decode step: dense
    (12, 12, 8, 8, False),      # 12 % 8: dense
    (16, 20, 8, 8, False),      # 20 % 8: dense
    (16, 16, 8, 8, True),
    (16, 16, 512, 1024, True),  # blocks larger than the lengths: one block
])
def test_dispatch_conditions_match_reference(t, s, bq, bk, blockwise):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, t, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, s, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, s, 2, 8)).astype(np.float32)
    jc = jconfigs.get_config("qwen3_8b", True).with_(
        attn_block_q=bq, attn_block_kv=bk, attn_impl="blockwise", dtype="float32")
    tc = tconfigs.get_config("qwen3_8b", True).with_(
        attn_block_q=bq, attn_block_kv=bk, attn_impl="blockwise", dtype="float32")
    off = s - t
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = TL.self_attention(tq, tk, tv, tc, q_offset=off)
    want = np.asarray(JL.self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                                        q_offset=off))
    assert of_max(got.numpy(), want) <= F32_TOL
    if blockwise:
        assert torch.equal(got, TL.blockwise_sdpa(tq, tk, tv, tc, q_offset=off))
    else:
        dense = TL._sdpa(tq, tk, tv, TL.causal_mask(t, s, offset=off), tc)
        assert torch.equal(got, dense)


@pytest.mark.parametrize("arch", ["qwen3_8b", "recurrentgemma_9b"])
def test_smoke_forward_with_blockwise_matches_reference(arch):
    jc = jconfigs.get_config(arch, True).with_(
        attn_impl="blockwise", attn_block_q=8, attn_block_kv=8, dtype="float32")
    tc = tconfigs.get_config(arch, True).with_(
        attn_impl="blockwise", attn_block_q=8, attn_block_kv=8, dtype="float32")
    jparams = j_init(jc, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(j_forward(jparams, jnp.asarray(toks), jc)[0])
    got = forward(params, toks, tc, device="cpu")[0].numpy()
    assert np.abs(got - want).max() <= 1e-4
