"""The port's token-serving engine (``repro_torch.serve.engine``) held
against the JAX package's on the CPU.

Each package makes its own params from ``PRNGKey(0)`` (f32), and they
are bit-equal; prompts come from a numpy seed.  Greedy tokens must
be equal: in f32 the two packages' logits differ by ~5e-6
(``tests/test_torch_models.py``), far below the gap between the two
largest logits of these prompts.  Sampling at ``temperature > 0`` draws
``jax.random.categorical``'s tokens (``repro_torch.prng``, the same key
schedule), so it is held to the JAX engine's tokens too, at temperatures
0.7 and 1.0: the Gumbel noise is bit-equal and the two packages' f32
logits differ by ~5e-6, below the gaps that decide these samples.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch
from jax_reference_params import eager_params

from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine

import repro_torch.configs as tconfigs
from repro_torch.models import forward, init_params
from repro_torch.prng import PRNGKey
from repro_torch.serve import ServeConfig, ServingEngine, TokenServingEngine

SUPPORTED = ["qwen3_8b", "yi_6b", "nemotron_4_15b", "nemotron_4_340b",
             "chameleon_34b", "rwkv6_1_6b", "recurrentgemma_9b", "qwen2_moe_a2_7b",
             "qwen3_moe_30b_a3b", "whisper_tiny"]
NEW = 6


@functools.lru_cache(maxsize=None)
def _jax_params() -> dict:
    return eager_params(SUPPORTED, 0, "float32")


@functools.lru_cache(maxsize=None)
def pair(arch: str):
    """(jax cfg, port cfg, jax params, port params), f32, smoke size: each
    package's own params from ``PRNGKey(0)``, bit-equal
    (``tests/test_torch_init_seeded.py``; the JAX package's made eagerly,
    ``tests/jax_reference_params.py``)."""
    jc, jp = _jax_params()[arch]
    tc = tconfigs.get_config(arch, smoke=True).with_(dtype="float32")
    return jc, tc, jp, init_params(tc, PRNGKey(0), device="cpu")


def prompts(vocab: int, b: int, t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def frames(cfg, b: int, seed: int = 0):
    """An encoder-decoder's frame embeddings from a numpy seed, else None."""
    if not cfg.is_encdec:
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_engine(arch: str) -> JServingEngine:
    """One JAX engine a config, so its jitted prefill and step compile once."""
    jc, _, jp, _ = pair(arch)
    return JServingEngine(jc, jp)


def engines(arch: str, **kw):
    _, tc, _, tp = pair(arch)
    jeng = jax_engine(arch)
    jeng.scfg = JServeConfig(**kw)
    jeng.metrics = {"prefill_s": 0.0, "decode_s": 0.0, "tokens_out": 0}
    return jeng, ServingEngine(tc, tp, ServeConfig(**kw), device="cpu")


@pytest.mark.parametrize("t", [7, 16])
@pytest.mark.parametrize("arch", SUPPORTED)
def test_greedy_equals_jax(arch, t):
    jeng, teng = engines(arch, max_new_tokens=NEW)
    p = prompts(pair(arch)[1].vocab_size, 2, t, seed=t)
    f = frames(pair(arch)[1], 2, seed=t)
    want = jeng.generate(p, f)
    got = teng.generate(p, frames=f)
    assert got.dtype == np.int32 and got.shape == (2, t + NEW)
    np.testing.assert_array_equal(got, want)
    assert teng.metrics["tokens_out"] == jeng.metrics["tokens_out"] == 2 * NEW


@pytest.mark.parametrize("arch", ["yi_6b", "qwen3_8b", "rwkv6_1_6b", "recurrentgemma_9b",
                                  "whisper_tiny"])
def test_greedy_continuation_matches_full_forward(arch):
    """The prefill-replay + decode path gives the tokens of repeated full
    forwards (the reference's test_serve.py invariant), and the logits it
    returns are the ones each token was taken from.  Griffin's 7-token
    prompt and 5 new tokens pass its 8-slot ring's wrap."""
    _, tc, _, tp = pair(arch)
    p = prompts(tc.vocab_size, 2, 7)
    f = frames(tc, 2)
    fast, logits = ServingEngine(tc, tp, ServeConfig(max_new_tokens=5),
                                 device="cpu").generate(p, frames=f, return_logits=True)
    toks = torch.from_numpy(p).long()
    for i in range(5):
        full, _ = forward(tp, toks, tc, frames=f, device="cpu")
        assert torch.allclose(logits[:, i], full[:, -1], atol=1e-4, rtol=0)
        toks = torch.cat([toks, full[:, -1].argmax(-1)[:, None]], dim=1)
    np.testing.assert_array_equal(fast, toks.numpy())
    np.testing.assert_array_equal(fast[:, 7:], logits.argmax(-1).numpy())


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_1_6b"])
def test_eos_early_stop_equals_jax(arch):
    jc, tc, jp, tp = pair(arch)
    p = np.ones((1, 4), np.int32)
    probe = ServingEngine(tc, tp, ServeConfig(max_new_tokens=3), device="cpu").generate(p)
    eos = int(probe[0, 4])
    jeng, teng = engines(arch, max_new_tokens=16, eos_id=eos)
    got, want = teng.generate(p), jeng.generate(p)
    assert got.shape[1] < 4 + 16
    np.testing.assert_array_equal(got, want)
    assert teng.metrics["tokens_out"] == jeng.metrics["tokens_out"] == 1


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_1_6b"])
def test_tokens_out_accounting_equals_jax(arch):
    """Rows that hit eos at different steps: padding after a row's eos
    is not counted, its eos is; the totals and ids equal the reference's."""
    jc, tc, jp, tp = pair(arch)
    p = prompts(tc.vocab_size, 3, 5, seed=3)
    free = ServingEngine(tc, tp, ServeConfig(max_new_tokens=8), device="cpu").generate(p)
    eos = int(free[1, 5 + 2])            # row 1 ends on its third new token
    jeng, teng = engines(arch, max_new_tokens=8, eos_id=eos)
    got, want = teng.generate(p), jeng.generate(p)
    np.testing.assert_array_equal(got, want)
    assert teng.metrics["tokens_out"] == jeng.metrics["tokens_out"]
    assert teng.metrics["tokens_out"] < 3 * 8
    assert teng.decode_tokens_per_s > 0


@pytest.mark.parametrize("arch", SUPPORTED)
def test_sampling_is_seeded(arch):
    """At temperatures 0.7 and 1.0 the tokens equal the JAX engine's for
    the same seed (8 new tokens, f32); one seed gives one stream, another
    seed another."""
    _, tc, _, tp = pair(arch)
    p7, f = prompts(tc.vocab_size, 2, 7), frames(tc, 2)
    for temperature in (0.7, 1.0):
        for seed in (0, 5):
            jeng, teng = engines(arch, max_new_tokens=8, temperature=temperature, seed=seed)
            np.testing.assert_array_equal(teng.generate(p7, frames=f), jeng.generate(p7, f))
    if arch != "yi_6b":
        return
    p = prompts(tc.vocab_size, 2, 6)

    def run(seed):
        return ServingEngine(tc, tp, ServeConfig(max_new_tokens=8, temperature=0.8,
                                                 seed=seed), device="cpu").generate(p)

    a, b, c = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (2, 14) and (a >= 0).all() and (a < tc.vocab_size).all()
    # the same engine twice: each call restarts from the seed
    eng = ServingEngine(tc, tp, ServeConfig(max_new_tokens=8, temperature=0.8, seed=5),
                        device="cpu")
    np.testing.assert_array_equal(eng.generate(p), eng.generate(p))
    assert eng.metrics["tokens_out"] == 2 * 2 * 8


def test_token_serving_alias():
    assert TokenServingEngine is ServingEngine
