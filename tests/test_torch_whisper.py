"""The port's encoder-decoder (whisper-tiny: the reference's stub, frame
embeddings in, no conv/mel frontend) held against the JAX package's on
the CPU: the cross-attention helpers, the ``_qkv`` forms they build on,
the encoder, and the decoder's prefill / decode / serving with ``frames``.

Params are made by the JAX package and carried across with
``params_from_numpy`` (bit for bit); frames and tokens come from a numpy
seed.  Tolerances as ``test_torch_models.py`` states them: f32 layers
within ``LAYER_TOL`` = 1e-5, the model within ``F32_TOL`` = 1e-4, bf16
layers alone bit-equal.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as JL
import repro.models.model as JM
from repro.models import init_params as j_init

import repro_torch.configs as tconfigs
import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro_torch.models import forward, init_params, params_from_numpy, prefill
from repro_torch.serve import ServeConfig, ServingEngine
from repro_torch.serve.engine import prime

LAYER_TOL, F32_TOL = 1e-5, 1e-4
ARCH = "whisper_tiny"


def configs(dtype: str = "float32", **kw):
    return (jconfigs.get_config(ARCH, True).with_(dtype=dtype, **kw),
            tconfigs.get_config(ARCH, True).with_(dtype=dtype, **kw))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _err(a, b) -> float:
    return float(np.abs(_np(a) - b.detach().float().numpy()).max())


def port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def frames(cfg, b: int = 2, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)


def _dt(dtype):
    return (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                    torch.bfloat16)


@functools.lru_cache(maxsize=None)
def model_pair():
    jc, tc = configs()
    jp = jax.jit(lambda k: j_init(jc, k))(jax.random.PRNGKey(0))
    return jc, tc, jp, port(jp)


# -- layers --------------------------------------------------------------------------


def test_cross_attention_params_have_no_qk_norm():
    """``init_attention(cross=True)`` leaves out the qk-norm scales even
    where the config asks for them (``use_qk_norm``)."""
    jc, tc = configs(use_qk_norm=True)
    gen = torch.Generator().manual_seed(0)
    assert sorted(TL.init_attention(tc, gen, device="cpu")) == sorted(
        JL.init_attention(jc, jax.random.PRNGKey(0)))
    cross = TL.init_attention(tc, gen, cross=True, device="cpu")
    assert sorted(cross) == sorted(JL.init_attention(jc, jax.random.PRNGKey(0), cross=True))
    assert "q_norm" not in cross and "k_norm" not in cross


@pytest.mark.parametrize("use_rope", [True, False])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_with_kv_source(qk_norm, use_rope):
    """The reference's ``_qkv`` form with its own K/V source and
    positions, RoPE on or off."""
    jc, tc = configs(use_qk_norm=qk_norm)
    jp = JL.init_attention(jc, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    x, xkv = rng.standard_normal((2, 5, jc.d_model)), rng.standard_normal((2, 7, jc.d_model))
    pos = np.broadcast_to(np.arange(5, dtype=np.int32) + 3, (2, 5)).copy()
    kpos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    want = jax.jit(lambda p, a, b: JL._qkv(p, a, b, jc, pos, kpos, use_rope=use_rope))(
        jp, jnp.asarray(x, jnp.float32), jnp.asarray(xkv, jnp.float32))
    got = TL._qkv(port(jp), torch.from_numpy(x).float(), tc, torch.from_numpy(pos),
                  x_kv=torch.from_numpy(xkv).float(), kv_positions=torch.from_numpy(kpos),
                  use_rope=use_rope)
    for a, b in zip(want, got):
        assert a.shape == tuple(b.shape)
        assert _err(a, b) < LAYER_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_cross_and_encode_cross_kv(dtype):
    jc, tc = configs(dtype)
    jdt, tdt = _dt(dtype)
    jp = JL.init_attention(jc, jax.random.PRNGKey(2), cross=True)
    tp = port(jp)
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, jc.encoder.n_frames, jc.d_model))
    x = rng.standard_normal((2, 3, jc.d_model))
    jkv = jax.jit(lambda p, e: JL.encode_cross_kv(p, e, jc))(jp, jnp.asarray(enc, jdt))
    tkv = TL.encode_cross_kv(tp, torch.from_numpy(enc).to(tdt), tc)
    tol = LAYER_TOL if dtype == "float32" else 0.0
    for n in ("k", "v"):
        assert tkv[n].shape == (2, jc.encoder.n_frames, jc.n_kv_heads, jc.dhead)
        assert _err(jkv[n], tkv[n]) <= tol
    ja = jax.jit(lambda p, x, kv: JL.attention_cross(p, x, kv, jc))(jp, jnp.asarray(x, jdt), jkv)
    ta = TL.attention_cross(tp, torch.from_numpy(x).to(tdt), tkv, tc)
    assert _err(ja, ta) <= tol


def test_encoder():
    """Bidirectional self-attention over the frames with RoPE at frame
    positions, no mask; the encoder's final norm."""
    jc, tc, jp, tp = model_pair()
    f = frames(jc)
    want = jax.jit(lambda p, f: JM._encode(p, f, jc))(jp, jnp.asarray(f))
    got = TM._encode(tp, torch.from_numpy(f), tc)
    assert got.shape == (2, jc.encoder.n_frames, jc.d_model)
    assert _err(want, got) < F32_TOL


# -- the model -----------------------------------------------------------------------


def test_prefill_carries_cross_kv_into_serving():
    """prefill computes each layer's cross-attention K/V once; ``prime``
    carries them into the full-size state beside a KV cache of the whole
    output, the prompt's K/V replayed at its head."""
    jc, tc, jp, tp = model_pair()
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 6)).astype(np.int32)
    f = frames(jc, seed=3)
    jl, jst = jax.jit(lambda p, t, f: JM.prefill(p, t, jc, f))(jp, toks, jnp.asarray(f))
    tl, tst = prefill(tp, toks, tc, frames=f, device="cpu")
    assert _err(jl, tl) < F32_TOL
    assert sorted(tst) == ["cross_kv", "layers"]
    for n in ("k", "v"):
        assert tst["cross_kv"][n].shape == (jc.n_layers, 2, jc.encoder.n_frames,
                                            jc.n_kv_heads, jc.dhead)
        assert _err(jst["cross_kv"][n], tst["cross_kv"][n]) < F32_TOL
    logits, state = prime(tp, toks, tc, 10, "cpu", frames=f)
    assert torch.equal(logits, tl)
    assert all(torch.equal(state["cross_kv"][n], tst["cross_kv"][n]) for n in ("k", "v"))
    assert state["layers"]["k"].shape[2] == 10
    assert torch.equal(state["layers"]["k"][:, :, :6], tst["layers"]["k"])
    assert not state["layers"]["k"][:, :, 6:].any()


def test_served_tokens_depend_on_the_frames():
    """The engine with frames gives the tokens of repeated full forwards
    on the same frames; other frames change the logits."""
    jc, tc, jp, tp = model_pair()
    p = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 5)).astype(np.int32)
    f = frames(jc, seed=4)
    ids, logits = ServingEngine(tc, tp, ServeConfig(max_new_tokens=4), device="cpu").generate(
        p, frames=f, return_logits=True)
    toks = torch.from_numpy(p).long()
    for i in range(4):
        full, aux = forward(tp, toks, tc, frames=f, device="cpu")
        assert float(aux) == 0.0
        assert float((logits[:, i] - full[:, -1]).abs().max()) < F32_TOL
        toks = torch.cat([toks, full[:, -1].argmax(-1)[:, None]], dim=1)
    np.testing.assert_array_equal(ids, toks.numpy())
    other, _ = forward(tp, p, tc, frames=frames(jc, seed=5), device="cpu")
    assert float((other[:, -1] - logits[:, 0]).abs().max()) > 1e-3


def test_frames_are_needed_and_checked():
    _, tc = configs()
    params = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    toks = np.zeros((1, 4), np.int32)
    for call in (forward, prefill):
        with pytest.raises(ValueError, match="encoder-decoder: pass frames"):
            call(params, toks, tc, device="cpu")
    meta = torch.zeros((1, tc.encoder.n_frames, tc.d_model), device="meta")
    with pytest.raises(ValueError, match="not on cpu"):
        forward(params, toks, tc, frames=meta, device="cpu")
    # a model without an encoder ignores frames, as the reference does
    yc = tconfigs.get_config("yi_6b", True)
    yp = init_params(yc, torch.Generator().manual_seed(0), device="cpu")
    a = forward(yp, toks, yc, device="cpu")[0]
    assert torch.equal(a, forward(yp, toks, yc, frames=np.ones((1, 3, 3)), device="cpu")[0])
