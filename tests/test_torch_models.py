"""The port's model zoo (``repro_torch.models``, ``repro_torch.configs``)
held against the JAX package's on the CPU.

Configs are equal as data.  Params are made by the JAX package from
``PRNGKey(0)`` and carried across with ``params_from_numpy`` (bit for
bit), inputs come from a numpy seed, and both packages run the same
function on them.  Tolerances, on max abs error:

* f32: ``F32_TOL`` = 1e-4 on logits and states (measured ~5e-6 over
  two smoke layers: only the summation order of the matmuls differs);
  layers alone ``LAYER_TOL`` = 1e-5.
* bf16: ``BF16_TOL`` = 0.15 on logits, scaled by ``max(1, |ref|)`` on
  states (the MoE configs against the reference run op by op, see
  ``model_run``).  Every bf16 layer alone is bit-equal to the reference here
  (``test_bf16_layers_bit_equal``), but XLA on the CPU keeps excess
  precision across fused ops (a residual sum feeds the next norm
  unrounded), so whole blocks differ by a few bf16 ulps (measured
  0.03-0.07 on logits of magnitude 2-4, where an ulp is 0.0156).
* RoPE: ``rope_tol`` — one f32 ulp of a frequency times the position
  (XLA's and torch's f32 ``exp`` differ by an ulp on a few frequencies).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as JL
import repro.models.recurrent as JR
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models import init_serve_state as j_state
from repro.models import prefill as j_prefill

import repro_torch.configs as tconfigs
import repro_torch.models.layers as TL
import repro_torch.models.recurrent as TR
from repro_torch.checkpoint.manager import dtype_name
from repro_torch.models import (
    decode_step,
    flatten_params,
    forward,
    init_params,
    init_serve_state,
    loss_fn,
    params_from_numpy,
    prefill,
    unflatten_params,
)
from repro_torch.serve import ServingEngine

SUPPORTED = ["qwen3_8b", "yi_6b", "nemotron_4_15b", "nemotron_4_340b",
             "chameleon_34b", "rwkv6_1_6b", "recurrentgemma_9b", "qwen2_moe_a2_7b",
             "qwen3_moe_30b_a3b", "whisper_tiny"]
F32_TOL = 1e-4
BF16_TOL = 0.15
LAYER_TOL = 1e-5
B, T, DECODE_STEPS = 2, 13, 13


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, dtype=np.float32), dtype)


def _err(a, b) -> float:
    return float(np.abs(_np(a) - b.detach().float().numpy()).max())


def jax_paths(tree) -> list[tuple[str, tuple, str]]:
    """(dotted path, shape, dtype name) of every leaf, in jax.tree order."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(k.idx if isinstance(k, jax.tree_util.SequenceKey) else k.key)
                        for k in path)
        out.append((name, tuple(leaf.shape), jnp.dtype(leaf.dtype).name))
    return out


def to_port(jparams) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, dtype: str | None = None):
    jc, _ = configs(arch, dtype=dtype)
    return jax.jit(lambda key: j_init(jc, key))(jax.random.PRNGKey(0))


def frames_for(cfg, b: int = B, seed: int = 21):
    """An encoder-decoder's frame embeddings from a numpy seed, else None."""
    if not cfg.is_encdec:
        return None
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.encoder.n_frames, cfg.d_model)) * 0.1).astype(np.float32)


def configs(arch: str, smoke: bool = True, dtype: str | None = None):
    jc, tc = jconfigs.get_config(arch, smoke), tconfigs.get_config(arch, smoke)
    if dtype is not None:
        jc, tc = jc.with_(dtype=dtype), tc.with_(dtype=dtype)
    return jc, tc


# -- configs --------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equal(arch, smoke):
    jc, tc = configs(arch, smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.n_params() == jc.n_params()
    assert tc.n_active_params() == jc.n_active_params()
    assert (tc.dhead, tc.is_encdec, tc.sub_quadratic) == (jc.dhead, jc.is_encdec,
                                                          jc.sub_quadratic)
    assert tc.griffin_pattern() == jc.griffin_pattern()
    assert dtype_name(tc.dt) == jnp.dtype(jc.dt).name
    assert dataclasses.asdict(tc.with_(n_layers=3)) == dataclasses.asdict(jc.with_(n_layers=3))
    for shape in jconfigs.SHAPES:
        assert tconfigs.cell_supported(tc, shape) == jconfigs.cell_supported(jc, shape)


def test_registry_equal():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs._ALIASES == jconfigs._ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.all_cells() == jconfigs.all_cells()
    for alias in list(jconfigs._ALIASES) + jconfigs.ARCH_IDS:
        assert tconfigs.normalize(alias) == jconfigs.normalize(alias)
    for mod in (tconfigs, jconfigs):
        with pytest.raises(ValueError):
            mod.normalize("gpt-2")


# -- params -----------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", SUPPORTED)
def test_init_layout_equal(arch, smoke):
    """Leaf paths, shapes and dtypes equal the reference's (its tree under
    ``jax.eval_shape``; the port's on the meta device, at full size too)."""
    jc, tc = configs(arch, smoke)
    want = jax_paths(jax.eval_shape(lambda: j_init(jc, jax.random.PRNGKey(0))))
    params = init_params(tc, torch.Generator().manual_seed(0), device="meta")
    got = [(n, tuple(t.shape), dtype_name(t.dtype)) for n, t in flatten_params(params).items()]
    assert got == want
    assert sum(math.prod(s) for _, s, _ in got) == sum(math.prod(s) for _, s, _ in want)


#: fan-in of each dense leaf (its per-layer shape's input axes), by name.
def _fan_in(name: str, shape: tuple) -> int | None:
    leaf = name.rsplit(".", 1)[-1]
    per_layer = shape[1:] if name.startswith("layers.") else shape
    if name == "embed":
        return per_layer[1]
    if name.endswith("attn.wo"):
        return per_layer[0] * per_layer[1]
    if leaf == "tm_w2":
        return per_layer[1]
    if leaf in ("norm1", "norm2", "final_norm", "q_norm", "k_norm", "ln_scale",
                "x_maa", "maa", "mu_k", "mu_r", "decay_bias"):
        return None
    return per_layer[0]


@pytest.mark.parametrize("arch", ["qwen3_8b", "nemotron_4_15b", "rwkv6_1_6b"])
def test_init_statistics(arch):
    """Dense leaves draw N(0, 1/fan_in): std within 5%; ones, zeros and the
    decay bias are exact."""
    _, tc = configs(arch)
    tc = tc.with_(n_layers=4, d_model=512, d_ff=1024, vocab_size=2048, dtype="float32")
    if tc.block_pattern == "attn":
        tc = tc.with_(n_heads=8, n_kv_heads=4, head_dim=64)
    params = init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    for name, leaf in flatten_params(params).items():
        fan_in = _fan_in(name, tuple(leaf.shape))
        last = name.rsplit(".", 1)[-1]
        if fan_in is None:
            want = {"x_maa": 0.0, "maa": 0.0, "mu_k": 0.0, "mu_r": 0.0,
                    "decay_bias": -6.0}.get(last, 1.0)
            assert torch.equal(leaf, torch.full_like(leaf, want)), name
            continue
        std = float(leaf.std())
        assert abs(std * math.sqrt(fan_in) - 1.0) < 0.05, (name, std, fan_in)
        assert abs(float(leaf.mean())) < 5 * std / math.sqrt(leaf.numel()), name


def test_init_is_seeded():
    _, tc = configs("rwkv6_1_6b")
    a = flatten_params(init_params(tc, torch.Generator().manual_seed(1), device="cpu"))
    b = flatten_params(init_params(tc, torch.Generator().manual_seed(1), device="cpu"))
    c = flatten_params(init_params(tc, torch.Generator().manual_seed(2), device="cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["layers.tmix.wk"], c["layers.tmix.wk"])
    assert a["layers.tmix.wk"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", SUPPORTED)
def test_flatten_round_trip(arch):
    """Names are the JAX tree's paths in its order; values carried across
    bit for bit; unflatten inverts flatten without copying."""
    jparams = jax_params(arch)
    params = to_port(jparams)
    flat = flatten_params(params)
    assert [(n, tuple(t.shape), dtype_name(t.dtype)) for n, t in flat.items()] == \
        jax_paths(jparams)
    for (name, tensor), leaf in zip(flat.items(), jax.tree.leaves(jparams)):
        assert tensor.view(torch.uint8).numpy().tobytes() == np.asarray(leaf).tobytes(), name
    back = unflatten_params(flat)
    assert flatten_params(back).keys() == flat.keys()
    assert all(flatten_params(back)[n] is flat[n] for n in flat)


def test_flatten_rejects_dotted_keys():
    with pytest.raises(ValueError):
        flatten_params({"a.b": torch.zeros(1)})


# -- layers in f32 ------------------------------------------------------------------


@pytest.mark.parametrize("stats_only", [False, True])
def test_rms_norm(stats_only):
    rng = np.random.default_rng(0)
    x, s = rng.standard_normal((2, 7, 64)) * 3, rng.standard_normal(64)
    a = jax.jit(lambda x, s: JL.rms_norm(x, s, 1e-6, stats_only))(_j(x), _j(s))
    assert _err(a, TL.rms_norm(_t(x), _t(s), 1e-6, stats_only)) < LAYER_TOL


def test_rope_long_positions():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 4, 128))
    pos = rng.integers(0, 10_001, (2, 64)).astype(np.int32)
    pos[0, :3] = (0, 9_999, 10_000)
    a = jax.jit(lambda x, p: JL.rope(x, p, 1e6))(_j(x), pos)
    got = TL.rope(_t(x), torch.from_numpy(pos), 1e6)
    rope_tol = 10_000 * 2.0 ** -23 * 2 * float(np.abs(x).max())
    assert _err(a, got) < rope_tol
    # at small positions the two agree to f32 rounding
    small = np.minimum(pos, 16)
    a = jax.jit(lambda x, p: JL.rope(x, p, 1e6))(_j(x), small)
    assert _err(a, TL.rope(_t(x), torch.from_numpy(small), 1e6)) < LAYER_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_gqa(masked):
    jc, tc = configs("qwen3_8b", dtype="float32")
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 9, 4, 16))
    k, v = rng.standard_normal((2, 11, 2, 16)), rng.standard_normal((2, 11, 2, 16))
    jm = JL.causal_mask(9, 11, offset=2) if masked else None
    tm = TL.causal_mask(9, 11, offset=2) if masked else None
    a = jax.jit(lambda q, k, v: JL._sdpa(q, k, v, jm, jc))(_j(q), _j(k), _j(v))
    assert _err(a, TL._sdpa(_t(q), _t(k), _t(v), tm, tc)) < LAYER_TOL


def _attn_pair(arch="qwen3_8b"):
    jc, tc = configs(arch, dtype="float32")
    jp = JL.init_attention(jc, jax.random.PRNGKey(4))
    return jc, tc, jp, to_port(jp)


@pytest.mark.parametrize("arch", ["qwen3_8b", "yi_6b"])
def test_attention_full(arch):
    jc, tc, jp, tp = _attn_pair(arch)
    x = np.random.default_rng(5).standard_normal((2, 10, jc.d_model))
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    a = jax.jit(lambda p, x: JL.attention_full(p, x, jc, pos))(jp, _j(x))
    assert _err(a, TL.attention_full(tp, _t(x), tc, torch.from_numpy(pos.copy()))) < LAYER_TOL


def test_attention_decode():
    jc, tc, jp, tp = _attn_pair()
    rng = np.random.default_rng(6)
    s, pos = 12, 7
    cache = {n: rng.standard_normal((2, s, jc.n_kv_heads, jc.dhead)) for n in ("k", "v")}
    x = rng.standard_normal((2, 1, jc.d_model))
    a, jcache = jax.jit(lambda p, x, c: JL.attention_decode(p, x, c, jnp.int32(pos), jc))(
        jp, _j(x), {n: _j(c) for n, c in cache.items()})
    tcache = {n: _t(c) for n, c in cache.items()}
    b, tcache = TL.attention_decode(tp, _t(x), tcache, pos, tc)
    assert _err(a, b) < LAYER_TOL
    for n in ("k", "v"):
        assert _err(jcache[n], tcache[n]) < LAYER_TOL


@pytest.mark.parametrize("activation", ["silu", "gelu", "squared_relu"])
def test_mlp_apply(activation):
    jc, tc = configs("yi_6b", dtype="float32")
    jc, tc = jc.with_(activation=activation), tc.with_(activation=activation)
    jp = JL.init_mlp(jc, jax.random.PRNGKey(7))
    x = np.random.default_rng(8).standard_normal((2, 5, jc.d_model))
    a = jax.jit(lambda p, x: JL.mlp_apply(p, x, jc))(jp, _j(x))
    assert _err(a, TL.mlp_apply(to_port(jp), _t(x), tc)) < LAYER_TOL


@pytest.mark.parametrize("t", [16, 13])
@pytest.mark.parametrize("chunk", [1, 16])
def test_rwkv_core_scan(chunk, t):
    """Both of the reference's branches (chunked when T % chunk == 0)."""
    rng = np.random.default_rng(9)
    r, k, v = (rng.standard_normal((2, t, 4, 16)) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (2, t, 4, 16))
    u, s0 = rng.standard_normal((4, 16)), rng.standard_normal((2, 4, 16, 16))
    jy, js = jax.jit(lambda *a: JR._rwkv_core_scan(*a, chunk=chunk))(
        *(_j(a) for a in (r, k, v, w, u, s0)))
    ty, ts = TR._rwkv_core_scan(*(_t(a) for a in (r, k, v, w, u, s0)), chunk=chunk)
    assert _err(jy, ty) < LAYER_TOL
    assert _err(js, ts) < LAYER_TOL


def _rwkv_state(rng, cfg, with_s: bool):
    h, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    st = {"x_prev": rng.standard_normal((2, cfg.d_model))}
    if with_s:
        st["s"] = rng.standard_normal((2, h, hd, hd))
    return st


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("mix", ["tmix", "cmix"])
def test_rwkv6_mix(mix, with_state):
    jc, tc = configs("rwkv6_1_6b", dtype="float32")
    init = JR.init_rwkv6_tmix if mix == "tmix" else JR.init_rwkv6_cmix
    jfn = JR.rwkv6_tmix if mix == "tmix" else JR.rwkv6_cmix
    tfn = TR.rwkv6_tmix if mix == "tmix" else TR.rwkv6_cmix
    jp = init(jc, jax.random.PRNGKey(10))
    # nonzero token-shift mixes so the shift is exercised
    jp = {n: (l + 0.3 if n in ("x_maa", "maa", "mu_k", "mu_r") else l) for n, l in jp.items()}
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 6, jc.d_model))
    st = _rwkv_state(rng, jc, mix == "tmix") if with_state else None
    ja, jst = jax.jit(lambda p, x, s: jfn(p, x, jc, s))(
        jp, _j(x), None if st is None else {n: _j(a) for n, a in st.items()})
    ta, tst = tfn(to_port(jp), _t(x), tc, None if st is None else {n: _t(a) for n, a in st.items()})
    assert _err(ja, ta) < LAYER_TOL
    assert sorted(jst) == sorted(tst)
    for n in jst:
        assert _err(jst[n], tst[n]) < LAYER_TOL


def test_bf16_layers_bit_equal():
    """In bf16 each layer alone rounds where the reference does."""
    jc, tc = configs("qwen3_8b")
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 9, jc.d_model))
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jp = JL.init_attention(jc, jax.random.PRNGKey(13))
    a = jax.jit(lambda p, x: JL.attention_full(p, x, jc, pos))(jp, _j(x, jnp.bfloat16))
    assert _err(a, TL.attention_full(to_port(jp), _t(x, torch.bfloat16), tc,
                                     torch.from_numpy(pos.copy()))) == 0.0
    jm = JL.init_mlp(jc, jax.random.PRNGKey(14))
    a = jax.jit(lambda p, x: JL.mlp_apply(p, x, jc))(jm, _j(x, jnp.bfloat16))
    assert _err(a, TL.mlp_apply(to_port(jm), _t(x, torch.bfloat16), tc)) == 0.0
    a = jax.jit(jax.nn.silu)(_j(x, jnp.bfloat16))
    assert _err(a, TL.silu(_t(x, torch.bfloat16))) == 0.0


# -- the model against the reference ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def model_run(arch: str, dtype: str) -> dict:
    """forward, prefill and DECODE_STEPS decode steps through both
    packages on the same params and tokens; numpy results."""
    jc, tc = configs(arch, dtype=dtype)
    jparams = jax_params(arch, dtype)
    params = to_port(jparams)
    toks = np.random.default_rng(20).integers(0, jc.vocab_size, (B, T)).astype(np.int32)
    fr = frames_for(jc)
    jfr = None if fr is None else jnp.asarray(fr)
    # In bf16 the MoE configs are held to the reference run op by op:
    # jitted, XLA keeps excess precision across fused bf16 ops, the
    # router sees other inputs and a near-tied routing choice flips (the
    # jitted qwen3-moe smoke forward lies 0.94 from its own unfused run,
    # which the port's equals bit for bit).
    unfused = dtype == "bfloat16" and jc.moe is not None
    with jax.disable_jit() if unfused else contextlib.nullcontext():
        out = {"jax": {}, "port": {}}
        jf, jaux = jax.jit(lambda p, t, f: j_forward(p, t, jc, f))(jparams, toks, jfr)
        tf, taux = forward(params, toks, tc, frames=fr, device="cpu")
        out["jax"]["forward"], out["port"]["forward"] = _np(jf), tf.numpy()
        out["jax"]["aux"], out["port"]["aux"] = float(jaux), float(taux)
        jl, jpre = jax.jit(lambda p, t, f: j_prefill(p, t, jc, f))(jparams, toks, jfr)
        tl, tpre = prefill(params, toks, tc, frames=fr, device="cpu")
        out["jax"]["prefill"] = (_np(jl), {n: _np(a) for n, a in _paths(jpre)})
        out["port"]["prefill"] = (tl.numpy(), {n: a.float().numpy()
                                               for n, a in flatten_params(tpre).items()})
        step = jax.jit(lambda p, tk, pos, s: j_decode(p, tk, pos, s, jc))
        jst, tst = j_state(jc, B, T), init_serve_state(tc, B, T, device="cpu")
        if jc.is_encdec:  # decode against the prefill's cross-attention K/V
            jst["cross_kv"], tst["cross_kv"] = jpre["cross_kv"], tpre["cross_kv"]
        jd, td = [], []
        for i in range(DECODE_STEPS):
            a, jst = step(jparams, toks[:, i:i + 1], jnp.int32(i), jst)
            b, tst = decode_step(params, toks[:, i:i + 1], i, tst, tc, device="cpu")
            jd.append(_np(a))
            td.append(b.numpy())
        out["jax"]["decode"] = (np.stack(jd, 1), {n: _np(a) for n, a in _paths(jst)})
        out["port"]["decode"] = (np.stack(td, 1), {n: a.float().numpy()
                                                   for n, a in flatten_params(tst).items()})
    return out


def _paths(tree):
    return [(n, leaf) for (n, _, _), leaf in zip(jax_paths(tree), jax.tree.leaves(tree))]


def _tol(dtype: str) -> float:
    return F32_TOL if dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SUPPORTED)
def test_forward_equal(arch, dtype):
    run = model_run(arch, dtype)
    a, b = run["jax"]["forward"], run["port"]["forward"]
    assert a.shape == b.shape == (B, T, configs(arch)[0].vocab_size)
    assert np.abs(a - b).max() < _tol(dtype)
    # the MoE aux loss: relative, as test_torch_loss.py holds the loss
    rel = 1e-5 if dtype == "float32" else 2e-3
    assert abs(run["jax"]["aux"] - run["port"]["aux"]) <= rel * run["jax"]["aux"]
    assert (run["jax"]["aux"] > 0) == (configs(arch)[0].moe is not None)


@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SUPPORTED)
def test_serve_path_equal(arch, dtype, what):
    """prefill's last logits and every state leaf; DECODE_STEPS decode
    steps' logits and the final state."""
    run = model_run(arch, dtype)
    (jl, jst), (tl, tst) = run["jax"][what], run["port"][what]
    assert jl.shape == tl.shape
    assert np.abs(jl - tl).max() < _tol(dtype)
    assert list(tst) == list(jst)
    for n in jst:
        assert jst[n].shape == tst[n].shape, n
        scale = max(1.0, float(np.abs(jst[n]).max()))
        assert np.abs(jst[n] - tst[n]).max() < _tol(dtype) * scale, n


def test_decode_matches_forward_in_port():
    """The invariant the reference's own suite pins (test_archs.py):
    decode-step logits equal the full forward's, in f32 here (griffin's
    ring past its wrap; whisper against the prefill's cross-attention
    K/V).  MoE is left out: at B = 2 decode drops routed slots the
    forward keeps (``test_torch_moe.py``)."""
    for arch in ("qwen3_8b", "rwkv6_1_6b", "recurrentgemma_9b", "whisper_tiny"):
        run = model_run(arch, "float32")
        assert np.abs(run["port"]["decode"][0] - run["port"]["forward"]).max() < F32_TOL


@pytest.mark.parametrize("pos", [4, 7])
def test_decode_past_the_cache_end(pos):
    """At ``pos`` >= the cache length S the reference's
    ``dynamic_update_slice`` clamps the write to slot S-1 (RoPE stays at
    ``pos``, every slot is valid); the port clamps the same way.  Logits
    and cache within F32_TOL."""
    jc, tc = configs("qwen3_8b", dtype="float32")
    jparams = jax_params("qwen3_8b", "float32")
    rng = np.random.default_rng(30)
    kv = (jc.n_layers, B, 4, jc.n_kv_heads, jc.dhead)
    cache = {n: rng.standard_normal(kv).astype(np.float32) for n in ("k", "v")}
    tok = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
    a, jst = jax.jit(lambda p, s: j_decode(p, tok, jnp.int32(pos), s, jc))(
        jparams, {"layers": {n: jnp.asarray(c) for n, c in cache.items()}})
    b, tst = decode_step(to_port(jparams), tok, pos,
                         {"layers": {n: torch.from_numpy(c.copy()) for n, c in cache.items()}},
                         tc, device="cpu")
    assert np.abs(_np(a) - b.numpy()).max() < F32_TOL
    for n in ("k", "v"):
        assert np.abs(_np(jst["layers"][n]) - tst["layers"][n].numpy()).max() < F32_TOL


# -- what waits, and the device rule ---------------------------------------------------


#: entry points that reach ``self_attention`` over a prompt, where
#: ``attn_impl="blockwise"`` takes ``blockwise_sdpa``.
BLOCKWISE_CALLS = {
    "forward": lambda p, tc, toks, fr: forward(p, toks, tc, frames=fr, device="cpu"),
    "prefill": lambda p, tc, toks, fr: prefill(p, toks, tc, frames=fr, device="cpu"),
    "loss_fn": lambda p, tc, toks, fr: loss_fn(
        p, {"tokens": toks, "labels": toks, "frames": fr}, tc, device="cpu"),
    "generate": lambda p, tc, toks, fr: ServingEngine(tc, p, device="cpu").generate(
        toks, frames=fr),
}


@pytest.mark.parametrize("call", sorted(BLOCKWISE_CALLS))
@pytest.mark.parametrize("arch", ["qwen3_8b", "recurrentgemma_9b", "qwen3_moe_30b_a3b",
                                  "whisper_tiny"])
def test_waiting_paths_raise(arch, call):
    """``attn_impl="blockwise"`` no longer raises: every entry point that
    reaches it runs it, in f32 within F32_TOL of the dense path's results
    (greedy tokens equal)."""
    _, tc = configs(arch)
    tc = tc.with_(dtype="float32", attn_block_q=4, attn_block_kv=4)
    params = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (1, 8)).astype(np.int32)
    fr = frames_for(tc, b=1)
    got = BLOCKWISE_CALLS[call](params, tc.with_(attn_impl="blockwise"), toks, fr)
    want = BLOCKWISE_CALLS[call](params, tc, toks, fr)
    leaves = lambda out: [x for x in jax.tree.leaves(out, is_leaf=torch.is_tensor)
                          if isinstance(x, (torch.Tensor, np.ndarray))]
    for g, w in zip(leaves(got), leaves(want), strict=True):
        if call == "generate":
            assert np.array_equal(np.asarray(g), np.asarray(w))
        else:
            assert float((torch.as_tensor(g) - torch.as_tensor(w)).abs().max()) <= F32_TOL


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, tc = configs("yi_6b")
    params = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    state = init_serve_state(tc, 1, 4, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    calls = [
        lambda: init_params(tc, torch.Generator().manual_seed(0)),
        lambda: forward(params, toks, tc),
        lambda: prefill(params, toks, tc),
        lambda: decode_step(params, toks[:, :1], 0, state, tc),
        lambda: init_serve_state(tc, 1, 4),
        lambda: ServingEngine(tc, params),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_tensor_off_the_device_raises():
    _, tc = configs("yi_6b")
    params = init_params(tc, torch.Generator().manual_seed(0), device="meta")
    with pytest.raises(ValueError, match="not on cpu"):
        forward(params, np.zeros((1, 4), np.int32), tc, device="cpu")
    cpu = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    state = init_serve_state(tc, 1, 4, device="meta")
    with pytest.raises(ValueError, match="not on cpu"):
        decode_step(cpu, np.zeros((1, 1), np.int32), 0, state, tc, device="cpu")
