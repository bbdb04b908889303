"""The port's Griffin (RecurrentGemma) code held against the JAX package's
on the CPU: the RG-LRU recurrence and its associative scan, the temporal
conv, the recurrent block, ring-buffer local attention in decode, the
model's prefill -> decode continuation past the ring's wrap, and the
param tree with a list in it (``groups.rec``) under ``jax.tree.flatten``'s
leaf order, through a checkpoint written by either package.

Params are made by the JAX package and carried across with
``params_from_numpy`` (bit for bit); inputs come from a numpy seed.
Tolerances:

* the scan alone: ``SCAN_REL`` = 1e-5 of max |h|.  The port runs the
  reference's odd/even ``associative_scan`` tree (O(log T) launches; a
  serial loop would issue O(T)); XLA may fuse a multiply and add of the
  combine into an FMA where torch rounds twice, so the two agree to f32
  rounding (measured ~1e-7 of max), not bit for bit;
* f32 layers: ``LAYER_TOL`` = 1e-5; the model: ``F32_TOL`` = 1e-4 on
  logits and states, as ``test_torch_models.py`` states;
* bf16: the temporal conv and the ring decode alone bit-equal; the
  recurrent block within ``BF16_BLOCK_TOL`` = 0.0625 of max(1, |ref|)
  (measured 0.008-0.016 on outputs up to 1.5-2.7, one or two bf16 ulps:
  the scan's f32 rounding moves a bf16 rounding of h, and XLA keeps excess
  precision across the block's fused bf16 ops; against the reference run
  op by op, 0.002-0.004).
* checkpoints: bit-equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as JL
import repro.models.recurrent as JR
from repro.checkpoint import CheckpointPolicy as JPolicy
from repro.checkpoint import DRexCheckpointer as JCheckpointer
from repro.checkpoint import StorageFabric as JFabric
from repro.models import decode_step as j_decode
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.storage import make_node_set as j_node_set

import repro_torch.configs as tconfigs
import repro_torch.models.layers as TL
import repro_torch.models.recurrent as TR
from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.checkpoint.interop import import_manifest
from repro_torch.models import (
    decode_step,
    flatten_params,
    forward,
    params_from_numpy,
    prefill,
    unflatten_params,
)
from repro_torch.models.model import tree_leaves, tree_map, tree_unflatten
from repro_torch.storage import make_node_set

SCAN_REL, LAYER_TOL, F32_TOL, BF16_BLOCK_TOL = 1e-5, 1e-5, 1e-4, 0.0625
ARCH = "recurrentgemma_9b"


def configs(dtype: str = "float32"):
    return (jconfigs.get_config(ARCH, True).with_(dtype=dtype),
            tconfigs.get_config(ARCH, True).with_(dtype=dtype))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, dtype=np.float32), dtype)


def _err(a, b) -> float:
    return float(np.abs(_np(a) - b.detach().float().numpy()).max())


def port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def block_pair(dtype: str = "float32", seed: int = 1):
    jc, tc = configs(dtype)
    jp = JR.init_rglru_block(jc, jax.random.PRNGKey(seed))
    # a nonzero conv bias, so its add is exercised
    jp = {**jp, "conv_b": (jax.random.normal(jax.random.PRNGKey(seed + 1), jp["conv_b"].shape)
                           * 0.1).astype(jp["conv_b"].dtype)}
    return jc, tc, jp, port(jp)


# -- the recurrence --------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 2, 3, 13, 16, 128])
def test_associative_scan(t):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.2, 1.0, (2, t, 8)).astype(np.float32)
    b = rng.standard_normal((2, t, 8)).astype(np.float32)

    def combine(u, v):
        return u[0] * v[0], u[1] * v[0] + v[1]

    ja, jh = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1))(a, b)
    ta, th = TR._associative_scan([torch.from_numpy(a), torch.from_numpy(b)])
    assert ta.shape == th.shape == (2, t, 8)
    assert _err(ja, ta) <= SCAN_REL * float(np.abs(_np(ja)).max())
    assert _err(jh, th) <= SCAN_REL * float(np.abs(_np(jh)).max())


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("t", [1, 13, 16])
def test_rglru(t, with_h0):
    rng = np.random.default_rng(2 + t)
    a_gate, x = (rng.standard_normal((2, t, 16)) for _ in range(2))
    i_gate = rng.uniform(0, 1, (2, t, 16))
    a_param = rng.standard_normal(16) + 0.7
    h0 = rng.standard_normal((2, 16)) if with_h0 else None
    jh, jlast = jax.jit(lambda *a: JR._rglru(*a))(
        _j(a_gate), _j(i_gate), _j(x), _j(a_param), None if h0 is None else _j(h0))
    th, tlast = TR._rglru(_t(a_gate), _t(i_gate), _t(x), _t(a_param),
                          None if h0 is None else _t(h0))
    scale = float(np.abs(_np(jh)).max())
    assert _err(jh, th) <= SCAN_REL * scale
    assert _err(jlast, tlast) <= SCAN_REL * scale


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``, mirrored as such: within
    an f32 ulp (the two libraries' ``log1p`` round apart at a few
    points), across torch ``softplus``'s switch to ``x`` at 20."""
    x = np.array([-30.0, -3.0, 0.0, 0.7, 19.9, 20.1, 25.0, 60.0], np.float32)
    want = np.asarray(jax.jit(jax.nn.softplus)(x))
    got = TR._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_less(np.abs(got - want), 2.0 ** -23 * np.maximum(np.abs(want), 1e-30)
                                 + 1e-45)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_temporal_conv(with_state, dtype):
    """The depthwise causal conv, its carried state from the last W-1
    inputs; fed in two pieces it equals one pass."""
    jc, tc, jp, tp = block_pair(dtype)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, jc.d_model))
    st = rng.standard_normal((2, jc.conv1d_width - 1, jc.d_model)) if with_state else None
    jo, jst = jax.jit(lambda x, s: JR._temporal_conv(x, jp["conv_w"], jp["conv_b"], s))(
        _j(x, jdt), None if st is None else _j(st, jdt))
    to, tst = TR._temporal_conv(_t(x, tdt), tp["conv_w"], tp["conv_b"],
                                None if st is None else _t(st, tdt))
    tol = LAYER_TOL if dtype == "float32" else 0.0
    assert _err(jo, to) <= tol and _err(jst, tst) <= tol
    a, sa = TR._temporal_conv(_t(x, tdt)[:, :4], tp["conv_w"], tp["conv_b"],
                              None if st is None else _t(st, tdt))
    b, sb = TR._temporal_conv(_t(x, tdt)[:, 4:], tp["conv_w"], tp["conv_b"], sa)
    assert torch.equal(torch.cat([a, b], dim=1), to) and torch.equal(sb, tst)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 13, 16])
def test_rglru_block(t, with_state):
    jc, tc, jp, tp = block_pair()
    rng = np.random.default_rng(4 + t)
    x = rng.standard_normal((2, t, jc.d_model))
    st = None
    if with_state:
        st = {"h": rng.standard_normal((2, jc.d_model)),
              "conv": rng.standard_normal((2, jc.conv1d_width - 1, jc.d_model))}
    jo, jst = jax.jit(lambda p, x, s: JR.rglru_block(p, x, jc, s))(
        jp, _j(x), None if st is None else {n: _j(a) for n, a in st.items()})
    to, tst = TR.rglru_block(tp, _t(x), tc, None if st is None else
                             {n: _t(a) for n, a in st.items()})
    assert _err(jo, to) < LAYER_TOL
    assert sorted(tst) == sorted(jst) == ["conv", "h"]
    assert tst["h"].dtype == torch.float32
    for n in jst:
        assert _err(jst[n], tst[n]) < LAYER_TOL, n


def test_rglru_block_bf16():
    jc, tc, jp, tp = block_pair("bfloat16")
    x = np.random.default_rng(5).standard_normal((2, 13, jc.d_model))
    jo, jst = jax.jit(lambda p, x: JR.rglru_block(p, x, jc))(jp, _j(x, jnp.bfloat16))
    to, tst = TR.rglru_block(tp, _t(x, torch.bfloat16), tc)
    assert to.dtype == torch.bfloat16 and tst["conv"].dtype == torch.bfloat16
    assert _err(jo, to) <= BF16_BLOCK_TOL * max(1.0, float(np.abs(_np(jo)).max()))
    assert _err(jst["conv"], tst["conv"]) == 0.0


# -- ring-buffer local attention ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [3, 7, 8, 13])
def test_ring_attention_decode(pos, dtype):
    """Write at ``pos % S``; slot j valid once ``j <= pos``, every slot
    once ``pos >= S`` (S = 8, the smoke window)."""
    jc, tc = configs(dtype)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    jp = JL.init_attention(jc, jax.random.PRNGKey(6))
    tp = port(jp)
    rng = np.random.default_rng(7 + pos)
    s = jc.attn_window
    cache = {n: rng.standard_normal((2, s, jc.n_kv_heads, jc.dhead)) for n in ("k", "v")}
    x = rng.standard_normal((2, 1, jc.d_model))
    a, jcache = jax.jit(lambda p, x, c: JL.attention_decode(p, x, c, jnp.int32(pos), jc,
                                                            ring=True))(
        jp, _j(x, jdt), {n: _j(c, jdt) for n, c in cache.items()})
    tcache = {n: _t(c, tdt) for n, c in cache.items()}
    b, tcache = TL.attention_decode(tp, _t(x, tdt), tcache, pos, tc, ring=True)
    tol = LAYER_TOL if dtype == "float32" else 0.0
    assert _err(a, b) <= tol
    for n in ("k", "v"):
        assert _err(jcache[n], tcache[n]) <= tol
        # only the ring slot pos % S was written
        changed = (tcache[n] != _t(cache[n], tdt)).any(dim=(0, 2, 3))
        assert changed.nonzero().flatten().tolist() == [pos % s]


# -- the model ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_params():
    jc, _ = configs()
    jp = jax.jit(lambda k: j_init(jc, k))(jax.random.PRNGKey(0))
    return jp, port(jp)


def _state_err(jst, tst) -> float:
    jl = jax.tree.leaves(jst)
    tl = tree_leaves(tst)
    assert len(jl) == len(tl)
    return max(_err(a, b) / max(1.0, float(np.abs(_np(a)).max())) for a, b in zip(jl, tl))


@pytest.mark.parametrize("t", [5, 13])
def test_prefill_then_decode_past_the_wrap(f32_params, t):
    """A prompt shorter (5) and longer (13) than the 8-slot window:
    prefill's ring layout (rolled by t % 8 past the window, zero-padded
    before it), then 10 decode steps through the wrap; logits and every
    state leaf against the reference, and each step's logits against the
    port's own full forward."""
    jc, tc = configs()
    jp, tp = f32_params
    toks = np.random.default_rng(8 + t).integers(0, jc.vocab_size, (2, t + 10)).astype(np.int32)
    jl, jst = jax.jit(lambda p, x: j_prefill(p, x, jc))(jp, toks[:, :t])
    tl, tst = prefill(tp, toks[:, :t], tc, device="cpu")
    assert tuple(tst["groups"]["attn"]["k"].shape) == (1, 2, jc.attn_window, 1, jc.dhead)
    assert _err(jl, tl) < F32_TOL and _state_err(jst, tst) < F32_TOL
    full = forward(tp, toks, tc, device="cpu")[0]
    step = jax.jit(lambda p, tk, pos, s: j_decode(p, tk, pos, s, jc))
    for pos in range(t, t + 10):
        jl, jst = step(jp, toks[:, pos:pos + 1], jnp.int32(pos), jst)
        tl, tst = decode_step(tp, toks[:, pos:pos + 1], pos, tst, tc, device="cpu")
        assert _err(jl, tl) < F32_TOL, pos
        assert float((tl - full[:, pos]).abs().max()) < F32_TOL, pos
    assert _state_err(jst, tst) < F32_TOL


def test_decode_leaves_its_state_alone(f32_params):
    jc, tc = configs()
    _, tp = f32_params
    toks = np.zeros((2, 9), np.int32)
    _, st = prefill(tp, toks, tc, device="cpu")
    before = [x.clone() for x in tree_leaves(st)]
    decode_step(tp, toks[:, :1], 9, st, tc, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(st)))


# -- the param tree with a list --------------------------------------------------------


def test_list_tree_in_jax_order(f32_params):
    """``groups.rec`` is a list: the port names its items by index, in
    ``jax.tree.flatten``'s order; ``unflatten_params`` rebuilds the list
    and the tree helpers walk it in the same order."""
    jp, tp = f32_params
    flat = flatten_params(tp)
    names = list(flat)
    assert "groups.rec.0.rg.wx" in names and "groups.rec.1.rg.wx" in names
    want = [".".join(str(k.idx if isinstance(k, jax.tree_util.SequenceKey) else k.key)
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == want
    assert isinstance(tp["groups"]["rec"], list) and len(tp["groups"]["rec"]) == 2
    back = unflatten_params(flat)
    assert isinstance(back["groups"]["rec"], list)
    assert all(a is b for a, b in zip(tree_leaves(back), flat.values()))
    assert tree_leaves(tp) == list(flat.values())
    doubled = tree_unflatten(tp, [x * 2 for x in tree_leaves(tp)])
    assert isinstance(doubled["groups"]["rec"], list)
    assert torch.equal(doubled["groups"]["rec"][1]["rg"]["wx"],
                       tp["groups"]["rec"][1]["rg"]["wx"] * 2)
    assert isinstance(tree_map(lambda x: x, tp)["groups"]["rec"], list)


def _groups(manifest):
    return [(g["key"], g["k"], g["p"], tuple(g["node_ids"]), g["orig_nbytes"])
            for meta in manifest["leaves"] if meta is not None for g in meta["groups"]]


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """RecurrentGemma's smoke params (bf16), saved at step 2 by the JAX
    package's DRexCheckpointer into a persisted fabric: (the JAX
    checkpointer, its manifest, the params carried into the port under
    ``flatten_params``' names, the fabric's directory)."""
    jc, _ = configs("bfloat16")
    jp = jax.jit(lambda k: j_init(jc, k))(jax.random.PRNGKey(3))
    carried = flatten_params(port(jp))
    assert len(carried) == len(jax.tree.leaves(jp))
    persist = tmp_path_factory.mktemp("griffin_ckpt")
    jck = JCheckpointer(JFabric(j_node_set("most_used", capacity_scale=1e-4),
                                persist_dir=str(persist)), "drex_sc", JPolicy(item_mb=0.25))
    return jck, jck.save(jp, 2), carried, persist


def test_jax_checkpoint_of_griffin_params_restores_in_port(jax_checkpoint):
    """The JAX-written checkpoint restores in the port under
    ``flatten_params``' names (``groups.rec.0.*`` ...) bit-equal, after a
    node holding chunks is lost, and unflattens to the list-bearing tree."""
    _, jman, carried, persist = jax_checkpoint
    names = list(carried)
    tfab = StorageFabric(make_node_set("most_used", capacity_scale=1e-4),
                         persist_dir=str(persist))
    tfab.fail_node(jman["leaves"][0]["groups"][0]["node_ids"][0])
    tck = DRexCheckpointer(tfab, "drex_sc", CheckpointPolicy(item_mb=0.25), device="cpu")
    import_manifest(tck, 2, jman, names=names)
    restored, step = tck.restore_latest()
    assert step == 2 and list(restored) == names
    for name in names:
        assert restored[name].dtype == carried[name].dtype, name
        assert torch.equal(restored[name], carried[name]), name
    assert isinstance(unflatten_params(restored)["groups"]["rec"], list)
    tck.close()


def test_port_save_of_griffin_params_equals_jax(jax_checkpoint):
    """The port's save of the same bytes lays out the same leaves (names,
    shapes, dtypes), groups, placements and chunk bytes."""
    jck, jman, carried, _ = jax_checkpoint
    own = DRexCheckpointer(StorageFabric(make_node_set("most_used", capacity_scale=1e-4)),
                           "drex_sc", CheckpointPolicy(item_mb=0.25), device="cpu")
    tman = own.save(carried, 2)
    assert [m["name"] for m in tman["leaves"]] == list(carried)
    assert [(m["shape"], m["dtype"]) for m in tman["leaves"]] == [
        (list(m["shape"]), str(m["dtype"])) for m in jman["leaves"]]
    assert _groups(tman) == _groups(jman)
    assert own.fabric._blobs == jck.fabric._blobs
    own.close()
