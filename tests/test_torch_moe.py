"""The port's MoE (``repro_torch.models.layers.moe_route``, ``moe_apply``,
``init_moe``) held against the JAX package's ``moe_apply`` on the CPU.

Params are made by the JAX package and carried across with
``params_from_numpy`` (bit for bit); inputs come from a numpy seed.
Routing is held to a mirror of the reference's own routing lines in jax
(``lax.top_k``, the one-hot cumsum): the same expert ids, the same slots,
the same drops.  Tolerances, on max abs error:

* f32: ``LAYER_TOL`` = 1e-5 on the output, ``AUX_REL`` = 1e-6 relative
  on the aux loss (measured ~3e-7: the f32 router products' summation
  order);
* bf16: the output bit-equal (the layer alone rounds where the
  reference does), the aux loss within ``AUX_REL``.

The smoke configs run at their real ``capacity_factor`` (1.25: tokens
are dropped), at a small one and at a large one (none is); the
padded-expert case is
qwen2-moe's smoke with 6 experts padded to 8, as the full config pads 60
to 64.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as JL

import repro_torch.configs as tconfigs
import repro_torch.models.layers as TL
from repro_torch.checkpoint.manager import dtype_name
from repro_torch.models import flatten_params, params_from_numpy

LAYER_TOL, AUX_REL = 1e-5, 1e-6
ARCHS = ["qwen2_moe_a2_7b", "qwen3_moe_30b_a3b"]


def configs(arch: str, dtype: str = "float32", **moe):
    """(jax cfg, port cfg) of the smoke config, its MoE fields replaced."""
    out = []
    for mod in (jconfigs, tconfigs):
        c = mod.get_config(arch, smoke=True).with_(dtype=dtype)
        out.append(c.with_(moe=dataclasses.replace(c.moe, **moe)))
    return tuple(out)


def padded(arch: str = "qwen2_moe_a2_7b", dtype: str = "float32", **moe):
    return configs(arch, dtype, n_experts=6, pad_experts_to=8, **moe)


def pair(jc, seed: int = 4):
    jp = JL.init_moe(jc, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def inputs(jc, b: int, t: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, t, jc.d_model)).astype(np.float32)


def jax_route(p, x, cfg) -> dict:
    """The reference's routing lines (``repro.models.layers.moe_apply``),
    as numpy."""
    m = cfg.moe
    ep = m.n_experts_padded
    s = x.shape[0] * x.shape[1]
    xt = x.reshape(s, -1)
    logits = (xt.astype(jnp.float32) @ p["router"]).astype(jnp.float32)
    if ep != m.n_experts:
        logits = jnp.where((jnp.arange(ep) >= m.n_experts)[None, :], -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_ids = jax.lax.top_k(probs, m.experts_per_token)
    cap = int(math.ceil(s * m.experts_per_token / m.n_experts * m.capacity_factor))
    one_hot = jax.nn.one_hot(top_ids.reshape(-1), ep, dtype=jnp.int32)
    slot = jnp.sum(jnp.cumsum(one_hot, axis=0) * one_hot - one_hot, axis=1)
    return {"ids": np.asarray(top_ids), "slot": np.asarray(slot),
            "keep": np.asarray(slot < cap), "cap": cap}


def run_both(jc, tc, jp, tp, x, dtype=jnp.float32):
    ja, jaux = jax.jit(lambda p, x: JL.moe_apply(p, x, jc))(jp, jnp.asarray(x, dtype))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    ta, taux = TL.moe_apply(tp, torch.from_numpy(x).to(tdt), tc)
    return (np.asarray(ja, np.float32), float(jaux)), (ta.float().numpy(), float(taux))


def _route_equal(jp, tp, jc, tc, x):
    want = jax_route(jp, jnp.asarray(x), jc)
    got = TL.moe_route(tp, torch.from_numpy(x).reshape(-1, x.shape[-1]), tc)
    np.testing.assert_array_equal(got["ids"].numpy(), want["ids"])
    np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    assert got["cap"] == want["cap"]
    return got


@pytest.mark.parametrize("capacity_factor", [None, 0.5, 8.0])
@pytest.mark.parametrize("arch", ARCHS + ["padded"])
def test_moe_apply_f32(arch, capacity_factor):
    """Out and aux at the real capacity factor (the smoke configs drop
    tokens there; 6 experts padded to 8 have room for all), at a small one
    (drops) and at a large one (no drop), with routing, slots and drops
    equal."""
    kw = {} if capacity_factor is None else {"capacity_factor": capacity_factor}
    jc, tc = padded(**kw) if arch == "padded" else configs(arch, **kw)
    jp, tp = pair(jc)
    x = inputs(jc, 2, 13)
    route = _route_equal(jp, tp, jc, tc, x)
    dropped = int((~route["keep"]).sum())
    assert (dropped > 0) == (capacity_factor == 0.5 or (capacity_factor is None
                                                         and arch != "padded"))
    (ja, jaux), (ta, taux) = run_both(jc, tc, jp, tp, x)
    assert ja.shape == ta.shape == x.shape
    assert np.abs(ja - ta).max() < LAYER_TOL
    assert abs(jaux - taux) <= AUX_REL * jaux and taux > 0


@pytest.mark.parametrize("arch", ARCHS + ["padded"])
def test_moe_apply_bf16_bit_equal(arch):
    jc, tc = padded(dtype="bfloat16") if arch == "padded" else configs(arch, "bfloat16")
    jp, tp = pair(jc)
    (ja, jaux), (ta, taux) = run_both(jc, tc, jp, tp, inputs(jc, 2, 13), jnp.bfloat16)
    assert np.abs(ja - ta).max() == 0.0
    assert abs(jaux - taux) <= AUX_REL * jaux


@pytest.mark.parametrize("arch", ARCHS)
def test_top_k_ties_take_the_lower_expert(arch):
    """With router columns duplicated, several experts tie exactly in
    ``probs``; ``lax.top_k`` takes the lower index first and so must the
    port (``torch.topk`` promises no order on ties)."""
    jc, tc = configs(arch)
    jp, _ = pair(jc)
    router = np.asarray(jp["router"]).copy()
    router[:, 1] = router[:, 5] = router[:, 6] = router[:, 2]
    router[:, 3] = router[:, 0]
    jp = {**jp, "router": jnp.asarray(router)}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = inputs(jc, 2, 13, seed=6)
    got = _route_equal(jp, tp, jc, tc, x)
    ids = got["ids"].numpy()
    probs = got["probs"].numpy()
    tied = [(r, i) for r in range(ids.shape[0]) for i in range(1, ids.shape[1])
            if probs[r, ids[r, i - 1]] == probs[r, ids[r, i]]]
    assert tied, "the duplicated columns made no tie in any token's top k"
    assert all(ids[r, i - 1] < ids[r, i] for r, i in tied)
    (ja, jaux), (ta, taux) = run_both(jc, tc, jp, tp, x)
    assert np.abs(ja - ta).max() < LAYER_TOL


def test_padded_experts_never_win_and_are_carried():
    """Padded experts get probability 0 and no routed slot; their weights
    exist (the checkpoint carries them) at the padded expert count."""
    jc, tc = padded()
    jp, tp = pair(jc)
    assert tuple(tp["wg"].shape) == np.asarray(jp["wg"]).shape == (8, jc.d_model,
                                                                    jc.moe.expert_d_ff)
    assert tuple(tp["router"].shape) == (jc.d_model, 8) and tp["router"].dtype == torch.float32
    r = TL.moe_route(tp, torch.from_numpy(inputs(jc, 4, 16).reshape(-1, jc.d_model)), tc)
    assert (r["probs"][:, 6:] == 0).all()
    assert int(r["ids"].max()) < 6


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_time_capacity_drops_like_the_reference(arch):
    """In decode S = B: at the full configs' capacity factor and B = 4 an
    expert keeps one routed slot (``moe_capacity``), and the smoke config
    at B = 4, T = 1 with a capacity factor of 1 (one slot an expert too:
    8 routed slots over 8 experts) drops exactly the slots the reference
    drops."""
    full_j = jconfigs.get_config(arch)
    full_t = tconfigs.get_config(arch)
    want = int(math.ceil(4 * full_j.moe.experts_per_token / full_j.moe.n_experts
                         * full_j.moe.capacity_factor))
    assert TL.moe_capacity(full_t, 4) == want == 1
    jc, tc = configs(arch, capacity_factor=1.0)
    jp, tp = pair(jc)
    x = inputs(jc, 4, 1, seed=7)
    route = _route_equal(jp, tp, jc, tc, x)
    assert route["cap"] == 1 and int((~route["keep"]).sum()) > 0
    (ja, _), (ta, _) = run_both(jc, tc, jp, tp, x)
    assert np.abs(ja - ta).max() < LAYER_TOL


@pytest.mark.parametrize("arch", ARCHS + ["padded"])
def test_init_moe_layout(arch):
    """Leaf names, shapes and dtypes of ``init_moe`` equal the reference's
    (stacked two layers deep too); dense leaves draw N(0, 1/fan_in)."""
    jc, tc = padded() if arch == "padded" else configs(arch)
    want = jax.eval_shape(lambda: JL.init_moe(jc, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    got = TL.init_moe(tc, gen, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    names = [".".join(k.key for k in path) for path, _ in flat]
    tflat = flatten_params(got)
    assert list(tflat) == names
    for (_, leaf), t in zip(flat, tflat.values()):
        assert tuple(t.shape) == leaf.shape and dtype_name(t.dtype) == jnp.dtype(leaf.dtype).name
    stacked = TL.init_moe(tc, gen, device="meta", stack=(2,))
    assert tuple(stacked["wo"].shape) == (2, *want["wo"].shape)
    fan_in = {"router": jc.d_model, "wg": jc.d_model, "wi": jc.d_model,
              "wo": jc.moe.expert_d_ff}
    for name, n in fan_in.items():
        std = float(got[name].float().std())
        assert abs(std * math.sqrt(n) - 1.0) < 0.1, (name, std)
