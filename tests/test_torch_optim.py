"""The port's optimizers (``repro_torch.optim``) held against the JAX
package's on the CPU.

Inputs come from a numpy seed and go through both packages.  Tolerances:

* AdamW: ``ADAMW_REL`` = 1e-6 of each leaf's max |value| on ``master``,
  ``mu``, ``nu`` and params over 20 steps (the same f32 operations in the
  same order; ``b**t`` and the norm's sums may differ by an ulp between
  XLA and torch);
* the schedule and the clipped grads: ``ADAMW_REL`` relative;
* EF-int8 compression: bit-equal over 10 steps (the same f32 ops, and a
  ``max`` is exact in any order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import param_axes as j_param_axes
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_init
from repro.optim import adamw_update as j_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import compress_decompress as j_compress
from repro.optim import compression_init as j_comp_init
from repro.optim.adamw import _schedule as j_schedule
from repro.optim.adamw import opt_state_axes as j_opt_state_axes

import repro_torch.configs as tconfigs
from repro_torch.models.interop import params_from_numpy
from repro_torch.models.model import param_axes
from repro_torch.optim import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_decompress,
    compression_init,
)
from repro_torch.optim.adamw import _schedule, opt_state_axes

ADAMW_REL = 1e-6


def _tree(rng, scale=1.0) -> dict:
    """A nested tree with f32 and bf16 leaves (numpy)."""
    return {
        "b": (rng.standard_normal((7,)) * scale).astype(np.float32),
        "layers": {
            "w": (rng.standard_normal((3, 16, 8)) * scale).astype(ml_dtypes.bfloat16),
            "norm": (rng.standard_normal((3, 8)) * scale).astype(np.float32),
        },
        "embed": (rng.standard_normal((32, 8)) * scale).astype(ml_dtypes.bfloat16),
    }


def _port(tree) -> dict:
    return params_from_numpy(tree, device="cpu")


def _leaves_np(tree) -> list[np.ndarray]:
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _leaves_t(tree) -> list[np.ndarray]:
    from repro_torch.models.model import tree_leaves

    return [x.float().numpy() for x in tree_leaves(tree)]


def _rel_close(a_list, b_list, rel):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        assert a.shape == b.shape
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= rel * scale, (float(np.abs(a - b).max()), scale)


# -- AdamW against the reference ------------------------------------------------------


@pytest.mark.parametrize("decay_steps", [10_000, 0, 8])
def test_adamw_update_matches_reference(decay_steps):
    """20 steps on a random tree of f32 and bf16 leaves, warmup and
    (short) decay included: master, mu, nu and params."""
    rng = np.random.default_rng(0)
    params0 = _tree(rng)
    kw = dict(lr=1e-2, warmup_steps=4, decay_steps=decay_steps, grad_clip=0.5)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params0)
    jst = j_init(jp)
    tp = _port(params0)
    tst = adamw_init(tp)
    step = jax.jit(lambda g, s, p: j_update(jcfg, g, s, p))
    for i in range(20):
        grads = _tree(rng, scale=0.3 * (i + 1))
        jp, jst, jm = step(jax.tree.map(jnp.asarray, grads), jst, jp)
        tp, tst, tm = adamw_update(tcfg, _port(grads), tst, tp)
        assert abs(float(jm["grad_norm"]) - float(tm["grad_norm"])) <= ADAMW_REL * float(
            jm["grad_norm"])
        assert abs(float(jm["lr"]) - float(tm["lr"])) <= ADAMW_REL * float(jm["lr"])
    assert int(tst.step) == int(jst.step) == 20
    assert tst.step.dtype == torch.int32 and tst.step.shape == ()
    for field in ("master", "mu", "nu"):
        _rel_close(_leaves_np(getattr(jst, field)), _leaves_t(getattr(tst, field)), ADAMW_REL)
    _rel_close(_leaves_np(jp), _leaves_t(tp), ADAMW_REL)
    from repro_torch.models.model import tree_leaves

    # tree order: b, embed, layers.norm, layers.w
    assert [x.dtype for x in tree_leaves(tp)] == [torch.float32, torch.bfloat16,
                                                  torch.float32, torch.bfloat16]


def test_adamw_updates_in_place():
    """The step consumes its state: the returned state holds the given
    tensors (the counterpart of the reference's donated state)."""
    rng = np.random.default_rng(1)
    tp = _port(_tree(rng))
    st = adamw_init(tp)
    ids = [id(t) for t in (st.mu["b"], st.nu["b"], st.master["b"], tp["b"])]
    before = tp["b"].clone()
    tp2, st2, _ = adamw_update(AdamWConfig(), _port(_tree(rng)), st, tp)
    assert [id(t) for t in (st2.mu["b"], st2.nu["b"], st2.master["b"], tp2["b"])] == ids
    assert not torch.equal(tp2["b"], before)
    assert int(st.step) == 0 and int(st2.step) == 1


def test_adamw_init_distinct_buffers():
    tp = _port(_tree(np.random.default_rng(2)))
    st = adamw_init(tp)
    assert isinstance(st, OptState)
    ptrs = [t.data_ptr() for tree in (st.mu, st.nu, st.master)
            for t in jax.tree.leaves(tree)]
    assert len(set(ptrs)) == len(ptrs)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(st.master))
    assert torch.equal(st.master["layers"]["w"], tp["layers"]["w"].float())


@pytest.mark.parametrize("warmup,decay", [(10, 100), (10, 0), (1, 50), (5, 5)])
def test_schedule_matches_reference(warmup, decay):
    """Step 0, the last warmup step, mid-decay and past ``decay_steps``."""
    kw = dict(lr=3e-3, warmup_steps=warmup, decay_steps=decay)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    for s in (0, warmup - 1, warmup, max(decay, 1) // 2, decay, decay + 7, 3 * decay + 11):
        a = float(j_schedule(jcfg, jnp.int32(s)))
        b = _schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert b.dtype == torch.float32
        assert abs(a - float(b)) <= ADAMW_REL * a, (s, a, float(b))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(np.random.default_rng(3), scale=2.0)
    jc, jn = j_clip(jax.tree.map(jnp.asarray, tree), max_norm)
    tc, tn = clip_by_global_norm(_port(tree), max_norm)
    assert abs(float(jn) - float(tn)) <= ADAMW_REL * float(jn)
    _rel_close(_leaves_np(jc), _leaves_t(tc), ADAMW_REL)
    assert all(x.dtype == torch.float32 for x in jax.tree.leaves(tc))


# -- EF-int8 compression -----------------------------------------------------------------


def test_compress_decompress_bit_equal():
    """10 steps of error feedback: grads and residuals bit-equal."""
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    jst, tst = j_comp_init(jax.tree.map(jnp.asarray, tree)), compression_init(_port(tree))
    fn = jax.jit(j_compress)
    for i in range(10):
        g = _tree(rng, scale=10.0 ** (i % 4 - 2))
        jg, jst = fn(jax.tree.map(jnp.asarray, g), jst)
        tg, tst = compress_decompress(_port(g), tst)
        for a, b in zip(_leaves_np(jg), _leaves_t(tg)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(_leaves_np(jst.error), _leaves_t(tst.error)):
            np.testing.assert_array_equal(a, b)


def test_quantize_rounds_half_to_even():
    from repro.optim.compression import _quantize as j_quantize
    from repro_torch.optim.compression import _quantize

    # x / scale lands on .5 exactly for these values (amax 127 -> scale 1)
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 126.5], np.float32)
    jq, js = j_quantize(jnp.asarray(x))
    tq, ts = _quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    assert float(js) == float(ts)


# -- the reference suite's TestAdamW and TestCompression, on the port -------------------


class TestAdamW:
    def test_descends_quadratic(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, decay_steps=0)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = adamw_init(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}  # d/dw w^2
            params, state, _ = adamw_update(cfg, grads, state, params)
        assert float(params["w"].abs().max()) < 0.1

    def test_master_weights_stay_f32(self):
        cfg = AdamWConfig()
        params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
        state = adamw_init(params)
        grads = {"w": torch.ones((4,), dtype=torch.bfloat16)}
        params, state, _ = adamw_update(cfg, grads, state, params)
        assert state.master["w"].dtype == torch.float32
        assert params["w"].dtype == torch.bfloat16

    def test_clip_by_global_norm(self):
        g = {"a": torch.full((4,), 10.0)}
        clipped, gn = clip_by_global_norm(g, 1.0)
        assert float(gn) == pytest.approx(20.0)
        norm = float(torch.sqrt(torch.sum(torch.square(clipped["a"]))))
        assert norm == pytest.approx(1.0, rel=1e-5)

    def test_warmup_schedule(self):
        cfg = AdamWConfig(lr=1e-3, warmup_steps=10, decay_steps=0)
        assert float(_schedule(cfg, torch.tensor(0, dtype=torch.int32))) == pytest.approx(1e-4)
        assert float(_schedule(cfg, torch.tensor(9, dtype=torch.int32))) == pytest.approx(1e-3)


class TestCompression:
    def test_error_feedback_converges(self):
        """EF-int8 compressed descent still converges on a quadratic."""
        w = torch.tensor([4.0])
        comp = compression_init({"w": w})
        for _ in range(300):
            g = {"w": 2 * w}
            gq, comp = compress_decompress(g, comp)
            w = w - 0.05 * gq["w"]
        assert abs(float(w[0])) < 0.05

    def test_quantization_bounded_error(self):
        rng = np.random.default_rng(0)
        g = {"x": torch.from_numpy(rng.normal(size=1000).astype(np.float32))}
        comp = compression_init(g)
        gq, _ = compress_decompress(g, comp)
        amax = float(g["x"].abs().max())
        err = float((gq["x"] - g["x"]).abs().max())
        assert err <= amax / 127.0 + 1e-6


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_opt_state_axes_match_reference(arch):
    """The moments and the master copy mirror the param axes; the step has
    none.  Held on all ten configs' full-size ``param_axes``."""
    got = opt_state_axes(param_axes(tconfigs.get_config(arch)))
    want = j_opt_state_axes(j_param_axes(jconfigs.get_config(arch)))
    assert got.step == want.step == ()
    for field in ("mu", "nu", "master"):
        assert getattr(got, field) == getattr(want, field), field
