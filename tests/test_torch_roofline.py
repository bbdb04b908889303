"""The port's roofline (``repro_torch.roofline``) held against the JAX
package's: ``model_flops_for`` equal for every config and shape,
``RooflineTerms`` with the reference's formulas and ``to_dict`` keys (only
the H100's constants differ), and matmul FLOPs counted from a run equal
to the reference's jaxpr walker's: a matmul, a scanned loop against the
port's Python loop, gradients, remat recompute, and the dense smoke
configs' forward passes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import repro.configs as jconfigs
import repro.roofline.terms as JT
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.roofline import count_fn_flops as j_count

import repro_torch.configs as tconfigs
import repro_torch.roofline as TR
from repro_torch.models import forward, params_from_numpy
from repro_torch.roofline import count_fn_flops


@pytest.mark.parametrize("shape", sorted(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_model_flops_equal_reference(arch, shape):
    spec = jconfigs.SHAPES[shape]
    want = JT.model_flops_for(jconfigs.get_config(arch), spec.kind, spec.seq_len,
                              spec.global_batch)
    got = TR.model_flops_for(tconfigs.get_config(arch), spec.kind, spec.seq_len,
                             spec.global_batch)
    assert got == want


TERMS = dict(arch="a", shape="s", mesh="single", chips=256, global_flops=3.1e18,
             per_device_hbm_bytes=2.2e11, per_device_collective_bytes=7.5e9,
             collective_breakdown={"all-gather": 5e9, "all-reduce": 2.5e9},
             model_flops=2.6e18, hlo_dot_flops_per_device=1.1e16,
             per_device_hbm_bytes_raw=3.3e11)


def test_roofline_terms_formulas_and_keys():
    """The reference's expressions over the port's constants (H100 SXM:
    989e12 bf16 FLOP/s, 3.35e12 B/s HBM3, 50e9 B/s InfiniBand NDR)."""
    got, want = TR.RooflineTerms(**TERMS), JT.RooflineTerms(**TERMS)
    assert list(got.to_dict()) == list(want.to_dict())
    assert (TR.PEAK_FLOPS_BF16, TR.HBM_BW, TR.IB_NDR_BW) == (989e12, 3.35e12, 50e9)
    assert got.compute_s * TR.PEAK_FLOPS_BF16 == pytest.approx(want.compute_s * JT.PEAK_FLOPS_BF16)
    assert got.memory_s * TR.HBM_BW == pytest.approx(want.memory_s * JT.HBM_BW)
    assert got.collective_s * TR.IB_NDR_BW == pytest.approx(want.collective_s * JT.ICI_BW)
    assert got.useful_flops_ratio == want.useful_flops_ratio
    d = got.to_dict()
    assert d["memory_s_raw"] == TERMS["per_device_hbm_bytes_raw"] / TR.HBM_BW
    assert got.step_time_s == max(got.compute_s, got.memory_s, got.collective_s)
    terms = {"compute": got.compute_s, "memory": got.memory_s, "collective": got.collective_s}
    assert got.bottleneck == max(terms, key=terms.get)
    assert got.roofline_fraction == pytest.approx(
        TERMS["model_flops"] / got.step_time_s / (256 * TR.PEAK_FLOPS_BF16))


def _j(shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.float32)


def _t(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_matmul_flops():
    want = j_count(lambda a, b: a @ b, _j((64, 32)), _j((32, 16)))
    got = count_fn_flops(lambda a, b: a @ b, _t((64, 32)), _t((32, 16)))
    assert got.dot_flops == want.dot_flops == 2 * 64 * 32 * 16


def test_loop_counts_as_scan_and_unrolled():
    n = 5

    def body(x, w):
        return jnp.tanh(x @ w)

    def scanned(x, ws):
        return jax.lax.scan(lambda c, w: (body(c, w), None), x, ws)[0]

    def unrolled(x, ws):
        for i in range(n):
            x = body(x, ws[i])
        return x

    def port(x, ws):
        for i in range(n):
            x = torch.tanh(x @ ws[i])
        return x

    x, ws = (8, 16), (n, 16, 16)
    s, u = j_count(scanned, _j(x), _j(ws)), j_count(unrolled, _j(x), _j(ws))
    got = count_fn_flops(port, _t(x), _t(ws))
    assert got.dot_flops == s.dot_flops == u.dot_flops == n * 2 * 8 * 16 * 16


def _mlp_j(x, w1, w2):
    return jnp.sum(jnp.tanh(x @ w1) @ w2)


def _mlp_t(x, w1, w2):
    return torch.sum(torch.tanh(x @ w1) @ w2)


def _shapes():
    return (4, 8), (8, 16), (16, 2)


def test_gradient_flops_match_and_exceed_forward():
    js = [_j(s, i) for i, s in enumerate(_shapes())]
    fwd = j_count(_mlp_j, *js)
    want = j_count(jax.grad(_mlp_j, argnums=(1, 2)), *js)

    def port_grad(x, w1, w2):
        w1, w2 = w1.requires_grad_(), w2.requires_grad_()
        return torch.autograd.grad(_mlp_t(x, w1, w2), (w1, w2))

    got = count_fn_flops(port_grad, *[_t(s, i) for i, s in enumerate(_shapes())])
    assert got.dot_flops == want.dot_flops
    assert got.dot_flops > fwd.dot_flops


def test_remat_recompute_is_counted():
    js = [_j(s, i) for i, s in enumerate(_shapes())]
    plain = j_count(jax.grad(_mlp_j, argnums=(1, 2)), *js)
    want = j_count(jax.grad(jax.checkpoint(_mlp_j), argnums=(1, 2)), *js)

    def port_grad(x, w1, w2):
        w1, w2 = w1.requires_grad_(), w2.requires_grad_()
        y = checkpoint(_mlp_t, x, w1, w2, use_reentrant=False)
        return torch.autograd.grad(y, (w1, w2))

    got = count_fn_flops(port_grad, *[_t(s, i) for i, s in enumerate(_shapes())])
    assert got.dot_flops == want.dot_flops > plain.dot_flops


@pytest.mark.parametrize("arch", ["qwen3_8b", "yi_6b", "nemotron_4_15b", "nemotron_4_340b",
                                  "chameleon_34b"])
def test_dense_smoke_forward_flops_equal_reference(arch):
    jc = jconfigs.get_config(arch, True)
    tc = tconfigs.get_config(arch, True)
    jparams = j_init(jc, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    want = j_count(lambda p, t: j_forward(p, t, jc)[0], jparams, jnp.asarray(toks))
    got = count_fn_flops(lambda: forward(params, toks, tc, device="cpu"))
    assert got.dot_flops == want.dot_flops
    assert got.elementwise_flops > 0
