"""The port's training objective (``loss_fn`` and its gradients through
``torch.autograd``) held against ``jax.value_and_grad`` of the JAX
package's on the CPU.

Params are made by the JAX package from ``PRNGKey(0)`` and carried across
with ``params_from_numpy`` (bit for bit); the batch comes from a numpy
seed.  Tolerances:

* f32: the loss within ``LOSS_REL`` = 1e-5 relative; each gradient leaf
  within ``GRAD_REL`` = 1e-4 of its max |g|, the forward's 1e-4 in
  ``test_torch_models.py`` (measured <= 8.2e-6, on RWKV6's
  ``layers.cmix.wv``: only the summation orders of the matmuls differ);
* bf16: the loss within ``BF16_LOSS_REL`` = 2e-3 relative (measured
  3.8e-4), each gradient leaf within ``BF16_GRAD_REL`` = 0.25 of its max
  |g| (measured 0.105 on RWKV6's ``layers.tmix.wr``, 0.02 on attention:
  XLA on the CPU keeps excess precision across fused bf16 ops, and
  random-init RWKV6 amplifies a rounding difference);
* the remat policies against each other: bit-equal.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss

import repro_torch.configs as tconfigs
from repro_torch.models import flatten_params, loss_fn, params_from_numpy
from repro_torch.models.model import _grad_to_bf16, _GradToBf16, tree_leaves, tree_unflatten

LOSS_REL, GRAD_REL = 1e-5, 1e-4
BF16_LOSS_REL, BF16_GRAD_REL = 2e-3, 0.25
ARCHS = ["rwkv6_1_6b", "qwen3_8b", "yi_6b", "recurrentgemma_9b", "qwen2_moe_a2_7b",
         "qwen3_moe_30b_a3b", "whisper_tiny"]


def configs(arch: str, **kw):
    jc, tc = jconfigs.get_config(arch, True), tconfigs.get_config(arch, True)
    return jc.with_(**kw), tc.with_(**kw)


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, dtype: str):
    jc, _ = configs(arch, dtype=dtype)
    return jax.jit(lambda key: j_init(jc, key))(jax.random.PRNGKey(0))


def jc_moe(arch: str) -> bool:
    return configs(arch)[0].moe is not None


def _batch(cfg, b: int = 2, t: int = 12, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        shape = (b, cfg.encoder.n_frames, cfg.d_model)
        batch["frames"] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return batch


def _rel_err(a, b) -> float:
    a = np.asarray(a, np.float32)
    return float(np.abs(a - b.detach().float().numpy()).max()) / max(
        float(np.abs(a).max()), 1e-30)


def port_value_and_grad(params, batch, cfg):
    """(loss, metrics, grads in tree_leaves order) through torch.autograd."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg, device="cpu")
    return loss.detach(), metrics, torch.autograd.grad(loss, leaves)


def both_grads(arch: str, dtype: str, **kw):
    jc, tc = configs(arch, dtype=dtype, **kw)
    jp = jax_params(arch, dtype)
    batch = _batch(jc)
    # bf16 MoE against the reference run op by op: jitted, XLA's excess
    # precision across fused bf16 ops flips near-tied routing choices
    # (test_torch_models.model_run).
    unfused = dtype == "bfloat16" and jc.moe is not None
    with jax.disable_jit() if unfused else contextlib.nullcontext():
        (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_loss(p, batch, jc),
                                                  has_aux=True))(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tl, tm, tg = port_value_and_grad(tp, batch, tc)
    names = list(flatten_params(tp))
    return (jl, jm, jax.tree.leaves(jg)), (tl, tm, tg), names


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_f32(arch):
    (jl, jm, jg), (tl, tm, tg), names = both_grads(arch, "float32")
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(jl) - float(tl)) <= LOSS_REL * abs(float(jl))
    assert abs(float(jm["nll"]) - float(tm["nll"].detach())) <= LOSS_REL * abs(float(jm["nll"]))
    if jc_moe(arch):
        assert abs(float(jm["aux"]) - float(tm["aux"].detach())) <= LOSS_REL * float(jm["aux"])
    else:
        assert float(tm["aux"].detach()) == float(jm["aux"]) == 0.0
    assert len(jg) == len(tg) == len(names)
    for name, a, b in zip(names, jg, tg):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, name
        assert _rel_err(a, b) <= GRAD_REL, (name, _rel_err(a, b))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_bf16(arch):
    (jl, _, jg), (tl, _, tg), names = both_grads(arch, "bfloat16")
    assert abs(float(jl) - float(tl)) <= BF16_LOSS_REL * abs(float(jl))
    for name, a, b in zip(names, jg, tg):
        # bf16 but the f32 leaves (the MoE router, the RG-LRU's a_param)
        assert b.dtype == (torch.float32 if a.dtype == np.float32 else torch.bfloat16), name
        assert _rel_err(a, b) <= BF16_GRAD_REL, (name, _rel_err(a, b))


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "qwen3_8b"])
def test_remat_policies_bit_equal(arch):
    """``remat`` "none", "minimal" and "full" give the same loss and
    gradients, bit for bit."""
    _, tc = configs(arch, dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jax_params(arch, "float32")), device="cpu")
    batch = _batch(tc)
    runs = [port_value_and_grad(tp, batch, tc.with_(remat=r)) for r in ("none", "minimal", "full")]
    for loss, _, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2]))


def test_minimal_remat_saves_only_weight_products():
    """Under "minimal" the backward recomputes no weight product (``mm``);
    under "full" it does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.model import _SAVED_UNDER_MINIMAL

    assert _SAVED_UNDER_MINIMAL == [torch.ops.aten.mm.default]

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    _, tc = configs("qwen3_8b", dtype="float32")
    tp = params_from_numpy(jax.tree.map(np.asarray, jax_params("qwen3_8b", "float32")),
                           device="cpu")
    counts = {}
    for remat in ("none", "minimal", "full"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
        loss, _ = loss_fn(tree_unflatten(tp, leaves), _batch(tc),
                          tc.with_(remat=remat), device="cpu")
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        counts[remat] = c.mm
    # "full" recomputes each layer's weight products (up to the last one
    # the backward needs), "minimal" none of them
    assert counts["minimal"] == counts["none"]
    assert counts["full"] >= counts["none"] + 6 * tc.n_layers


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "qwen3_8b"])
def test_bwd_bf16_matches_reference(arch):
    """``bwd_bf16=True`` (the reference raises on it in f32: its scan
    carries bf16 cotangents into an f32 residual) in bf16."""
    (jl, _, jg), (tl, _, tg), names = both_grads(arch, "bfloat16", bwd_bf16=True)
    assert abs(float(jl) - float(tl)) <= BF16_LOSS_REL * abs(float(jl))
    for name, a, b in zip(names, jg, tg):
        assert _rel_err(a, b) <= BF16_GRAD_REL, (name, _rel_err(a, b))


def test_grad_to_bf16_delivers_bf16_cotangents():
    g = torch.randn(5, generator=torch.Generator().manual_seed(0), dtype=torch.float32) / 3
    assert _GradToBf16.backward(None, g).dtype == torch.bfloat16
    x = torch.zeros(5, requires_grad=True)
    y = _grad_to_bf16(x)
    assert torch.equal(y, x)
    y.backward(g)
    # autograd hands x its own dtype back, holding the bf16-rounded values
    assert torch.equal(x.grad, g.to(torch.bfloat16).float())
    assert not torch.equal(x.grad, g)
