"""The port's train step (``repro_torch.train.make_train_step``) held
against the JAX package's ``make_train_step(..., mesh=None)`` on the CPU.

Train states are made by the JAX package and carried across with
``train_state_from_numpy`` (bit for bit); batches come from the data
pipelines, which are bit-equal.  Each of 12 f32 steps starts from the
reference's state, carried across before the step: a free trajectory
compounds rounding (random-init RWKV6's f32 smoke model drifts ~3% in 12
steps at lr 1e-2), where one step from one state shows what the step
computes.  Tolerances:

* ``loss``, ``nll``, ``grad_norm`` and ``lr`` within ``STEP_REL`` = 2e-4
  relative (measured <= 7.2e-5, RWKV6 at step 12);
* the moments within ``MOMENT_REL`` = 1e-3 of each leaf's max (measured
  <= 6.4e-5);
* params and master copy within ``MASTER_LR`` = 0.05 x lr of the
  reference's, element by element: AdamW normalizes each update, so an
  element whose gradient lies within rounding of zero moves by up to ~lr
  either way (measured <= 0.009 x lr);
* with EF-int8 compression, see
  ``test_train_step_with_compression_matches_reference``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import LMDataPipeline as JPipeline
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import init_train_state as j_state
from repro.train import make_train_step as j_step

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.models import flatten_params, loss_fn
from repro_torch.models.model import tree_leaves, tree_unflatten
from repro_torch.optim import AdamWConfig
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    init_train_state,
    make_train_step,
    train_state_dict,
    train_state_from_numpy,
)

STEP_REL, MOMENT_REL, MASTER_LR = 2e-4, 1e-3, 0.05


def configs(arch: str, **kw):
    jc, tc = jconfigs.get_config(arch, True), tconfigs.get_config(arch, True)
    return jc.with_(**kw), tc.with_(**kw)


def _np_state(jstate):
    """The JAX TrainState's leaves as host copies (before a donating step)."""
    return jax.tree.map(np.array, jstate)


def port_grads(params, batch, cfg):
    """loss_fn's gradients in tree_leaves order, through torch.autograd."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves), batch, cfg, device="cpu")
    return torch.autograd.grad(loss, leaves)


def _carried_steps(arch: str, compression: bool, steps: int = 12):
    """``steps`` train steps in f32 through both packages, each from the
    reference's state (carried across before every step) on the same
    batch.  Yields (the state the step started from as numpy, the batch,
    the reference's metrics and new state dict, the port's)."""
    jc, tc = configs(arch, dtype="float32")
    kw = dict(lr=5e-3, warmup_steps=3, decay_steps=20)
    jstate = j_state(jc, jax.random.PRNGKey(0), compression)
    jstep = j_step(jc, JAdamWConfig(**kw), None, compression)
    tstep = make_train_step(tc, AdamWConfig(**kw), None, compression)
    dkw = dict(vocab_size=jc.vocab_size, seq_len=16, global_batch=2, seed=5)
    jdata, tdata = JPipeline(JDataConfig(**dkw)), LMDataPipeline(DataConfig(**dkw), device="cpu")
    for _ in range(steps):
        start = _np_state(jstate)
        jbatch, tbatch = jdata.next_batch(), tdata.next_batch()
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(train_state_from_numpy(start, device="cpu"), tbatch)
        want = train_state_dict(train_state_from_numpy(_np_state(jstate), device="cpu"))
        yield start, tbatch, jm, want, tm, train_state_dict(tstate)


def _assert_metrics(jm, tm):
    for k in ("loss", "nll", "grad_norm", "lr"):
        assert tm[k].dtype == torch.float32 and tm[k].shape == (), k
        assert abs(float(jm[k]) - float(tm[k])) <= STEP_REL * abs(float(jm[k])), k


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "qwen3_8b", "yi_6b"])
def test_train_step_matches_reference(arch):
    """12 steps in f32: loss, nll, grad_norm and lr within STEP_REL; the
    moments within MOMENT_REL of each leaf's max; params and master copy
    within MASTER_LR x lr of the reference's, element by element."""
    for _, _, jm, want, tm, got in _carried_steps(arch, False):
        _assert_metrics(jm, tm)
        assert list(got) == list(want)
        assert torch.equal(got["opt.step"], want["opt.step"])
        lr = float(jm["lr"])
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            err = float((got[name].float() - want[name].float()).abs().max())
            if name.startswith(("opt.mu.", "opt.nu.")):
                assert err <= MOMENT_REL * float(want[name].abs().max()), name
            elif name != "opt.step":
                assert err <= MASTER_LR * lr, (name, err / lr)


@pytest.mark.parametrize("arch", ["qwen3_8b", "yi_6b"])
def test_train_step_with_compression_matches_reference(arch):
    """12 steps in f32 with EF-int8 compression: the metrics within
    STEP_REL, and each residual within one quantization step (amax / 127
    of the leaf's compensated gradient) of the reference's, with at most
    0.1% of the elements a step apart.  A gradient ~1e-5 away from the
    reference's flips the int8 rounding of an element lying that close to
    a tie, which moves its residual by one step and its update by up to
    ~lr; so the other leaves are held by the parts' own tests (gradients
    in test_torch_loss.py, compression bit-equal and AdamW within 1e-6 in
    test_torch_optim.py).  Measured: 4 (Qwen3) and 8 (Yi) of ~1.28
    million residual elements a step apart over the 12 steps, none more
    than 0.99997 of a step; the metrics within 1.9e-6."""
    _, tc = configs(arch, dtype="float32")
    flipped = total = 0
    for start, batch, jm, want, tm, got in _carried_steps(arch, True):
        _assert_metrics(jm, tm)
        params = train_state_from_numpy(start, device="cpu").params
        prev = flatten_params(start.comp.error)
        for g, name in zip(port_grads(params, batch, tc), prev):
            g32 = g + torch.from_numpy(np.asarray(prev[name]))
            step = (float(g32.abs().max()) + 1e-12) / 127.0
            d = (got[f"comp.error.{name}"] - want[f"comp.error.{name}"]).abs()
            assert float(d.max()) <= 1.001 * step, name
            flipped += int((d > 0.5 * step).sum())
            total += d.numel()
    assert flipped <= 1e-3 * total, (flipped, total)


def test_train_step_consumes_state():
    _, tc = configs("yi_6b")
    state = init_train_state(tc, torch.Generator().manual_seed(0), device="cpu")
    w = state.params["embed"]
    before = w.clone()
    data = LMDataPipeline(DataConfig(tc.vocab_size, 8, 2), device="cpu")
    new, _ = make_train_step(tc, AdamWConfig())(state, data.next_batch())
    assert new.params["embed"] is w and not torch.equal(w, before)
    assert new.opt.mu["embed"] is state.opt.mu["embed"]
    assert not any(t.requires_grad for t in train_state_dict(new).values())


def test_mesh_waits_for_queue_item_4():
    """The sharded step is ported (``test_torch_mesh_train.py``); a mesh
    that is not a ``DeviceMesh`` is refused by the step and the trainer."""
    _, tc = configs("yi_6b")
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(tc, AdamWConfig(), mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(tc, AdamWConfig(), TrainerConfig(), mesh=object(), device="cpu")
