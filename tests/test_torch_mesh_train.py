"""The port's sharded train step (``make_train_step(mesh=...)``),
``reshard_state`` and ``Trainer(mesh=...)`` on the CPU.

* On a one-rank mesh (a gloo group over a ``FileStore``) the step is the
  mesh-less step's bits, state and loss, over 3 steps, for a dense, an
  RWKV6 and a shard_map MoE smoke config, with every state leaf a DTensor.
* In f32 one step from the JAX package's state (carried across bit for
  bit) is held to the JAX package's ``make_train_step(mesh=
  make_local_mesh(1, 1))``: the loss within ``LOSS_REL`` = 1e-5; the
  first moment (the clipped gradient's running mean) within ``GRAD_REL``
  = 1e-4 of each leaf's max; the second within ``MOMENT_REL`` = 1e-3;
  params and master copy within ``MASTER_LR`` = 0.05 x lr element by
  element (``test_torch_train_step.py``'s reasons) wherever the gradient
  is further than ``GRAD_REL`` of its max from zero, and within 2 x lr
  where it is not: a first AdamW step moves each element by ~lr x
  sign(g), and rounding flips the sign of a gradient that close to zero.
* ``reshard_state`` round trips bit for bit, and ``Trainer(mesh=...)``
  resumes bit-exactly after a node loss through a restore and a reshard
  onto a freshly built mesh (``examples/elastic_failover.py`` phase 3 at
  smoke size).

Two ranks: ``test_torch_mesh_ranks.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro.configs as jconfigs
from repro.launch.mesh import make_local_mesh as j_make_local_mesh
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import init_train_state as j_state
from repro.train import make_train_step as j_step

import repro_torch.configs as tconfigs
from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.storage import make_node_set
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    TrainStateCheckpointer,
    init_train_state,
    make_train_step,
    reshard_state,
    train_state_dict,
    train_state_from_numpy,
)
from repro_torch.train.interop import _named
from repro_torch.prng import PRNGKey

LOSS_REL, GRAD_REL, MOMENT_REL, MASTER_LR = 1e-5, 1e-4, 1e-3, 0.05
OPT = dict(lr=5e-3, warmup_steps=3, decay_steps=20)


def start_group(path, rank: int = 0, world: int = 1) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(str(path), world),
                            rank=rank, world_size=world)


@pytest.fixture
def mesh(tmp_path, request):
    start_group(tmp_path / "store")
    request.addfinalizer(dist.destroy_process_group)
    return make_local_mesh(1, 1, device="cpu")


def cfg_of(arch: str, **kw):
    return tconfigs.get_config(arch, True).with_(**kw)


def data(cfg, seed: int = 5):
    return LMDataPipeline(DataConfig(cfg.vocab_size, 16, 4, seed=seed), device="cpu")


def assert_on_mesh(state, mesh) -> None:
    for name, t in _named(state):
        assert isinstance(t, DTensor) and t.device_mesh == mesh, name


def assert_bit_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_1_6b", "qwen3_moe_30b_a3b"])
def test_one_rank_mesh_step_is_the_meshless_step(arch, mesh):
    cfg = cfg_of(arch)
    assert arch != "qwen3_moe_30b_a3b" or cfg.moe_dispatch == "shard_map"
    plain = init_train_state(cfg, PRNGKey(0), device="cpu")
    sharded = init_train_state(cfg, PRNGKey(0), device="cpu")
    f_plain = make_train_step(cfg, AdamWConfig(**OPT))
    f_mesh = make_train_step(cfg, AdamWConfig(**OPT), mesh=mesh)
    d1, d2 = data(cfg), data(cfg)
    for _ in range(3):
        plain, m1 = f_plain(plain, d1.next_batch())
        sharded, m2 = f_mesh(sharded, d2.next_batch())
        assert_on_mesh(sharded, mesh)
        for k in ("loss", "nll", "grad_norm", "lr"):
            assert not isinstance(m2[k], DTensor) and torch.equal(m1[k], m2[k]), k
    assert_bit_equal(train_state_dict(sharded), train_state_dict(plain))


def _np_state(jstate):
    return jax.tree.map(np.array, jstate)


@pytest.mark.parametrize("arch", ["yi_6b", "rwkv6_1_6b"])
def test_f32_step_matches_reference_mesh_step(arch, mesh):
    jc = jconfigs.get_config(arch, True).with_(dtype="float32")
    tc = cfg_of(arch, dtype="float32")
    jstate = j_state(jc, jax.random.PRNGKey(0))
    start = _np_state(jstate)
    jstep = j_step(jc, JAdamWConfig(**OPT), j_make_local_mesh(1, 1))
    tstep = make_train_step(tc, AdamWConfig(**OPT), mesh=mesh)
    from repro.data import DataConfig as JDataConfig
    from repro.data import LMDataPipeline as JPipeline

    jbatch = JPipeline(JDataConfig(jc.vocab_size, 16, 4, seed=5)).next_batch()
    jnew, jm = jstep(jstate, jbatch)
    tnew, tm = tstep(train_state_from_numpy(start, device="cpu"), data(tc).next_batch())
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_REL * abs(float(jm["loss"]))
    want = train_state_dict(train_state_from_numpy(_np_state(jnew), device="cpu"))
    got = train_state_dict(tnew)
    lr = float(jm["lr"])
    for name in want:
        diff = (got[name].float() - want[name].float()).abs()
        if name.startswith("opt.mu."):
            assert float(diff.max()) <= GRAD_REL * float(want[name].abs().max()), name
        elif name.startswith("opt.nu."):
            assert float(diff.max()) <= MOMENT_REL * float(want[name].abs().max()), name
        elif name != "opt.step":
            # AdamW's first update is ~lr * sign(g): an element whose
            # gradient lies within rounding of zero (GRAD_REL of the
            # leaf's max |g|) may move up to 2 lr apart
            leaf = name.removeprefix("params.").removeprefix("opt.master.")
            mu = want["opt.mu." + leaf].abs()
            settled = mu > GRAD_REL * float(mu.max())
            assert float(diff[settled].max()) <= MASTER_LR * lr, (name, "settled")
            assert float(diff.max()) <= 2.0 * lr * (1 + 1e-5), (name, float(diff.max()) / lr)
    assert torch.equal(got["opt.step"], want["opt.step"])


def test_reshard_state_round_trip(mesh):
    cfg = cfg_of("qwen3_8b")
    state = init_train_state(cfg, PRNGKey(0), device="cpu")
    before = {n: t.clone() for n, t in train_state_dict(state).items()}
    on = reshard_state(state, cfg, mesh)
    assert_on_mesh(on, mesh)
    # a one-rank mesh lays the tensors out in place
    assert on.params["embed"].to_local().data_ptr() == state.params["embed"].data_ptr()
    fresh = make_local_mesh(1, 1, device="cpu")
    again = reshard_state(on, cfg, fresh)
    assert_on_mesh(again, fresh)
    assert_bit_equal(train_state_dict(again), before)


def _trainer(cfg, mesh, checkpointer=None, steps=4):
    return Trainer(cfg, AdamWConfig(**OPT),
                   TrainerConfig(steps=steps, log_every=1, ckpt_every=2, seed=3,
                                 async_ckpt=True),
                   data_cfg=DataConfig(cfg.vocab_size, 16, 4, seed=3), mesh=mesh,
                   checkpointer=checkpointer, log_fn=lambda s, m: None, device="cpu")


def _clone(state) -> dict:
    return {n: t.clone() for n, t in train_state_dict(state).items()}


def test_trainer_on_mesh_resumes_after_node_loss_and_reshard(mesh):
    cfg = cfg_of("qwen3_8b")
    straight = _trainer(cfg, mesh)
    final = straight.run()
    assert_on_mesh(final, mesh)
    final = _clone(final)

    fabric = StorageFabric(make_node_set("most_unreliable", capacity_scale=1e-4))
    ck = DRexCheckpointer(fabric, "drex_sc",
                          CheckpointPolicy(item_mb=0.01, reliability_target=0.9999),
                          device="cpu")
    like = init_train_state(cfg, PRNGKey(0), device="meta")
    adapter = TrainStateCheckpointer(ck, like)
    saved = _trainer(cfg, mesh, adapter)
    assert_bit_equal(_clone(saved.run()), final)
    manifest = ck._manifests[4]
    assert [m["name"] for m in manifest["leaves"]] == list(final)
    fabric.fail_node(0)
    fabric.fail_node(2)

    resumed = _trainer(cfg, make_local_mesh(1, 1, device="cpu"), adapter, steps=6)
    state = resumed.init_or_restore()
    assert resumed.start_step == 4 and resumed.data.step == 0
    # As the reference's, the restored pipeline starts at batch 0; steps
    # 5-6 of the uninterrupted run trained on batches 4-5.
    resumed.data.step = resumed.start_step
    assert not any(isinstance(t, DTensor) for t in train_state_dict(state).values())
    assert_bit_equal(_clone(state), final)
    fresh = make_local_mesh(1, 1, device="cpu")
    state = reshard_state(state, cfg, fresh)
    assert_on_mesh(state, fresh)
    out = resumed.run(state)
    assert [h["step"] for h in resumed.history] == [5, 6]

    cont = _trainer(cfg, mesh, steps=6)
    want = cont.run()
    assert_bit_equal(_clone(out), _clone(want))
    for a, b in zip(cont.history[4:], resumed.history):
        assert {k: a[k] for k in ("loss", "grad_norm")} == {k: b[k] for k in ("loss", "grad_norm")}
    ck.close()


def test_launcher_trains_on_a_one_device_mesh(capsys):
    from repro_torch.launch import train as launch_train

    assert not dist.is_initialized()
    launch_train.main(["--arch", "qwen3_8b", "--smoke", "--device", "cpu", "--steps", "2",
                       "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[launch] loss " in out and "over 2 steps" in out
    assert not dist.is_initialized()   # the group it started is ended
