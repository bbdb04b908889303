"""The port's sharded train step on two ranks (spawned processes, a gloo
group over a ``FileStore``), ``data = 2`` and ``model = 2``: each rank's
local shard shapes are what the JAX package's specs imply, and after 2
f32 steps the loss is within ``LOSS_REL`` = 1e-5 and the params within
``MASTER_LR`` = 0.05 x lr of the one-rank step's (the ranks add partial
gradients in another order; ``test_torch_train_step.py`` gives the lr
bound's reasons)."""

from __future__ import annotations

import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.models import init_params as j_init_params
from repro.models import param_axes as j_param_axes
from repro.models.sharding import logical_to_spec as j_logical_to_spec

import repro_torch.configs as tconfigs
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import flatten_params, init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state, make_train_step, train_state_dict
from repro_torch.train.interop import _named

LOSS_REL, MASTER_LR = 1e-5, 0.05
OPT = dict(lr=5e-3, warmup_steps=3, decay_steps=20)


def start_group(path, rank: int, world: int) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(str(path), world),
                            rank=rank, world_size=world)


def cfg_of(arch: str, **kw):
    return tconfigs.get_config(arch, True).with_(**kw)


def data(cfg, seed: int = 5):
    return LMDataPipeline(DataConfig(cfg.vocab_size, 16, 4, seed=seed), device="cpu")


# -- two ranks ------------------------------------------------------------------------------

TWO_RANK_ARCH = "yi_6b"
TWO_RANK_LEAVES = ("embed", "layers.attn.wq", "layers.attn.wo", "layers.mlp.wi", "lm_head")


def _two_rank_worker(rank: int, store: str, out: str, shape) -> None:
    start_group(store, rank, 2)
    try:
        cfg = cfg_of(TWO_RANK_ARCH, dtype="float32")
        m = make_local_mesh(*shape, device="cpu")
        state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        step = make_train_step(cfg, AdamWConfig(**OPT), mesh=m)
        d = data(cfg)
        losses = []
        for _ in range(2):
            state, metrics = step(state, d.next_batch())
            losses.append(float(metrics["loss"]))
        named = dict(_named(state))
        local = {n: tuple(named[f"params.{n}"].to_local().shape) for n in TWO_RANK_LEAVES}
        full = train_state_dict(state)
        if rank == 0:
            torch.save({"losses": losses, "local": local,
                        "params": {n: t for n, t in full.items() if n.startswith("params.")},
                        "lr": float(metrics["lr"])}, out)
    finally:
        dist.destroy_process_group()


def _implied_local_shapes(shape) -> dict:
    jc = jconfigs.get_config(TWO_RANK_ARCH, True)
    am = AbstractMesh(shape, ("data", "model"))
    shapes = jax.eval_shape(lambda: j_init_params(jc, jax.random.PRNGKey(0)))
    axes = j_param_axes(jc)
    out = {}
    for name in TWO_RANK_LEAVES:
        node_s, node_a = shapes, axes
        for part in name.split("."):
            node_s, node_a = node_s[part], node_a[part]
        spec = j_logical_to_spec(node_a, node_s.shape, am)
        local = list(node_s.shape)
        for dim, entry in enumerate(spec):
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                local[dim] //= am.shape[a]
        out[name] = tuple(local)
    return out


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["data2", "model2"])
def test_two_ranks_match_one_rank(shape, tmp_path):
    out = tmp_path / "out.pt"
    torch.multiprocessing.spawn(_two_rank_worker,
                                args=(str(tmp_path / "store"), str(out), shape),
                                nprocs=2, join=True)
    res = torch.load(out)
    assert res["local"] == _implied_local_shapes(shape)
    assert math.prod(shape) == 2 and any(
        res["local"][n] != tuple(s) for n, s in _full_shapes().items())

    cfg = cfg_of(TWO_RANK_ARCH, dtype="float32")
    state = init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, AdamWConfig(**OPT))
    d = data(cfg)
    for want in res["losses"]:
        state, metrics = step(state, d.next_batch())
        assert abs(float(metrics["loss"]) - want) <= LOSS_REL * abs(want)
    one = train_state_dict(state)
    for name, t in res["params"].items():
        assert float((t - one[name]).abs().max()) <= MASTER_LR * res["lr"], name


def _full_shapes() -> dict:
    cfg = cfg_of(TWO_RANK_ARCH)
    flat = flatten_params(init_params(cfg, torch.Generator(), device="meta"))
    return {n: tuple(flat[n].shape) for n in TWO_RANK_LEAVES}
