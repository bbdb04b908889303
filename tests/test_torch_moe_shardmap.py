"""The port's shard_map MoE dispatch (``repro_torch.models.moe_shardmap``)
against the port's scatter path and the JAX package's shard_map path.

The four cases of the reference's ``tests/test_moe_shardmap.py`` hold bit
for bit on a one-rank mesh (a gloo group over a ``FileStore``), with the
params laid out as DTensors: the forward, the gradients, no mesh falling
back to the scatter path, and padded experts with shard_map.  As there,
the capacity factor is 8, so that the per-shard queues (over the padded
expert count) and the scatter path's (over the real one) drop nothing.
In f32 the port's shard_map path is held to the reference's jitted one
within ``F32_TOL`` = 1e-4 (the models' f32 tolerance).  Two ranks with
``model = 2`` sum each token's expert outputs in two partial sums and an
all-reduce, another order than one rank's: within ``TWO_RANK_TOL`` = 1e-5
of the one-rank logits' max, in f32.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as jconfigs
from repro.launch.mesh import make_mesh_compat
from repro.models import forward as j_forward
from repro.models import init_params as j_init
from repro.models.sharding import activate_mesh as j_activate_mesh

import repro_torch.configs as tconfigs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import forward, init_params, params_from_numpy
from repro_torch.models.model import param_axes, tree_leaves, tree_unflatten
from repro_torch.models.sharding import activate_mesh, tree_shardings
from repro_torch.train.step import full_tensor, lay_out

F32_TOL = 1e-4
TWO_RANK_TOL = 1e-5


def start_group(path, rank: int = 0, world: int = 1) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(str(path), world),
                            rank=rank, world_size=world)


@pytest.fixture
def mesh(tmp_path, request):
    start_group(tmp_path / "store")
    request.addfinalizer(dist.destroy_process_group)
    return make_local_mesh(1, 1, device="cpu")


def generous(cfg):
    return cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def on_mesh(params, cfg, mesh):
    sh = tree_shardings(param_axes(cfg), params, mesh)
    return tree_unflatten(params, [lay_out(p, s) for p, s in
                                   zip(tree_leaves(params), tree_leaves(sh))])


def setup(arch="qwen3_moe_30b_a3b", **moe):
    cfg = generous(tconfigs.get_config(arch, True))
    if moe:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **moe))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return cfg, params, toks


def test_forward_bit_exact(mesh):
    cfg, params, toks = setup()
    ref, _ = forward(params, toks, cfg.with_(moe_dispatch="scatter"), device="cpu")
    with activate_mesh(mesh):
        got, _ = forward(on_mesh(params, cfg, mesh), toks,
                         cfg.with_(moe_dispatch="shard_map"), device="cpu")
    assert torch.equal(ref, full_tensor(got))


def _grads(params, toks, cfg):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    out = forward(tree_unflatten(params, leaves), toks, cfg, device="cpu")[0]
    return torch.autograd.grad(full_tensor((out ** 2).mean()), leaves)


def test_gradients_bit_exact(mesh):
    cfg, params, toks = setup()
    g_ref = _grads(params, toks, cfg.with_(moe_dispatch="scatter"))
    with activate_mesh(mesh):
        g_sm = _grads(on_mesh(params, cfg, mesh), toks, cfg.with_(moe_dispatch="shard_map"))
    assert len(g_ref) == len(g_sm)
    for a, b in zip(g_ref, g_sm):
        assert torch.equal(a, full_tensor(b))


def test_falls_back_without_mesh():
    """No active mesh -> scatter path (CPU tests, eager use)."""
    cfg, params, toks = setup()
    ref, _ = forward(params, toks, cfg.with_(moe_dispatch="scatter"), device="cpu")
    got, _ = forward(params, toks, cfg.with_(moe_dispatch="shard_map"), device="cpu")
    assert torch.equal(ref, got)


def test_padded_experts_with_shardmap(mesh):
    """qwen2-moe config: padding + shard_map together."""
    cfg, params, toks = setup("qwen2_moe_a2_7b", pad_experts_to=12)
    toks = toks[:, :8]
    ref, _ = forward(params, toks, cfg.with_(moe_dispatch="scatter"), device="cpu")
    with activate_mesh(mesh):
        got, _ = forward(on_mesh(params, cfg, mesh), toks,
                         cfg.with_(moe_dispatch="shard_map"), device="cpu")
    assert torch.equal(ref, full_tensor(got))


def test_f32_matches_reference_shardmap(mesh):
    """The port's shard_map path against the JAX package's, both under a
    one-device mesh, in f32."""
    jc = generous(jconfigs.get_config("qwen3_moe_30b_a3b", True)).with_(dtype="float32")
    tc = generous(tconfigs.get_config("qwen3_moe_30b_a3b", True)).with_(dtype="float32")
    jparams = j_init(jc, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    jmesh = make_mesh_compat((1, 1), ("data", "model"))
    with j_activate_mesh(jmesh), jmesh:
        want = np.asarray(jax.jit(lambda p, t: j_forward(p, t, jc)[0])(jparams, toks))
    with activate_mesh(mesh):
        got = full_tensor(forward(on_mesh(params, tc, mesh), toks, tc, device="cpu")[0])
    assert np.abs(got.numpy() - want).max() <= F32_TOL


def _two_rank_worker(rank: int, store: str, out: str) -> None:
    start_group(store, rank, 2)
    try:
        cfg, params, toks = setup()
        cfg = cfg.with_(dtype="float32", moe_dispatch="shard_map")
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        m = make_local_mesh(1, 2, device="cpu")
        dparams = on_mesh(params, cfg, m)
        local = dparams["layers"]["moe"]["wg"].to_local().shape
        with activate_mesh(m):
            got = full_tensor(forward(dparams, toks, cfg, device="cpu")[0])
        if rank == 0:
            torch.save({"logits": got, "wg_local": tuple(local)}, out)
    finally:
        dist.destroy_process_group()


def test_two_ranks_model_axis(tmp_path):
    """model = 2: each rank holds half the experts; the logits within
    TWO_RANK_TOL of one rank's."""
    out = tmp_path / "out.pt"
    torch.multiprocessing.spawn(_two_rank_worker, args=(str(tmp_path / "store"), str(out)),
                                nprocs=2, join=True)
    res = torch.load(out)
    cfg, _, toks = setup()
    cfg = cfg.with_(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want, _ = forward(params, toks, cfg.with_(moe_dispatch="scatter"), device="cpu")
    n_layers, ep, d, f = params["layers"]["moe"]["wg"].shape
    assert res["wg_local"] == (n_layers, ep // 2, d, f)
    err = (res["logits"] - want).abs().max() / want.abs().max()
    assert err <= TWO_RANK_TOL
