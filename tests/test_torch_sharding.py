"""The port's logical-axis sharding (``repro_torch.models.sharding``) held
against the JAX package's, exactly.

Every spec is resolved on both sides against the same stand-in meshes
(``jax.sharding.AbstractMesh``, which carries only axis names and sizes,
all the reference's ``logical_to_spec`` reads; the port reads the same
two): the 16x16 and 2x16x16 production meshes and the (1, 1), (2, 2) and
(4, 1) local ones.  Checked at full size for all ten configs: every leaf
of ``param_axes``, of the train state (``train_state_shardings``) and of
``serve_state_axes`` over the decode cells' states; ``batch_shardings``;
and ``input_specs``' shapes and dtypes for all 40 cells.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.models import init_params as j_init_params
from repro.models import param_axes as j_param_axes
from repro.models import serve_state_axes as j_serve_state_axes
from repro.models.sharding import logical_to_spec as j_logical_to_spec
from repro.models.sharding import rules_for as j_rules_for
from repro.train.step import batch_shardings as j_batch_shardings

import repro_torch.configs as tconfigs
from repro_torch.models import init_params
from repro_torch.models.model import param_axes, serve_state_axes, tree_leaves
from repro_torch.models.sharding import (
    PartitionSpec,
    is_axes_leaf,
    logical_to_spec,
    placements_for,
    rules_for,
    tree_shardings,
)
from repro_torch.train import batch_shardings, train_state_shardings
from repro_torch.prng import PRNGKey

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
}
ARCHS = jconfigs.ARCH_IDS


def mesh(name: str) -> AbstractMesh:
    return AbstractMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch: str):
    cfg = jconfigs.get_config(arch)
    return jax.eval_shape(lambda: j_init_params(cfg, jax.random.PRNGKey(0)))


def ref_specs(axes_tree, shapes_tree, m) -> list:
    axes = jax.tree.leaves(axes_tree, is_leaf=is_axes_leaf)
    shapes = jax.tree.leaves(shapes_tree)
    assert len(axes) == len(shapes)
    return [tuple(j_logical_to_spec(a, s.shape, m)) for a, s in zip(axes, shapes)]


def port_specs(shardings_tree) -> list:
    return [tuple(s.spec) for s in tree_leaves(shardings_tree)]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh_name):
    m = mesh(mesh_name)
    cfg = tconfigs.get_config(arch)
    shapes = init_params(cfg, PRNGKey(0), device="meta")
    assert [tuple(t.shape) for t in tree_leaves(shapes)] == \
        [tuple(s.shape) for s in jax.tree.leaves(ref_param_shapes(arch))]
    got = port_specs(tree_shardings(param_axes(cfg), shapes, m))
    want = ref_specs(j_param_axes(jconfigs.get_config(arch)), ref_param_shapes(arch), m)
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_equal_reference(arch, mesh_name):
    """params, moments and master laid out as the params; ``opt.step``
    replicated (the reference's ``train_state_shardings``)."""
    m = mesh(mesh_name)
    sh = train_state_shardings(tconfigs.get_config(arch), m)
    want = ref_specs(j_param_axes(jconfigs.get_config(arch)), ref_param_shapes(arch), m)
    for tree in (sh.params, sh.opt.mu, sh.opt.nu, sh.opt.master):
        assert port_specs(tree) == want
    assert tuple(sh.opt.step.spec) == () and sh.comp is None
    with_comp = train_state_shardings(tconfigs.get_config(arch), m, compression=True)
    assert port_specs(with_comp.comp.error) == want


def _decode_cells():
    return [(a, s) for a in ARCHS for s in ("decode_32k", "long_500k")
            if jconfigs.cell_supported(jconfigs.get_config(a), s)[0]]


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x2"])
@pytest.mark.parametrize("arch,shape", _decode_cells())
def test_serve_state_specs_equal_reference(arch, shape, mesh_name):
    m = mesh(mesh_name)
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jstate = jconfigs.input_specs(jcfg, shape)["state"]
    tstate = tconfigs.input_specs(tcfg, shape)["state"]
    got = port_specs(tree_shardings(serve_state_axes(tcfg, tstate), tstate, m))
    want = ref_specs(j_serve_state_axes(jcfg, jstate), jstate, m)
    assert got == want


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen3_8b", "whisper_tiny"])
def test_batch_shardings_equal_reference(arch, mesh_name):
    m = mesh(mesh_name)
    got = {k: tuple(v.spec) for k, v in batch_shardings(tconfigs.get_config(arch), m).items()}
    want = {k: tuple(v.spec) for k, v in
            j_batch_shardings(jconfigs.get_config(arch), m).items()}
    assert got == want


CELLS = [(a, s) for a in ARCHS for s in jconfigs.SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    """Shapes and dtypes of every input of all 40 cells (meta tensors
    against the reference's ShapeDtypeStructs)."""
    want = jax.tree.leaves(jconfigs.input_specs(jconfigs.get_config(arch), shape))
    got = tree_leaves(tconfigs.input_specs(tconfigs.get_config(arch), shape))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(np.dtype(w.dtype))


def test_rules_and_divisibility_fallback():
    """The rule tables are the reference's; a dim the mesh axis does not
    divide falls back to replication (whisper-tiny's 6 heads on 16)."""
    for name in ("16x16", "2x16x16"):
        assert rules_for(mesh(name)) == j_rules_for(mesh(name))
    m = mesh("16x16")
    assert logical_to_spec(("embed", "heads", None), (384, 6, 64), m) == \
        PartitionSpec("data", None, None)
    mp = mesh("2x16x16")
    spec = logical_to_spec(("batch", None), (256, 4096), mp)
    assert spec == PartitionSpec(("pod", "data"), None)
    assert tuple(spec) == tuple(j_logical_to_spec(("batch", None), (256, 4096), mp))


def test_placements_of_a_spec():
    """A dim sharded over mesh axis a is Shard(dim) on a; a dim of size 1
    counts as replicated once the shape is known."""
    from torch.distributed.tensor import Replicate, Shard

    m = mesh("2x16x16")
    assert placements_for(PartitionSpec(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements_for(PartitionSpec(None, "model"), m) == \
        (Replicate(), Replicate(), Shard(1))
    one = mesh("1x1")
    assert placements_for(PartitionSpec("data", "model"), one, (4, 1)) == \
        (Shard(0), Replicate())
