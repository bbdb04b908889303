"""The port's dry run (``repro_torch.launch.dryrun``) on torch's fake
process group, on the CPU.

One smoke cell of each kind (train, prefill, decode) traces on a fake
(2, 2) and (16, 16) mesh under ``FakeTensorMode``; rank 0's argument
bytes equal what the JAX package's specs imply for its local shards; the
collectives of a sharded train step are counted by type.  ``long_500k``
on a full-attention config is skipped with the reference's reason, and a
full-size cell writes the reference's record.  Every test that starts the
fake group ends it.
"""

from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import AbstractMesh

import repro.configs as jconfigs
from repro.models import init_params as j_init
from repro.models import init_serve_state as j_serve_state
from repro.models import param_axes as j_param_axes
from repro.models import serve_state_axes as j_serve_axes
from repro.models.sharding import logical_to_spec as j_spec

import repro_torch.configs as tconfigs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.roofline import RooflineTerms


@pytest.fixture
def fake_group(request):
    def start(world: int):
        dryrun.start_fake_group(world)
        return make_mesh((int(math.isqrt(world)),) * 2, ("data", "model"), device="cpu")

    request.addfinalizer(lambda: dist.is_initialized() and dist.destroy_process_group())
    return start


def _leaf_axes(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x))


def _local_bytes(axes_leaves, shape_leaves, mesh, itemsize=None) -> int:
    total = 0
    for ax, sd in zip(axes_leaves, shape_leaves):
        spec = j_spec(ax, sd.shape, mesh)
        n = math.prod(sd.shape)
        for entry in spec:
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                n //= mesh.shape[a]
        total += n * (itemsize or np.dtype(sd.dtype).itemsize)
    return total


def implied_arg_bytes(arch: str, spec: ShapeSpec, shape) -> int:
    """Rank 0's argument bytes from the reference's specs and shapes."""
    cfg = jconfigs.get_config(arch, True)
    m = AbstractMesh(shape, ("data", "model"))
    p_shapes = jax.tree.leaves(jax.eval_shape(lambda: j_init(cfg, jax.random.PRNGKey(0))))
    p_axes = _leaf_axes(j_param_axes(cfg))
    total = _local_bytes(p_axes, p_shapes, m)
    b, t = spec.global_batch, spec.seq_len
    tok = jax.ShapeDtypeStruct((b, t), np.int32)
    if spec.kind == "train":
        total += 3 * _local_bytes(p_axes, p_shapes, m, itemsize=4) + 4   # mu, nu, master, step
        total += 2 * _local_bytes([("batch", None)], [tok], m)
    elif spec.kind == "prefill":
        total += _local_bytes([("batch", None)], [tok], m)
    else:
        cache = t if not cfg.sub_quadratic else (cfg.attn_window or 2048)
        state = jax.eval_shape(lambda: j_serve_state(cfg, b, cache))
        total += _local_bytes(_leaf_axes(j_serve_axes(cfg, state)), jax.tree.leaves(state), m)
        total += _local_bytes([("batch", None)], [jax.ShapeDtypeStruct((b, 1), np.int32)], m)
    return total


@pytest.mark.parametrize("world", [4, 256], ids=["2x2", "16x16"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_smoke_cell_traces_on_fake_mesh(kind, world, fake_group):
    mesh = fake_group(world)
    side = mesh.size(0)
    spec = ShapeSpec("smoke", 32, 2 * side, kind)
    cfg = tconfigs.get_config("yi_6b", True)
    stats, flops, args_bytes = dryrun.trace_cell(cfg, spec, mesh)
    assert args_bytes == implied_arg_bytes("yi_6b", spec, (side, side))
    assert flops.dot_flops > 0 and stats["memory_bytes"] > 0
    assert stats["peak_bytes"] >= args_bytes
    if kind == "train":
        # FSDP gathers params, reduce-scatters gradients, all-reduces sums
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(stats["collective_bytes"])
        assert stats["n_collectives"] > 0


def test_moe_train_cell_traces_the_shard_map_dispatch(fake_group):
    mesh = fake_group(4)
    cfg = tconfigs.get_config("qwen3_moe_30b_a3b", True)
    assert cfg.moe_dispatch == "shard_map"
    spec = ShapeSpec("smoke", 16, 4, "train")
    stats, _, args_bytes = dryrun.trace_cell(cfg, spec, mesh)
    assert args_bytes == implied_arg_bytes("qwen3_moe_30b_a3b", spec, (2, 2))
    assert stats["collective_bytes"]["all-reduce"] > 0


def test_long_500k_full_attention_skips_with_reference_reason(tmp_path):
    rec = dryrun.run_cell("qwen3-8b", "long_500k", "single", tmp_path)
    ok, why = jconfigs.cell_supported(jconfigs.get_config("qwen3_8b"), "long_500k")
    assert not ok
    assert rec["status"] == "skipped" and rec["reason"] == why
    assert not dist.is_initialized()


def test_full_cell_writes_the_reference_record(tmp_path, fake_group):
    rec = dryrun.run_cell("whisper-tiny", "decode_32k", "single", tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256
    on_disk = json.loads((tmp_path / "whisper_tiny__decode_32k__single.json").read_text())
    assert on_disk["roofline"].keys() == RooflineTerms(
        "a", "s", "m", 1, 1.0, 1.0, 1.0, {}, 1.0).to_dict().keys()
    assert set(on_disk) >= {"status", "chips", "roofline", "flops", "n_collective_ops",
                            "memory_analysis", "trace_s"}
    assert on_disk["memory_analysis"]["argument_size_in_bytes"] > 0
    assert on_disk["roofline"]["global_flops"] > on_disk["roofline"]["model_flops"] > 0
