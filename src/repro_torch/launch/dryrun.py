"""Multi-pod dry run of the port: trace each (architecture x input-shape)
cell's step on the 16x16 or 2x16x16 production mesh, on no card.

The port of ``repro.launch.dryrun``, with the same CLI:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch

For each cell it starts torch's fake process group
(``torch.testing._internal.distributed.fake_pg``, 256 or 512 ranks, this
process rank 0), builds the production mesh on it and runs the train,
prefill or decode step once under ``FakeTensorMode`` with DTensor state
and inputs laid out as the reference's shardings say: nothing is
allocated and nothing is communicated.  Torch has no counterpart of XLA's
compile, so nothing is compiled; what the record holds comes from the
trace:

* ``memory_analysis``: ``argument_size_in_bytes``, one rank's arguments,
  exact from its local shard shapes; ``peak_memory_in_bytes``, the peak
  of live tensor bytes on that rank during the step;
* ``roofline``: global FLOPs from :func:`repro_torch.roofline.count_fn_flops`
  over the same step without a mesh (global shapes); per-device bytes
  as the unfused sum of what each of rank 0's ops reads and writes (there
  is no fusion-idealized count: eager torch fuses nothing); collective
  bytes by type from the collectives DTensor issues on rank 0;
* ``flops``: that count's dot and elementwise parts; ``n_collective_ops``;
  ``trace_s``, the seconds the cell took.

A decode step is traced at position ``cache_len - 1`` (the port's
decode takes a host position).  The port's WKV loop is a Python loop, so
an RWKV6 ``train_4k`` trace runs its 4,096 steps, each layer, three times
(forward, remat, backward).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPES, ARCH_IDS, cell_supported, get_config, input_specs, normalize
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.model import param_axes, serve_state_axes, tree_leaves, tree_map
from repro_torch.models.sharding import (
    NamedSharding,
    activate_mesh,
    logical_to_spec,
    placements_for,
    tree_shardings,
)
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.roofline import RooflineTerms, TraceStats, count_fn_flops, model_flops_for
from repro_torch.train import TrainState, make_train_step, train_state_shardings
from repro_torch.train.step import batch_shardings

__all__ = ["lower_cell", "main", "run_cell", "start_fake_group", "trace_cell"]

FAKE_PG = "torch.testing._internal.distributed.fake_pg"


def start_fake_group(world_size: int) -> None:
    """(Re)start the default process group as torch's fake one of
    ``world_size`` ranks, this process rank 0."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:      # pragma: no cover - depends on the torch build
        raise RuntimeError(f"the dry run needs torch's fake process group ({FAKE_PG}), "
                           f"which this torch ({torch.__version__}) lacks") from e
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _apply_overrides(cfg, overrides):
    if not overrides:
        return cfg
    kw = {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        kw[k] = v
    return cfg.with_(**kw)


def _local_shape(shape, placements, mesh) -> list[int]:
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return out


def _fake_dtensor(like: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A fake (storage-less) DTensor of ``like``'s global shape and dtype,
    laid out as ``sharding`` says: each rank's shard is exact."""
    mesh = sharding.mesh
    placements = placements_for(sharding.spec, mesh, like.shape)
    local = torch.empty(_local_shape(like.shape, placements, mesh), dtype=like.dtype,
                        device=mesh.device_type)
    stride = torch.empty(like.shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=like.shape, stride=stride)


def _fake(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, device="cpu")


def _train_args(cfg, mesh, specs, sharded: bool):
    shapes = init_params(cfg, torch.Generator(), device="meta")
    opt = adamw_init(shapes)
    state = TrainState(shapes, opt, None)
    if not sharded:
        st = TrainState(tree_map(_fake, state.params),
                        type(opt)(*(tree_map(_fake, t) for t in opt)), None)
        return st, {k: _fake(v) for k, v in specs["batch"].items()}
    sh = train_state_shardings(cfg, mesh)
    params = tree_map(_fake_dtensor, state.params, sh.params)
    opt = type(opt)(*(tree_map(_fake_dtensor, a, b) for a, b in zip(opt, sh.opt)))
    b_sh = batch_shardings(cfg, mesh)
    batch = {k: _fake_dtensor(v, b_sh[k]) for k, v in specs["batch"].items()}
    return TrainState(params, opt, None), batch


def _cell_program(cfg, spec, specs, mesh, sharded: bool):
    """(the step as a thunk, its arguments' leaves) for one cell, with
    DTensor arguments when ``sharded``, plain fake ones otherwise."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    if spec.kind == "train":
        state, batch = _train_args(cfg, mesh, specs, sharded)
        step = make_train_step(cfg, AdamWConfig(), mesh if sharded else None)
        return (lambda: step(state, batch)), tree_leaves(state.params) + [
            *tree_leaves(list(state.opt)), *batch.values()]
    pshapes = init_params(cfg, torch.Generator(), device="meta")
    if sharded:
        params = tree_map(_fake_dtensor, pshapes, tree_shardings(param_axes(cfg), pshapes, mesh))
    else:
        params = tree_map(_fake, pshapes)
    if spec.kind == "prefill":
        def inp(name, logical):
            if not sharded:
                return _fake(specs[name])
            return _fake_dtensor(specs[name], NamedSharding(
                mesh, logical_to_spec(logical, specs[name].shape, mesh)))
        tokens = inp("tokens", ("batch", None))
        frames = inp("frames", ("batch", None, None)) if cfg.is_encdec else None
        del dp
        return (lambda: prefill(params, tokens, cfg, frames, device="cpu")), \
            tree_leaves(params) + [tokens] + ([frames] if frames is not None else [])
    state_shapes = specs["state"]
    if sharded:
        st_sh = tree_shardings(serve_state_axes(cfg, state_shapes), state_shapes, mesh)
        state = tree_map(_fake_dtensor, state_shapes, st_sh)
        # divisibility-aware: long_500k's global_batch=1 cannot shard over
        # the data axes and falls back to replication.
        token = _fake_dtensor(specs["token"], NamedSharding(
            mesh, logical_to_spec(("batch", None), specs["token"].shape, mesh)))
    else:
        state = tree_map(_fake, state_shapes)
        token = _fake(specs["token"])
    pos = _cache_len(cfg, spec) - 1
    return (lambda: decode_step(params, token, pos, state, cfg, device="cpu")), \
        tree_leaves(params) + tree_leaves(state) + [token]


def _cache_len(cfg, spec) -> int:
    return spec.seq_len if not cfg.sub_quadratic else (cfg.attn_window or 2048)


def _local_bytes(leaves) -> int:
    total = 0
    for t in leaves:
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def trace_cell(cfg, spec, mesh):
    """Trace ``cfg``'s step for the cell ``spec`` (a ``ShapeSpec``) on
    ``mesh``; returns (rank 0's TraceStats summary, the global FlopCount,
    rank 0's argument bytes)."""
    specs = input_specs(cfg, spec)
    grad = contextlib.nullcontext() if spec.kind == "train" else torch.no_grad()
    with FakeTensorMode(), grad:
        run, leaves = _cell_program(cfg, spec, specs, mesh, sharded=True)
        args_bytes = _local_bytes(leaves)
        with activate_mesh(mesh), TraceStats(resident=args_bytes) as stats:
            run()
        del run, leaves
        plain, _ = _cell_program(cfg, spec, specs, mesh, sharded=False)
        flops = count_fn_flops(plain)
    return stats.summary(), flops, args_bytes


def lower_cell(arch: str, shape: str, mesh, mesh_name: str, overrides=()):
    """Trace one cell of the grid; returns (cfg, rank 0's TraceStats
    summary, the global FlopCount, rank 0's argument bytes)."""
    spec = SHAPES[shape]
    cfg = get_config(arch).with_(max_cache_len=spec.seq_len)
    cfg = _apply_overrides(cfg, overrides)
    return (cfg, *trace_cell(cfg, spec, mesh))


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: pathlib.Path, overrides=(),
             suffix: str = "") -> dict:
    arch = normalize(arch)
    cfg0 = get_config(arch)
    ok, why = cell_supported(cfg0, shape)
    rec: dict = {"arch": arch, "shape": shape, "mesh": mesh_name,
                 "overrides": list(overrides), "variant": suffix or "baseline"}
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec
    multi = mesh_name == "multi"
    start_fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    chips = mesh.size()
    t0 = time.time()
    try:
        cfg, stats, flops, args_bytes = lower_cell(arch, shape, mesh, mesh_name, overrides)
    except Exception as e:
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
        return rec
    t_trace = time.time() - t0
    mem_d = {"argument_size_in_bytes": args_bytes,
             "peak_memory_in_bytes": int(stats["peak_bytes"])}
    print(f"[dryrun] {arch} x {shape} x {mesh_name}: memory_analysis={mem_d}")
    spec = SHAPES[shape]
    terms = RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        global_flops=flops.total,
        per_device_hbm_bytes=stats["memory_bytes"],
        per_device_collective_bytes=float(sum(stats["collective_bytes"].values())),
        per_device_hbm_bytes_raw=stats["memory_bytes"],
        collective_breakdown={k: v for k, v in stats["collective_bytes"].items() if v},
        model_flops=model_flops_for(cfg, spec.kind, spec.seq_len, spec.global_batch),
        hlo_dot_flops_per_device=stats["dot_flops"],
    )
    rec.update(
        {
            "status": "ok",
            "trace_s": t_trace,
            "chips": chips,
            "memory_analysis": mem_d,
            "per_device_hbm_bytes_is": "unfused: every op's reads and writes (eager "
                                       "torch fuses nothing; no fusion-idealized count)",
            "flops": {"dot": flops.dot_flops, "elementwise": flops.elementwise_flops},
            "roofline": terms.to_dict(),
            "n_collective_ops": stats["n_collectives"],
        }
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{arch}__{shape}__{mesh_name}{suffix}.json").write_text(json.dumps(rec, indent=2))
    print(
        f"[dryrun] OK {arch} x {shape} x {mesh_name}: trace={t_trace:.1f}s "
        f"compute={terms.compute_s*1e3:.2f}ms memory={terms.memory_s*1e3:.2f}ms "
        f"collective={terms.collective_s*1e3:.2f}ms bottleneck={terms.bottleneck} "
        f"roofline_frac={terms.roofline_fraction:.3f}",
        flush=True,
    )
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (repeatable)")
    ap.add_argument("--suffix", default="", help="output filename suffix for variants")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch in ARCH_IDS:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells.append((normalize(args.arch), args.shape))

    summary = []
    try:
        for arch, shape in cells:
            for mesh_name in meshes:
                if args.skip_existing and (
                    out_dir / f"{normalize(arch)}__{shape}__{mesh_name}.json"
                ).exists():
                    print(f"[dryrun] skip existing {arch} x {shape} x {mesh_name}")
                    continue
                rec = run_cell(arch, shape, mesh_name, out_dir, tuple(args.overrides),
                               args.suffix)
                summary.append((arch, shape, mesh_name, rec.get("status"),
                                rec.get("reason") or rec.get("error", "")))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print("\n=== dry-run summary ===")
    for row in summary:
        print(" ", " | ".join(str(x) for x in row))
    bad = [r for r in summary if r[3] == "error"]
    if bad:
        raise SystemExit(f"{len(bad)} cells failed")


if __name__ == "__main__":
    main()
