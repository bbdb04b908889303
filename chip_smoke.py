"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.

1. **Build** the CUDA kernel (``nvcc`` for ``sm_90a``, at first use) and
   print the card's name and power limit.
2. **Kernel against its plain version** on the card: byte-equal over a
   grid of unaligned widths and (K, R) up to 16; then a small checkpoint
   saved on the card must give the same fabric bytes as the port's CPU
   path, which the tests hold equal to the JAX package.
3. **The main path at real size**: the 24 bf16 parameter leaves of
   RWKV6-1.6B (3.20 GB, filled from ``--seed`` on the card) are saved
   through D-Rex SC on the ``most_used`` node set with the default
   checkpoint policy; the node holding row 0 of the first group fails;
   the state is restored and checked bit-exact; ``repair`` runs and the
   state is restored and checked again.  The kernel's launch count is
   set to 0 just before and read just after.
4. **Timing** of the kernel and its plain version, with CUDA events, at
   every shape the main path launched.

Every phase raises on failure.  The last line is the device record; the
line before it lists the kernels.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import json
import pathlib
import resource
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate and int8 tensor-core peak (NVIDIA data
#: sheet, dense), the rates the bound below is taken against.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

#: RWKV6-1.6B parameter leaves in the JAX package's layout
#: (``repro.models.model.init_params(get_config("rwkv6_1_6b"))`` under
#: ``jax.eval_shape``), all bf16: 1,599,719,424 params, 3.20 GB.
RWKV6_1_6B = [
    ("embed", (65536, 2048)),
    ("final_norm", (2048,)),
    ("layers.cmix.mu_k", (24, 2048)),
    ("layers.cmix.mu_r", (24, 2048)),
    ("layers.cmix.wk", (24, 2048, 7168)),
    ("layers.cmix.wr", (24, 2048, 2048)),
    ("layers.cmix.wv", (24, 7168, 2048)),
    ("layers.norm1", (24, 2048)),
    ("layers.norm2", (24, 2048)),
    ("layers.tmix.bonus_u", (24, 32, 64)),
    ("layers.tmix.decay_bias", (24, 2048)),
    ("layers.tmix.ln_scale", (24, 2048)),
    ("layers.tmix.maa", (24, 5, 2048)),
    ("layers.tmix.td_w1", (24, 2048, 64)),
    ("layers.tmix.td_w2", (24, 64, 2048)),
    ("layers.tmix.tm_w1", (24, 2048, 160)),
    ("layers.tmix.tm_w2", (24, 5, 32, 2048)),
    ("layers.tmix.wg", (24, 2048, 2048)),
    ("layers.tmix.wk", (24, 2048, 2048)),
    ("layers.tmix.wo", (24, 2048, 2048)),
    ("layers.tmix.wr", (24, 2048, 2048)),
    ("layers.tmix.wv", (24, 2048, 2048)),
    ("layers.tmix.x_maa", (24, 2048)),
    ("lm_head", (2048, 65536)),
]
#: what the run leaves out of a training checkpoint, for its time limit.
CUTS = ["optimizer moments (AdamW m, v) left out: parameters only"]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(r: int, k: int, b: int) -> tuple[float, str]:
    """Least time for one launch: each input byte read once and each
    output byte written once over HBM, or the mod-2 product's 2*8R*8K*B
    operations at the int8 tensor-core peak, whichever is larger."""
    t_bytes = ((k + r) * b + 64 * r * k) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (8 * r) * (8 * k) * b / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> str:
    from repro_torch.kernels import rs_bitmatmul

    t0 = time.perf_counter()
    lib = rs_bitmatmul.build(verbose=True)
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    return smi


def phase_kernel_grid(seed: int) -> None:
    import numpy as np

    from repro_torch.ec import gf256
    from repro_torch.kernels import ref, rs_bitmatmul

    rng = np.random.default_rng(seed)
    cases = [(r, k, b) for r in (1, 2, 3, 5, 8, 16) for k in (1, 3, 7, 16)
             for b in (1, 15, 2048, 2049, 65_537)]
    cases += [(1, 3, 22_369_622 * 2), (3, 3, 22_369_622)]
    for r, k, b in cases:
        m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        bm = torch.from_numpy(gf256.gf_to_bitmatrix(m)).cuda()
        d = torch.randint(0, 256, (k, b), dtype=torch.uint8, device="cuda")
        got = rs_bitmatmul.gf_bitmatmul(bm, d)
        want = ref.bitmatmul_ref(bm, d)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version at R={r} K={k} B={b}")
    # an unaligned row start takes the byte-wise path
    d = torch.randint(0, 256, (3 * 4096 + 1,), dtype=torch.uint8, device="cuda")[1:]
    d = d.view(3, 4096)
    bm = torch.from_numpy(gf256.gf_to_bitmatrix(gf256.cauchy_matrix(2, 3))).cuda()
    if not torch.equal(rs_bitmatmul.gf_bitmatmul(bm, d), ref.bitmatmul_ref(bm, d)):
        raise AssertionError("kernel != plain version on an unaligned row start")
    log(f"[kernel] byte-equal to the plain version on {len(cases) + 1} shapes")


def phase_small_checkpoint(seed: int) -> None:
    """A small state through the checkpointer on the card and on the CPU:
    the fabric bytes must be identical, and a restore after a data-row
    loss bit-exact."""
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.storage import make_node_set

    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = {
        "w": torch.randn((512, 700), generator=gen, device="cuda").to(torch.bfloat16),
        "b": torch.randn((3001,), generator=gen, device="cuda"),
        "n": torch.arange(12345, dtype=torch.int32, device="cuda"),
    }
    cks = {}
    for dev in ("cuda", "cpu"):
        fabric = StorageFabric(make_node_set("most_used", capacity_scale=1e-5))
        ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(item_mb=0.25), device=dev)
        ck.save(state, 1)
        cks[dev] = ck
    if cks["cuda"].fabric._blobs != cks["cpu"].fabric._blobs:
        raise AssertionError("card and CPU paths stored different chunk bytes")
    ck = cks["cuda"]
    ck.fabric.fail_node(ck._manifests[1]["leaves"][0]["groups"][0]["node_ids"][0])
    got = ck.restore(1, state)
    for name, t in state.items():
        if not torch.equal(got[name], t):
            raise AssertionError(f"small restore differs at {name}")
    for c in cks.values():
        c.close()
    log("[small] card == CPU chunk bytes; restore after a data-row loss bit-exact")


def phase_main(seed: int) -> dict:
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.core import shapes
    from repro_torch.kernels import ops, rs_bitmatmul
    from repro_torch.storage import make_node_set

    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = {
        name: torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        for name, shape in RWKV6_1_6B
    }
    n_params = sum(t.numel() for t in state.values())
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    torch.cuda.synchronize()
    fabric = StorageFabric(make_node_set("most_used"))
    ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(), device="cuda")

    # The main path's run: every count set to 0 just before, read after.
    shapes.reset()
    ops.reset_launch_stats()
    rs_bitmatmul.reset_launches()

    t0 = time.perf_counter()
    manifest = ck.save(state, 1)
    save_s = time.perf_counter() - t0
    groups = [g for m in manifest["leaves"] for g in m["groups"]]
    save_shapes = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    hist = collections.Counter(f"({g['k']},{g['p']})" for g in groups)
    nodes = collections.Counter(tuple(g["node_ids"]) for g in groups)
    after_save = ops.launch_stats()

    victim = groups[0]["node_ids"][0]
    fabric.fail_node(victim)
    t0 = time.perf_counter()
    restored, step = ck.restore_latest(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for name, t in state.items():
        if not torch.equal(restored[name], t):
            raise AssertionError(f"restore after node {victim} failed differs at {name}")
    del restored
    after_restore = ops.launch_stats()

    t0 = time.perf_counter()
    rebuilt = ck.repair()
    repair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, _ = ck.restore_latest(state)
    torch.cuda.synchronize()
    restore2_s = time.perf_counter() - t0
    for name, t in state.items():
        if not torch.equal(restored[name], t):
            raise AssertionError(f"restore after repair differs at {name}")
    del restored

    launches = rs_bitmatmul.launches
    per_kind = ops.launch_stats()
    issued = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    ck.close()
    if after_save["encode"] == 0 or after_restore["decode"] == 0:
        raise AssertionError(f"main path skipped the kernel: {after_save}, {after_restore}")
    if launches != per_kind["encode"] + per_kind["decode"] or launches == 0:
        raise AssertionError(f"launch counts disagree: {launches} vs {per_kind}")
    if rebuilt != len(groups):
        raise AssertionError(f"repair rebuilt {rebuilt} chunks for {len(groups)} groups")

    gb = n_bytes / 1e9
    report = {
        "state": {"model": "rwkv6_1_6b", "leaves": len(state), "params": n_params,
                  "bytes": n_bytes, "dtype": "bfloat16", "cuts": CUTS},
        "groups": len(groups),
        "kp_histogram": dict(hist),
        "node_sets_used": {",".join(map(str, k)): v for k, v in nodes.items()},
        "failed_node": victim,
        "save_s": save_s, "save_GBps": gb / save_s,
        "place_s": ck.stats["place_s"], "encode_s": ck.stats["encode_s"],
        "restore_s": restore_s, "restore_GBps": gb / restore_s,
        "repair_s": repair_s, "repaired_chunks": rebuilt,
        "restore_after_repair_s": restore2_s,
        "bytes_stored": ck.stats["bytes_stored"],
        "launches": {"total": launches, "save_encode": after_save["encode"],
                     "restore_decode": after_restore["decode"] - after_save["decode"],
                     "repair": {k: per_kind[k] - after_restore[k] for k in per_kind}},
        "host_peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "device_peak_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("[main] " + json.dumps(report))
    return {"report": report, "issued": issued, "save_shapes": save_shapes,
            "launches": launches}


def phase_timing(issued: list, seed: int) -> list[dict]:
    """Kernel against plain version at every (R, K, B) the main path
    launched: byte-equal, then timed (median of CUDA-event runs)."""
    import numpy as np

    from repro_torch.ec import gf256
    from repro_torch.kernels import ref, rs_bitmatmul

    rng = np.random.default_rng(seed)
    rows = []
    for r8, k8, blocks, block_bytes, dev in issued:
        if dev != "cuda":
            continue
        r, k, b = r8 // 8, k8 // 8, blocks * block_bytes
        m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        bm = torch.from_numpy(gf256.gf_to_bitmatrix(m)).cuda()
        d = torch.randint(0, 256, (k, b), dtype=torch.uint8, device="cuda")
        got = rs_bitmatmul.gf_bitmatmul(bm, d)
        want = ref.bitmatmul_ref(bm, d)
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        if err:
            raise AssertionError(f"kernel != plain version at R={r} K={k} B={b}")
        del got, want
        ms = cuda_time_ms(lambda: rs_bitmatmul.gf_bitmatmul(bm, d), reps=7)
        plain_ms = cuda_time_ms(lambda: ref.bitmatmul_ref(bm, d), reps=3)
        bound, by = bound_ms(r, k, b)
        moved = (k + r) * b
        rows.append({"R": r, "K": k, "B": b, "bytes": moved, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "GBps": moved / ms / 1e6, "max_abs_err": err})
        log("[timing] " + json.dumps(rows[-1]))
        del d
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_build()
    phase_kernel_grid(args.seed)
    phase_small_checkpoint(args.seed)
    main_run = phase_main(args.seed)
    rows = phase_timing(main_run["issued"], args.seed)
    # The headline shape is the save's widest encode wave.
    save = {(r8 // 8, k8 // 8, n * bb) for r8, k8, n, bb, _ in main_run["save_shapes"]}
    head = max((x for x in rows if (x["R"], x["K"], x["B"]) in save),
               key=lambda x: x["B"])
    kernel = {
        "name": "rs_bitmatmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rs_bitmatmul.cu",
        "replaces": "src/repro/kernels/rs_bitmatmul.py:56",
        "launches": main_run["launches"],
        "max_abs_err": max(x["max_abs_err"] for x in rows),
        "matches_plain": True,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {"R": head["R"], "K": head["K"], "B": head["B"]},
        "shapes": rows,
    }
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
