"""Compare versions of the ``pb_frontier`` CUDA source on one NVIDIA GPU.

Run from the repository root::

    python3 frontier_ab.py NAME=path/to/pb_frontier.cu [NAME=path ...] [--reps N]

Each source is built with the kernel's own flags (``nvcc`` for ``sm_90a``,
``-fmad=false``) and loaded on its own.  Its C interface is read from the
source: the first design's ``pb_frontier(probs, targets, out, B, L, S,
L_live, W, stream)``, or a later one that also takes the launch plan's
fields (variant, chunk, rows per block, shared bytes[, stage_k, guard]);
the current :func:`repro_torch.kernels.pb_frontier.plan` supplies them.
At each shape every version must be int64-equal to the plain version
(``kernels.ref.pb_frontier_ref``); then all are timed in turns (A, B, ...,
then the reverse order), each a median of CUDA-event runs, on the same
card.  Shapes: the RWKV6-1.6B save's (``most_used`` nodes, 30 days, RT
0.999), the decisions-at-scale shape and the committed stream's (the scale
lane's freest 1,096 nodes, 365 days, RT 0.99), truncated rows (W 65 and
33), and rows whose parities pass 127 (fail probabilities 0.05-0.3).
Prints the card's name and power limit, one JSON line per shape, and
exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def c_params(source: pathlib.Path) -> list[str]:
    """Parameter names of the source's ``extern "C" int pb_frontier(...)``."""
    m = re.search(r"int pb_frontier\(([^)]*)\)", source.read_text())
    if not m:
        raise ValueError(f"{source}: no pb_frontier entry point")
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


class Version:
    def __init__(self, name: str, source: pathlib.Path):
        from repro_torch.kernels import nvcc, pb_frontier

        self.name, self.params = name, c_params(source)
        self.lib = ctypes.CDLL(str(nvcc.build(source, pb_frontier.FLAGS)))
        n_int = len(self.params) - 4  # three pointers and the stream
        self.lib.pb_frontier.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        self.lib.pb_frontier.restype = ctypes.c_int

    def __call__(self, probs, targets, S: int, L_live: int, W: int) -> torch.Tensor:
        from repro_torch.kernels import pb_frontier

        B, L = probs.shape
        out = torch.empty((B, S, L), dtype=torch.int64, device=probs.device)
        args = [B, L, S, L_live, W]
        if "variant" in self.params:
            pl = pb_frontier.plan(B * S, W, *pb_frontier.device_limits(probs.device))
            shared = pl.shared_bytes if (pl.variant == "shared" or "stage_k" in self.params) else 0
            args += [pb_frontier._VARIANT_ID[pl.variant], pl.chunk, pl.rows_per_block, shared]
            if "stage_k" in self.params:
                args += [pl.stage_k, pl.guard]
        err = self.lib.pb_frontier(probs.data_ptr(), targets.data_ptr(), out.data_ptr(),
                                   *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{self.name}: CUDA error {err}")
        return out


def cuda_ms(fn, reps: int) -> float:
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


def cases() -> list[tuple]:
    """(label, probs (B, L) f64 numpy, targets, S, L_live, W)."""
    import chip_smoke
    from repro_torch.core import ClusterView
    from repro_torch.core.algorithms import Scheduler
    from repro_torch.storage import make_node_set

    mu = ClusterView.from_nodes(make_node_set("most_used"))
    fp_mu = mu.fail_probs(30.0)[Scheduler._live_sorted(mu, mu.free_mb)]
    save = np.zeros((64, 16))
    save[:, : fp_mu.shape[0]] = fp_mu
    fp = chip_smoke.scale_fail_probs()
    L = fp.shape[0]
    high = np.random.default_rng(7).uniform(0.05, 0.3, size=(2, L))
    return [
        ("save", save, [0.999] * 64, 15, fp_mu.shape[0], 17),
        ("scale", np.tile(fp, (64, 1)), [0.99] * 64, 8, L, L + 1),
        ("committed", fp[None], [0.99], 8, L, L + 1),
        ("truncated_65", np.tile(fp, (4, 1)), [0.99, 0.999, 0.99, 0.999], 8, L, 65),
        ("truncated_33", np.tile(fp, (4, 1)), [0.99, 0.999, 0.99, 0.999], 8, L, 33),
        ("parity_past_127", high, [0.99, 0.999], 4, L, L + 1),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("versions", nargs="+", help="NAME=path/to/pb_frontier.cu")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("frontier_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    versions = [Version(n, ROOT / p) for n, p in (v.split("=", 1) for v in args.versions)]
    for label, probs_np, targets, S, L_live, W in cases():
        probs = torch.from_numpy(probs_np).cuda()
        t = torch.tensor(targets, dtype=torch.float64, device="cuda")
        nb = min(probs.shape[0], 2)  # the plain version on two rows (all rows alike)
        want = ref.pb_frontier_ref(probs[:nb], t[:nb], S, L_live, W)
        for v in versions:
            if not torch.equal(v(probs, t, S, L_live, W)[:nb], want):
                raise AssertionError(f"{v.name} != plain version at {label}")
        ms = {v.name: [] for v in versions}
        for v in versions + versions[::-1]:
            ms[v.name].append(cuda_ms(lambda: v(probs, t, S, L_live, W), args.reps))
        B, L = probs_np.shape
        print(json.dumps({"at": label, "B": B, "S": S, "L": L, "L_live": L_live, "W": W,
                          "max_parity": int(want.max()), "equal_plain": True, "ms": ms,
                          "ns_per_step": {k: min(x) * 1e6 / L_live for k, x in ms.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
