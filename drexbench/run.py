"""Run one cell of the benchmark on the card and print its result line.

    python3 drexbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, inputs from the seed, one warm-up operation of the
cell's own kind, kernels built at first use) is timed from the start of
this process; then operations of the cell run back to back for
``--seconds``; with ``--trace 1`` they then run on under the profiler
for at most ``harness.TRACED_SECONDS``; then the comparison with the
plain reference.  The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error.  Without a CUDA
card, or with fewer cards than the cell asks for, it exits 2 and prints
no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
# Kernel caches stay in the checkout, at fixed paths (the port's nvcc
# builds go to src/repro_torch/kernels/_build/ by themselves).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "drexbench" / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"
#: CPU threads of torch's and the numeric libraries' pools.  A run's host
#: work is one Python thread (and the checkpointer's own workers); pools
#: as wide as the machine only add threads that wait on cores the host
#: shares with the card's driver.
HOST_THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)


def _tenths(values: list) -> list:
    n = len(values)
    parts = [sorted(values[i * n // 10 : (i + 1) * n // 10]) for i in range(10)]
    return [round(p[len(p) // 2], 4) for p in parts if p]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if HOST_THREADS:
        torch.set_num_threads(HOST_THREADS)
    from drexbench import catalog, harness

    cell = catalog.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"drexbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    rec = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), t_start=T_START)
    t_line = time.perf_counter()
    line = harness.result_line(rec)
    t_line = time.perf_counter() - t_line
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"drexbench: the run loaded forbidden modules: {loaded}", file=sys.stderr)
        return 3
    print(f"drexbench: {cell.name} seed {args.seed}: set-up {rec.setup_s:.3f} s, window "
          f"{rec.window_s:.3f} s, after the window {time.perf_counter() - rec.window_end:.3f} s, "
          f"{rec.attempted} attempted; the result line took {t_line:.3f} s"
          + (f", the profiler {rec.dev.stop_s:.3f} s to stop and {rec.dev.read_s:.3f} s to read"
             if rec.dev else "") + "; facts "
          f"{ {k: v for k, v in rec.facts.items() if isinstance(v, (int, float))} }; the host "
          f"in the measured window {rec.host}", file=sys.stderr)
    for name in sorted({s.name for s in rec.spans.spans}):
        secs = sorted(rec.spans.seconds(name))
        print(f"drexbench: span {name}: {len(secs)} in the run, seconds min {secs[0]:.4f} "
              f"median {secs[len(secs) // 2]:.4f} max {secs[-1]:.4f}; the median of each "
              f"tenth of the run, in order: {_tenths(rec.spans.seconds(name))}", file=sys.stderr)
    print(harness.checks_text(rec), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
