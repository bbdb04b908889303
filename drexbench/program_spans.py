"""The program's own spans in a run of a checkpoint cell, and the numbers
they give.

``repro_torch.telemetry`` records a span at each boundary of the port's
checkpoint plane and coding layer (a save's snapshot, each encode wave
and its copy to the host, a restore's gather, staging and assembly...)
while a ``telemetry.tracing()`` block is open, stamped on
``time.time_ns``: the clock the profiler's events and the benchmark's
own spans are stamped on.  :func:`run` runs a cell inside such a block
and lays the spans of the calling thread over the device trace of a
traced run, ahead of the benchmark's own, so that an idle gap of the
card takes the name of the innermost program span around it; the
benchmark's span stays the name of last resort.  :func:`read` gives the
mean milliseconds a span name takes per operation (a save, a restore)
of the measured window.

``harness.run_cell`` does not open the block, and ``BENCHMARK.json`` has
no entry of :data:`METRICS`: the tests and this script use them.  On a
machine with a card:

    python3 drexbench/program_spans.py --workload ckpt.rwkv6_1b6.restore_node_lost \\
        --seed 12345 --seconds 30 --tracing 1 --trace 1

prints one JSON line: the cell's end-to-end numbers over the measured
window, each of :data:`METRICS` (None where the cell records no such
span), with ``--tracing 1`` each operation's time and phases in the
order they ran, and, with ``--trace 1``,
the share of the card's copy time inside the program span that issues
it, the share of the idle time that no program span or host operation
names, and the idle gaps
by name.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Optional

__all__ = ["METRICS", "CLOCK_CHECKS", "ROOT_SPAN", "FALLBACK", "run", "per_op", "read",
           "inside_share", "fallback_idle_share"]

#: metric -> (the span summed per operation, the root span of the operations)
METRICS = {
    "save.snapshot_ms": ("ckpt.save.snapshot", "ckpt.save"),
    "save.encode_ms": ("ckpt.save.encode", "ckpt.save"),
    "save.d2h_ms": ("ckpt.save.d2h", "ckpt.save"),
    "save.put_wait_ms": ("ckpt.save.put_wait", "ckpt.save"),
    "restore.gather_ms": ("ckpt.restore.gather", "ckpt.restore"),
    "restore.stage_ms": ("ec.stage", "ckpt.restore"),
    "restore.assemble_ms": ("ckpt.restore.assemble", "ckpt.restore"),
}

#: the cell's traffic driver -> (the card's copies, by name, and the span that issues them)
CLOCK_CHECKS = {
    "ckpt_save": ("Memcpy DtoH", "ckpt.save.d2h"),
    "ckpt_restore": ("Memcpy HtoD", "ec.stage"),
}

#: the cell's traffic driver -> the root span of its operations
ROOT_SPAN = {"ckpt_save": "ckpt.save", "ckpt_restore": "ckpt.restore"}

#: the names an idle gap takes where no program span is found around it:
#: the benchmark's spans (as ``harness.run_cell`` names them) and
#: ``DeviceTrace``'s own name for a gap under no span at all (which it
#: also gives a gap whose covering span began too many spans earlier)
FALLBACK = re.compile(r"^(drexbench .*, no profiled host operation"
                      r"|host, outside any profiled operation)$")


def run(cell, seed: int, seconds: float, trace: bool, device, tracing: bool = True,
        t_start: float | None = None, hooks: dict | None = None):
    """``harness.run_cell``, inside ``telemetry.tracing()`` when
    ``tracing``: the spans go to ``rec.facts["program_spans"]``, and
    those of this thread ahead of the benchmark's in ``rec.dev.spans``."""
    from repro_torch import telemetry

    from drexbench import harness

    if not tracing:
        return harness.run_cell(cell, seed, seconds, trace, device, t_start, hooks)
    with telemetry.tracing() as program:
        rec = harness.run_cell(cell, seed, seconds, trace, device, t_start, hooks)
    rec.facts["program_spans"] = program.spans
    if rec.dev is not None:
        me = threading.get_ident()
        rec.dev.spans = [(s.name, s.start_ns, s.end_ns) for s in program.spans
                         if s.thread == me] + rec.dev.spans
    return rec


def per_op(rec, span: str, root: str) -> tuple[list[float], int]:
    """(ms of the spans named ``span`` in each operation whose root span,
    named ``root``, lies in the measured window, in the order the
    operations began; how many such spans there were)."""
    spans = rec.facts.get("program_spans") or []
    w0, w1 = rec.window_ns
    ops = {s.op: 0 for s in sorted(spans, key=lambda s: s.start_ns)
           if s.name == root and w0 <= s.start_ns and s.end_ns <= w1}
    n = 0
    for s in spans:
        if s.name == span and s.op in ops:
            ops[s.op] += s.end_ns - s.start_ns
            n += 1
    return [t / 1e6 for t in ops.values()], n


def read(rec, metric: str) -> Optional[float]:
    """Mean ms of the metric's span per operation whose root lies in the
    measured window; None where no such operation, or no such span, was
    recorded."""
    ms, n = per_op(rec, *METRICS[metric])
    return sum(ms) / len(ms) if n else None


def inside_share(dev, pattern: str, spans, name: str) -> Optional[float]:
    """Share of the device time of the operations whose name matches
    ``pattern`` (clipped to the traced window) that lies inside the spans
    named ``name``; None without such device time."""
    rx = re.compile(pattern)
    cover: list[list[int]] = []
    for s, e in sorted((s.start_ns, s.end_ns) for s in spans if s.name == name):
        if cover and s <= cover[-1][1]:
            cover[-1][1] = max(cover[-1][1], e)
        else:
            cover.append([s, e])
    starts = [c[0] for c in cover]
    total = inside = 0
    for op, s, e in dev.device:
        s, e = max(s, dev.t0_ns), min(e, dev.t1_ns)
        if e <= s or not rx.search(op):
            continue
        total += e - s
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(cover) and cover[i][0] < e:
            inside += max(0, min(e, cover[i][1]) - max(s, cover[i][0]))
            i += 1
    return inside / total if total else None


def fallback_idle_share(dev) -> Optional[float]:
    """Share of the traced window's idle time that no host operation and
    no program span names: the gaps named after the benchmark's own
    spans, and those outside every span."""
    gaps = dev.breakdown(top=1 << 30)["idle_gaps"]
    idle = sum(t for _, t in gaps)
    return sum(t for n, t in gaps if FALLBACK.match(n)) / idle if idle else None


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    import json
    import sys

    import torch

    ap = argparse.ArgumentParser(description="a checkpoint cell with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("drexbench: program_spans.py needs a CUDA card", file=sys.stderr)
        return 2
    from drexbench import catalog, harness

    torch.set_num_threads(1)
    cell = catalog.resolve(args.workload)
    rec = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
              bool(args.tracing), t_start)
    out = {
        "workload": cell.name, "seed": args.seed, "tracing": args.tracing, "trace": args.trace,
        "device": torch.cuda.get_device_name(0), "window_s": rec.window_s,
        "n_ops": rec.facts["n_ops"],
        "end_to_end": {m["name"]: catalog.metric_reader(m["name"])(rec)
                       for m in cell.end_to_end},
        "program_spans": {m: read(rec, m) for m in METRICS},
        "correct": bool(rec.checks) and all(c.ok for c in rec.checks),
    }
    if args.tracing:
        root = ROOT_SPAN[cell.traffic["driver"]]
        spans = rec.facts["program_spans"]
        ops = {s.op for s in spans if s.name == root}
        out["spans_per_op"] = sum(1 for s in spans if s.op in ops) / max(1, len(ops))
        out["per_op_ms"] = {root: per_op(rec, root, root)[0]} | {
            m: per_op(rec, *METRICS[m])[0] for m in METRICS if METRICS[m][1] == root}
    if rec.dev is not None:
        pattern, name = CLOCK_CHECKS[cell.traffic["driver"]]
        out["clock"] = {f"{pattern} inside {name}": inside_share(
            rec.dev, pattern, rec.facts.get("program_spans", []), name)}
        out["fallback_idle_share"] = fallback_idle_share(rec.dev)
        out["busy_s"], out["traced_window_s"] = rec.dev.busy_s, rec.dev.window_s
        out["breakdown"] = rec.dev.breakdown(top=16)
    print(harness.checks_text(rec), file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import os
    import pathlib
    import sys
    import time

    T_START = time.perf_counter()
    ROOT = pathlib.Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # the settings of run.py: one thread for torch's, OpenMP's and BLAS's pools
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "drexbench" / ".cache" / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.exit(main(t_start=T_START))
