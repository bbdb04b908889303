"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

A driver (``drexbench/drivers/<driver>.py``) fills a :class:`Record`:
its set-up and window times, what it attempted, the facts the metric
readers need, its spans, the device trace of a traced run, and the
numbers its comparison produced, each beside its limit.  This module
turns the record into the one JSON line the run prints.
"""

from __future__ import annotations

import gc
import resource
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

from drexbench import catalog
from drexbench.devtrace import DeviceTrace, profiled
from drexbench.spans import SpanLog

__all__ = ["Check", "Record", "FORBIDDEN", "TRACED_SECONDS", "window", "forbidden_modules",
           "run_cell", "result_line"]

#: top-level module names no run may have loaded: JAX, and the JAX package
#: the port was made from (``repro_torch`` is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: length of a traced run's second, profiled window (at most ``--seconds``)
TRACED_SECONDS = 15.0


@dataclass(frozen=True)
class Check:
    """A number the comparison produced and its limit: correct iff value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Record:
    cell: catalog.Cell
    seed: int
    seconds: float
    trace: bool
    device: object                     # torch.device
    t_start: float                     # perf_counter when the process began
    window_start: float = 0.0          # perf_counter
    window_end: float = 0.0
    window_ns: tuple = (0, 0)          # the same on the wall clock (time.time_ns)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    facts: dict = field(default_factory=dict)
    spans: SpanLog = field(default_factory=SpanLog)
    dev: Optional[DeviceTrace] = None
    checks: list = field(default_factory=list)
    #: the host during the measured window (see :func:`_host_use`)
    host: dict = field(default_factory=dict)

    @property
    def setup_s(self) -> float:
        return self.window_start - self.t_start

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start


def window(rec: Record, step, between=None) -> int:
    """The measured window: ``step()`` back to back until ``rec.seconds``
    have passed or it returns False (its work ran out).  Sets the
    window's times and what the host did in it.  In a traced run,
    ``between()`` (if given) is called once the measured window has
    closed, then ``step()`` runs again for ``min(rec.seconds,
    TRACED_SECONDS)`` under the profiler: host-clock and span metrics
    read the measured window, device-trace metrics the traced one.
    Sets the device memory peak of the run so far; returns the steps the
    measured window ran."""
    gc.collect()
    gc.freeze()  # the inputs and the set-up's objects: no collection in the window rescans them
    use = _HostUse()
    rec.window_start, w0_ns = time.perf_counter(), time.time_ns()
    n = _steps(step, rec.window_start, rec.seconds)
    rec.window_end, w1_ns = time.perf_counter(), time.time_ns()
    rec.window_ns = (w0_ns, w1_ns)
    rec.host = use.read(rec.window_end - rec.window_start)
    if rec.trace:
        if between is not None:
            between()
        holder: list = []
        with profiled(True, holder):
            t0, t0_ns = time.perf_counter(), time.time_ns()
            _steps(step, t0, min(rec.seconds, TRACED_SECONDS))
            t1_ns = time.time_ns()
        rec.dev = holder[0]
        rec.dev.t0_ns, rec.dev.t1_ns = t0_ns, t1_ns
    gc.unfreeze()
    if rec.device.type == "cuda":
        import torch

        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(rec.device))
    return n


def _steps(step, t0: float, seconds: float) -> int:
    n = 0
    while True:
        more = step()
        n += 1
        if more is False or time.perf_counter() - t0 >= seconds:
            return n


class _HostUse:
    """What the host did between its start and :meth:`read`: this
    process's CPU seconds (all its threads; a wait on the card spins, so
    this is near the wall time when one thread paces the run) and the
    garbage collector's pauses."""

    def __init__(self):
        self.gc_s, self.gc_n, self._gc_t = 0.0, 0, 0.0
        gc.callbacks.append(self._gc)
        self.ru = resource.getrusage(resource.RUSAGE_SELF)

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._gc_t
            self.gc_n += 1

    def read(self, wall_s: float) -> dict:
        gc.callbacks.remove(self._gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu_s = (ru.ru_utime - self.ru.ru_utime) + (ru.ru_stime - self.ru.ru_stime)
        return {"wall_s": wall_s, "cpu_s": cpu_s, "gc_s": self.gc_s, "gc_n": self.gc_n}


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def run_cell(cell: catalog.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None, hooks: dict | None = None) -> Record:
    """Run the cell's driver; ``hooks`` (tests only) reach into the
    driver to break the timed path."""
    rec = Record(cell, int(seed), float(seconds), bool(trace), device,
                 time.perf_counter() if t_start is None else t_start)
    catalog.driver(cell).run(rec, hooks or {})
    if rec.dev is not None:
        rec.dev.spans = [(f"drexbench {s.name}, no profiled host operation", s.start_ns, s.end_ns)
                         for s in rec.spans.spans]
    return rec


def _metrics(rec: Record) -> dict:
    entries = rec.cell.per_layer if rec.trace else rec.cell.end_to_end
    out = {}
    for m in entries:
        value = catalog.metric_reader(m["name"])(rec)
        if value is None:
            if not rec.trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def _device(rec: Record) -> dict:
    import torch

    dev = {"platform": "gpu" if rec.device.type == "cuda" else rec.device.type,
           "kind": torch.cuda.get_device_name(rec.device) if rec.device.type == "cuda" else "cpu",
           "count": rec.cell.chips, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if rec.trace and rec.dev is not None:
        dev["busy_s"] = rec.dev.busy_s
        dev["window_s"] = rec.dev.window_s
    return dev


def result_line(rec: Record) -> dict:
    line = {
        "correct": bool(rec.checks) and all(c.ok for c in rec.checks),
        "attempted": int(rec.attempted),
        "failed": int(rec.failed),
        "metrics": _metrics(rec),
        "device": _device(rec),
    }
    if rec.trace and rec.dev is not None:
        line["breakdown"] = rec.dev.breakdown()
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in rec.checks}
    return line


def checks_text(rec: Record) -> str:
    return "\n".join(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}"
                     for c in rec.checks)
