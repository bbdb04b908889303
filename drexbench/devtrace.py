"""The device trace of a traced run, read from ``torch.profiler``.

Device operations (kernels, copies, fills) and host operations come from
the profiler's events, stamped on the wall clock in nanoseconds.  From
them: the seconds in which an operation ran on the device (the union of
their intervals), device seconds by operation name, and the idle gaps
named by what the host was doing in them.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field

import numpy as np

__all__ = ["DeviceTrace", "profiled"]


@dataclass
class DeviceTrace:
    """Device and host events of one traced window [t0_ns, t1_ns]."""

    t0_ns: int
    t1_ns: int
    #: (name, start_ns, end_ns) of every device operation in the window
    device: list = field(default_factory=list)
    #: (name, start_ns, end_ns) of every host operation
    host: list = field(default_factory=list)
    #: (name, start_ns, end_ns) of the benchmark's spans: they name the
    #: gaps under which no host operation was recorded
    spans: list = field(default_factory=list)
    #: seconds the profiler took to stop, and to hand over its events
    stop_s: float = 0.0
    read_s: float = 0.0
    _by_name: dict | None = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def _merged(self) -> list[tuple[int, int]]:
        iv = sorted((max(s, self.t0_ns), min(e, self.t1_ns)) for _, s, e in self.device)
        out: list[list[int]] = []
        for s, e in iv:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged()) / 1e9

    def by_name(self) -> dict:
        """Device seconds of each operation name, clipped to the window."""
        if self._by_name is None:
            out: dict[str, float] = {}
            for name, s, e in self.device:
                out[name] = out.get(name, 0.0) + max(0, min(e, self.t1_ns) - max(s, self.t0_ns)) / 1e9
            self._by_name = out
        return self._by_name

    def device_s(self, pattern: str, exclude: str | None = None) -> float:
        """Device seconds of operations whose name matches ``pattern``
        (and not ``exclude``), clipped to the window."""
        rx = re.compile(pattern)
        ex = re.compile(exclude) if exclude else None
        return sum(t for name, t in self.by_name().items()
                   if rx.search(name) and not (ex and ex.search(name)))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host operation under each gap's middle."""
        by_op: dict[str, float] = {}
        for name, t in self.by_name().items():
            key = _short(name)
            by_op[key] = by_op.get(key, 0.0) + t
        busy = self._merged()
        edges = np.array([self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns], dtype=np.int64)
        g0, g1 = edges[0::2], edges[1::2]
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        mid = (g0 + g1) // 2
        names = self._under(self.host, mid)
        outside = [i for i, n in enumerate(names) if n is None]
        for i, n in zip(outside, self._under(self.spans, mid[outside])):
            names[i] = n or "host, outside any profiled operation"
        by_host: dict[str, float] = {}
        for name, sec in zip(names, (g1 - g0) / 1e9):
            by_host[name] = by_host.get(name, 0.0) + float(sec)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in order(by_op)],
                "idle_gaps": [[k, v] for k, v in order(by_host)]}

    @staticmethod
    def _under(events: list, times: np.ndarray, reach: int = 64) -> list:
        """For each time, the name of the shortest event covering it among
        the ``reach`` that began last before it, or None."""
        if not events or not len(times):
            return [None] * len(times)
        host = sorted(events, key=lambda h: h[1])
        starts = np.array([h[1] for h in host], dtype=np.int64)
        ends = np.array([h[2] for h in host], dtype=np.int64)
        last = np.searchsorted(starts, times, side="right")  # events [0, last) began before
        cand = last[:, None] - 1 - np.arange(reach)[None, :]
        valid = cand >= 0
        cand = np.where(valid, cand, 0)
        covers = valid & (ends[cand] >= times[:, None])
        dur = np.where(covers, ends[cand] - starts[cand], np.iinfo(np.int64).max)
        pick = np.argmin(dur, axis=1)
        found = covers[np.arange(len(times)), pick]
        idx = cand[np.arange(len(times)), pick]
        return [host[i][0] if ok else None for i, ok in zip(idx, found)]


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' markers,
    template arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120]


@contextlib.contextmanager
def profiled(enabled: bool, holder: list):
    """Profile the block when ``enabled``; append its :class:`DeviceTrace`
    to ``holder`` once the block ends.  On a card the trace is the card's
    activity (its operations, and the host's calls into the CUDA runtime),
    without torch's host operators, so that tracing slows the host little;
    on a machine without a card it holds the host's operators."""
    if not enabled:
        yield
        return
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CUDA if card else ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        yield
        if card:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    stopped = time.time_ns()
    trace = DeviceTrace(t0, t1, stop_s=(stopped - t1) / 1e9)
    for ev in prof.profiler.kineto_results.events():
        s = int(ev.start_ns())
        e = s + int(ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            trace.host.append((ev.name(), s, e))
        else:
            trace.device.append((ev.name(), s, e))
    trace.read_s = (time.time_ns() - stopped) / 1e9
    holder.append(trace)
