"""Spans the benchmark records around its calls into the program.

A span is a name, a start and an end on the wall clock
(``time.time_ns``, the clock the profiler stamps its events with) and a
duration on the monotonic clock.  They live in memory for the run.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

__all__ = ["Span", "SpanLog"]


@dataclass(frozen=True)
class Span:
    name: str
    start_ns: int
    end_ns: int
    seconds: float


@dataclass
class SpanLog:
    spans: list = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        w0, t0 = time.time_ns(), time.perf_counter()
        try:
            yield
        finally:
            t1, w1 = time.perf_counter(), time.time_ns()
            self.spans.append(Span(name, w0, w1, t1 - t0))

    def wrap(self, name: str, fn):
        """``fn`` with every call recorded as a span named ``name``."""

        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return wrapped

    def seconds(self, name: str, t0_ns: int = 0, t1_ns: int | None = None) -> list[float]:
        """Durations of the spans named ``name`` that lie in [t0, t1]."""
        return [s.seconds for s in self.spans if s.name == name and s.start_ns >= t0_ns
                and (t1_ns is None or s.end_ns <= t1_ns)]
