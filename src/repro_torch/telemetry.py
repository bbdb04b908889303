"""One facade over the library's introspection surfaces.

Four subsystems keep counters that benchmarks stamp into JSON: the top-M
pre-filter (:func:`repro_torch.core.prefilter.stats`), the EC
coefficient-matrix caches (:func:`repro_torch.kernels.ops.matrix_cache_stats`),
the shape-bucketer census (:func:`repro_torch.core.shapes.compile_cache_stats`)
and the per-engine :class:`~repro_torch.core.engine.PlacementEngine`
decision counters (``engine.stats``).  This facade freezes one stable
schema (:class:`TelemetrySnapshot`) behind :func:`snapshot` /
:func:`reset`, the JAX package's ``repro.telemetry`` schema field for
field.

The reference's fifth surface is jax's opt-in persistent XLA
compilation cache (``repro.core.jitcache``).  The port compiles no XLA
programs: its one device build is ``nvcc`` at first use, into the
package's ``kernels/_build/``.  So ``jit_cache`` stays a field, for the
schema, and holds ``None``.

The leaf dictionaries are what the underlying surfaces emit (the facade
copies, it does not reshape).  The first three surfaces are
process-wide; engine counters live on each :class:`PlacementEngine`
instance, so ``snapshot(engine=...)`` takes the instance to read
(``engine=None`` in the snapshot otherwise), and :func:`reset` only
touches the process-wide state.

Spans.  :func:`span` marks where a layer's work happens (a save's
snapshot, each encode wave, a restore's gather...).  Tracing is off
unless a :func:`tracing` block is open: then every span records its
name, start and end on :func:`time.time_ns` (the wall clock
``torch.profiler`` stamps its events with, so a span can be laid over a
device trace), its thread, its parent and the operation it belongs
to.  Off, :func:`span` hands back one shared no-op object: no clock
read, no allocation, no lock.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Iterator, Optional

__all__ = ["TelemetrySnapshot", "snapshot", "reset", "SpanRecord", "Recording", "tracing",
           "span"]


@dataclasses.dataclass(frozen=True)
class TelemetrySnapshot:
    """Point-in-time copy of every introspection surface (safe to
    mutate; the live counters are not aliased)."""

    #: per-scheduler pre-filter events (engaged / accepted / fallback /
    #: bypassed / promoted) — ``repro_torch.core.prefilter.stats()``.
    prefilter: dict[str, dict[str, int]]
    #: EC coefficient-matrix builds and LRU hit rates —
    #: ``repro_torch.kernels.ops.matrix_cache_stats()``.
    matrix_cache: dict[str, Any]
    #: issued-shape census per kernel family —
    #: ``repro_torch.core.shapes.compile_cache_stats()``.
    compile_cache: dict[str, Any]
    #: decision counters of the engine passed to :func:`snapshot`
    #: (placements, rejections, constraint swaps, repair gauges), or
    #: ``None`` when no engine was given.
    engine: Optional[dict[str, Any]] = None
    #: always ``None``: the port has no XLA compilation cache (see the
    #: module docstring).
    jit_cache: Optional[dict[str, Any]] = None

    def as_dict(self) -> dict[str, Any]:
        """Plain-dict view for JSON stamping."""
        return dataclasses.asdict(self)


def snapshot(engine=None) -> TelemetrySnapshot:
    """Copy every introspection surface; pass a
    :class:`~repro_torch.core.engine.PlacementEngine` to include its
    per-instance decision counters."""
    from repro_torch.core import prefilter, shapes
    from repro_torch.kernels import ops as kops

    return TelemetrySnapshot(
        prefilter=prefilter.stats(),
        matrix_cache=kops.matrix_cache_stats(),
        compile_cache=shapes.compile_cache_stats(),
        engine=dict(engine.stats) if engine is not None else None,
    )


def reset(
    *,
    prefilter_counters: bool = True,
    matrix_caches: bool = True,
    compile_census: bool = True,
) -> None:
    """Zero the process-wide counters (benchmark lane isolation).

    Engine counters are per-instance and unaffected — construct a fresh
    engine instead.  Resetting the census clears the bucketer's
    issued-shape record, not any built kernel.
    """
    from repro_torch.core import prefilter, shapes
    from repro_torch.kernels import ops as kops

    if prefilter_counters:
        prefilter.reset_stats()
    if matrix_caches:
        kops.reset_matrix_caches()
    if compile_census:
        shapes.reset()


# -- spans -----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, slots=True)
class SpanRecord:
    """One finished span."""

    name: str
    #: on :func:`time.time_ns`
    start_ns: int
    end_ns: int
    #: ``threading.get_ident()`` of the thread it ran on
    thread: int
    span_id: int
    #: the innermost span open on its thread when it began; None for a root
    parent_id: Optional[int]
    #: shared by every span of one operation (a save, a restore), on
    #: every thread: its parent's, the ``op`` a root was given, or a new one
    op: int


class Recording:
    """The spans of one :func:`tracing` block, in the order they ended.
    Spans that end after the block has closed are dropped."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self._lock = threading.Lock()
        self._open = True
        self._local = threading.local()
        # ``next`` on a count is one C call: atomic under the GIL
        self._span_ids = itertools.count(1)
        self._op_ids = itertools.count(1)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, record: SpanRecord) -> None:
        with self._lock:
            if self._open:
                self.spans.append(record)

    def _close(self) -> None:
        with self._lock:
            self._open = False


class _Span:
    """An open span."""

    __slots__ = ("_rec", "name", "_op", "span_id", "op", "parent_id", "start_ns")

    def __init__(self, rec: Recording, name: str, op: Optional[int]):
        self._rec, self.name, self._op = rec, name, op

    def __enter__(self) -> "_Span":
        rec = self._rec
        stack = rec._stack()
        parent = stack[-1] if stack else None
        self.parent_id = None if parent is None else parent.span_id
        if parent is not None:
            self.op = parent.op
        else:
            self.op = self._op if self._op is not None else next(rec._op_ids)
        self.span_id = next(rec._span_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.time_ns()
        self._rec._stack().pop()
        self._rec._append(SpanRecord(self.name, self.start_ns, end_ns, threading.get_ident(),
                                     self.span_id, self.parent_id, self.op))
        return False


class _NoSpan:
    """What :func:`span` returns while tracing is off: one shared object
    that does nothing."""

    __slots__ = ()
    op = None

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()
#: the open :func:`tracing` block's recording, or None: tracing is off
_recording: Optional[Recording] = None
_tracing_lock = threading.Lock()


@contextlib.contextmanager
def tracing() -> Iterator[Recording]:
    """Record every span that begins inside the block, on every thread,
    into a fresh :class:`Recording`, and yield it.  One block at a time."""
    global _recording
    with _tracing_lock:
        if _recording is not None:
            raise RuntimeError("tracing is already on")
        rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
        rec._close()


def span(name: str, op: Optional[int] = None):
    """A context manager that records one span named ``name``.

    Its parent is the innermost span open on this thread; a span
    without a parent is a root and starts a new operation, or joins ``op`` if given (an async save's
    snapshot on the caller's thread and its root on a pool thread).
    With tracing off, the one shared no-op span."""
    rec = _recording
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, op)

