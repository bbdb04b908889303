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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

__all__ = ["TelemetrySnapshot", "snapshot", "reset"]


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
