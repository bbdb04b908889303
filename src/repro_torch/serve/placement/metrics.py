"""Service telemetry for the streaming placement frontier.

Two clocks, deliberately separated:

* **virtual** quantities (sojourn, queue depth, goodput over the virtual
  makespan, reject counts) are functions of the deterministic service
  model and therefore byte-stable across runs and machines — a
  benchmark can pin them with equality;
* **wall** quantities (p50/p99 decision latency, flush wall time) are
  measured ``time.perf_counter`` costs of the actual ``place_many``
  calls — they never influence decisions, and are compared as ratios
  with a noise budget, like every other timing metric.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LatencyStats", "ServiceMetrics"]


class LatencyStats:
    """Reservoir of latency samples (seconds) with percentile summary."""

    def __init__(self):
        self._vals: list[float] = []

    def record(self, seconds: float) -> None:
        self._vals.append(float(seconds))

    def record_many(self, seconds: float, n: int) -> None:
        self._vals.extend([float(seconds)] * n)

    @property
    def count(self) -> int:
        return len(self._vals)

    def percentile_ms(self, q: float) -> float:
        if not self._vals:
            return 0.0
        return 1e3 * float(np.percentile(np.asarray(self._vals), q))

    def total_s(self) -> float:
        return float(sum(self._vals))

    def summary_ms(self) -> dict:
        if not self._vals:
            return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0, "mean_ms": 0.0}
        arr = np.asarray(self._vals)
        return {
            "count": int(arr.size),
            "p50_ms": 1e3 * float(np.percentile(arr, 50)),
            "p99_ms": 1e3 * float(np.percentile(arr, 99)),
            "mean_ms": 1e3 * float(arr.mean()),
        }


class ServiceMetrics:
    """Counters + latency reservoirs for one frontier run."""

    def __init__(self):
        self.n_placed = 0
        self.n_rejected_placement = 0   # scheduler said no
        self.n_rejected_admission = 0   # queue was full
        self.n_flushes = 0
        self.n_flushed_items = 0
        self.n_failures = 0
        self.n_joins = 0
        self.n_heals = 0
        self.n_repairs = 0
        self.n_items_lost = 0
        self.mb_lost = 0.0
        self.max_queue_depth = 0
        self._depth_sum = 0
        self._depth_samples = 0
        #: wall clock: per-item share of each window's place_many call
        self.decision_wall = LatencyStats()
        #: virtual clock: arrival -> decision (queue wait + service)
        self.sojourn_virtual = LatencyStats()

    def record_depth(self, depth: int) -> None:
        self.max_queue_depth = max(self.max_queue_depth, depth)
        self._depth_sum += depth
        self._depth_samples += 1

    def record_flush(self, batch: int, wall_s: float) -> None:
        self.n_flushes += 1
        self.n_flushed_items += batch
        self.decision_wall.record_many(wall_s / batch, batch)

    def summary(self, makespan_virtual_s: float) -> dict:
        span = max(makespan_virtual_s, 1e-12)
        offered = (
            self.n_placed + self.n_rejected_placement + self.n_rejected_admission
        )
        return {
            "n_offered": offered,
            "n_placed": self.n_placed,
            "n_rejected_placement": self.n_rejected_placement,
            "n_rejected_admission": self.n_rejected_admission,
            "reject_count": self.n_rejected_placement + self.n_rejected_admission,
            "reject_rate": (
                (self.n_rejected_placement + self.n_rejected_admission) / offered
                if offered
                else 0.0
            ),
            "n_flushes": self.n_flushes,
            "mean_window": (
                self.n_flushed_items / self.n_flushes if self.n_flushes else 0.0
            ),
            "n_failures": self.n_failures,
            "n_joins": self.n_joins,
            "n_heals": self.n_heals,
            "n_repairs": self.n_repairs,
            "n_items_lost": self.n_items_lost,
            "mb_lost": self.mb_lost,
            "max_queue_depth": self.max_queue_depth,
            "mean_queue_depth": (
                self._depth_sum / self._depth_samples if self._depth_samples else 0.0
            ),
            # deterministic (virtual clock):
            "makespan_virtual_s": makespan_virtual_s,
            "goodput_virtual_items_per_s": self.n_placed / span,
            "sojourn_virtual": self.sojourn_virtual.summary_ms(),
            # measured (wall clock):
            "decision_wall": self.decision_wall.summary_ms(),
            "decision_wall_total_s": self.decision_wall.total_s(),
        }
