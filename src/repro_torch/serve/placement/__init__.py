"""Streaming placement service (the serving plane of the D-Rex stack).

A long-lived, deterministic service over
:class:`~repro_torch.core.engine.PlacementEngine`:

* :mod:`.admission` — bounded FIFO queue; full == explicit per-item
  admission reject (backpressure, never silent drops);
* :mod:`.frontier` — the event loop: coalesces arrivals into
  micro-batched ``place_many`` windows (max-batch / max-wait), applies
  failure/join/heal churn between windows, and repairs affected items
  through ``engine.plan_repair``;
* :mod:`.epochs` — snapshot-epoch reads: consistent, write-protected
  :class:`~repro_torch.core.types.ClusterView` copies published at window
  boundaries so readers never block (or observe half of) a flush;
* :mod:`.metrics` — service telemetry: virtual (deterministic) sojourn
  / goodput / queue depth / rejects, wall-clock p50/p99 decision
  latency.

See :mod:`.frontier` for the determinism contract (virtual clock +
fixed service model ⇒ byte-identical replay).  Host numpy, copied from
the JAX package's ``serve/placement/``; the engine handed to the
frontier carries the device its scheduler decides on (CUDA unless the
engine was built with ``device="cpu"``).  ``chip_smoke.py``'s
``[serve]`` lines drive it on the card.
"""

from .admission import AdmissionQueue, QueuedItem
from .epochs import Epoch, EpochJournal
from .frontier import (
    ADMISSION_REJECT,
    PLACED,
    REJECTED,
    FrontierConfig,
    PlacementFrontier,
    ServiceEvent,
    ServiceOutcome,
    ServiceReport,
    arrival_events,
    churn_events,
    placements_digest,
)
from .metrics import LatencyStats, ServiceMetrics

__all__ = [
    "ADMISSION_REJECT",
    "PLACED",
    "REJECTED",
    "AdmissionQueue",
    "Epoch",
    "EpochJournal",
    "FrontierConfig",
    "LatencyStats",
    "PlacementFrontier",
    "QueuedItem",
    "ServiceEvent",
    "ServiceMetrics",
    "ServiceOutcome",
    "ServiceReport",
    "arrival_events",
    "churn_events",
    "placements_digest",
]
