"""Snapshot-epoch concurrency for placement-service reads.

Readers of a live placement service must never observe a half-applied
window (some of a flush's commits visible, others not) and must never
block placements.  The frontier therefore publishes an :class:`Epoch` —
a deep, write-protected :class:`~repro_torch.core.types.ClusterView` copy plus
engine counters — only at consistency points: service start, the end of
each window flush, and after each churn event.  Reads return the latest
published epoch in O(1); the live view is never handed out.

Epochs are totally ordered by ``epoch_id`` and stamped with the engine's
``mutation_seq``, so a reader can tell exactly how many engine-side
mutations separate two snapshots without comparing arrays.  A bounded
ring of recent epochs is kept so diagnostics can diff consecutive
consistency points (e.g. the epoch-consistency tests replay window
commits against them).
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch.core.types import ClusterView

__all__ = ["Epoch", "EpochJournal"]


@dataclasses.dataclass(frozen=True)
class Epoch:
    """One published consistency point.  ``cluster`` arrays are
    write-protected copies — safe to hold indefinitely."""

    epoch_id: int
    virtual_t: float          # virtual seconds at publication
    mutation_seq: int         # engine mutation counter at publication
    cluster: ClusterView
    stats: dict               # engine stats copy (n_placed, mb_committed, ...)

    @property
    def free_mb(self):
        return self.cluster.free_mb

    @property
    def n_live(self) -> int:
        return int(self.cluster.alive.sum())


class EpochJournal:
    """Publisher + bounded history of snapshot epochs."""

    def __init__(self, keep: int = 8):
        if keep < 1:
            raise ValueError("must keep at least the latest epoch")
        self._ring: collections.deque[Epoch] = collections.deque(maxlen=keep)
        self._next_id = 0

    def publish(self, engine, virtual_t: float) -> Epoch:
        """Snapshot ``engine`` at a consistency point and publish it."""
        epoch = Epoch(
            epoch_id=self._next_id,
            virtual_t=float(virtual_t),
            mutation_seq=engine.mutation_seq,
            cluster=engine.view_snapshot(),
            stats=dict(engine.stats),
        )
        self._next_id += 1
        self._ring.append(epoch)
        return epoch

    def latest(self) -> Epoch:
        if not self._ring:
            raise LookupError("no epoch published yet")
        return self._ring[-1]

    def history(self) -> list[Epoch]:
        """Retained epochs, oldest first (bounded by ``keep``)."""
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)
