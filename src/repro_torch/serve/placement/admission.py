"""Bounded admission queue for the streaming placement frontier.

Open-loop arrivals are offered to the queue; when it is full the offer
is *rejected explicitly* — the caller receives ``False`` and must emit a
per-item rejected outcome (the frontier turns it into a
``ServiceOutcome`` with status ``"admission_reject"``).  Nothing is ever
dropped silently: ``n_offered == n_admitted + n_rejected`` is a class
invariant, pinned by tests/test_torch_serve.py.
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch.core.types import DataItem

__all__ = ["QueuedItem", "AdmissionQueue"]


@dataclasses.dataclass(frozen=True)
class QueuedItem:
    """One admitted arrival waiting for a window flush."""

    item: DataItem
    enqueued_t: float  # virtual seconds


class AdmissionQueue:
    """FIFO queue with a hard depth bound (the backpressure knob)."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"queue capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._q: collections.deque[QueuedItem] = collections.deque()
        self.n_offered = 0
        self.n_admitted = 0
        self.n_rejected = 0

    def __len__(self) -> int:
        return len(self._q)

    @property
    def depth(self) -> int:
        return len(self._q)

    def offer(self, item: DataItem, t: float) -> bool:
        """Admit ``item`` at virtual time ``t``; False == admission reject."""
        self.n_offered += 1
        if len(self._q) >= self.capacity:
            self.n_rejected += 1
            return False
        self._q.append(QueuedItem(item, t))
        self.n_admitted += 1
        return True

    def oldest_t(self) -> float | None:
        """Enqueue time of the head item (drives the max-wait trigger)."""
        return self._q[0].enqueued_t if self._q else None

    def peek_t(self, i: int) -> float:
        """Enqueue time of the i-th queued item (drives the max-batch
        trigger: the next window is full the moment its last member
        arrived)."""
        return self._q[i].enqueued_t

    def take(self, n: int) -> list[QueuedItem]:
        """Dequeue up to ``n`` items FIFO — one micro-batch window."""
        out = [self._q.popleft() for _ in range(min(n, len(self._q)))]
        return out

    def counters(self) -> dict:
        return {
            "offered": self.n_offered,
            "admitted": self.n_admitted,
            "admission_rejected": self.n_rejected,
        }
