"""Simulated heterogeneous storage fabric (the DynoStore-style data
containers of paper §6).

Each storage node holds chunk blobs up to its capacity; nodes can
fail-stop (dropping everything they held). The fabric exposes the same
``ClusterView`` the D-Rex schedulers consume, so placement decisions made
for checkpoints use the identical code path as the paper's simulator.
Optionally persists chunks to a directory per node (restart across
processes).
"""

from __future__ import annotations

import pathlib
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.types import ClusterView, StorageNode

__all__ = ["StorageFabric"]


class StorageFabric:
    def __init__(
        self,
        nodes: Sequence[StorageNode],
        persist_dir: Optional[str] = None,
        link_mbps: Optional[float] = None,
    ):
        self.nodes = list(nodes)
        self.cluster = ClusterView.from_nodes(self.nodes)
        self._blobs: list[dict[str, bytes]] = [{} for _ in self.nodes]
        self._lock = threading.Lock()
        #: simulated per-put link bandwidth (MB/s): each ``put`` blocks
        #: its calling thread for blob_mb / link_mbps *outside* the
        #: fabric lock, so concurrent writers overlap like independent
        #: network links.  ``None`` = in-memory speed (tests, simulator);
        #: benchmarks/fig13 uses this to make upload pipelining
        #: measurable against a realistic write cost.
        self.link_mbps = link_mbps
        self.persist_dir = pathlib.Path(persist_dir) if persist_dir else None
        if self.persist_dir:
            for i in range(len(self.nodes)):
                (self.persist_dir / f"node_{i}").mkdir(parents=True, exist_ok=True)
            self._reload()

    # -- data plane -----------------------------------------------------------

    def put(self, node_id: int, key: str, blob: bytes) -> None:
        if self.link_mbps:
            time.sleep(len(blob) / 1e6 / self.link_mbps)
        with self._lock:
            if not self.cluster.alive[node_id]:
                raise IOError(f"node {node_id} is down")
            size_mb = len(blob) / 1e6
            if self.cluster.free_mb[node_id] < size_mb:
                raise IOError(f"node {node_id} out of capacity")
            old = self._blobs[node_id].pop(key, None)
            used = self.cluster.writable("used_mb")
            if old is not None:
                used[node_id] -= len(old) / 1e6
            self._blobs[node_id][key] = blob
            used[node_id] += size_mb
        if self.persist_dir:
            (self.persist_dir / f"node_{node_id}" / key).write_bytes(blob)

    def get(self, node_id: int, key: str) -> Optional[bytes]:
        with self._lock:
            if not self.cluster.alive[node_id]:
                return None
            return self._blobs[node_id].get(key)

    def delete(self, node_id: int, key: str) -> None:
        with self._lock:
            blob = self._blobs[node_id].pop(key, None)
            if blob is not None:
                self.cluster.writable("used_mb")[node_id] -= len(blob) / 1e6
        if self.persist_dir:
            p = self.persist_dir / f"node_{node_id}" / key
            if p.exists():
                p.unlink()

    # -- failure injection ------------------------------------------------------

    def fail_node(self, node_id: int) -> None:
        """Fail-stop: all chunks on the node are permanently lost."""
        with self._lock:
            self.cluster.fail_node(node_id)
            self._blobs[node_id].clear()
            self.cluster.writable("used_mb")[node_id] = 0.0
        if self.persist_dir:
            d = self.persist_dir / f"node_{node_id}"
            for f in d.glob("*"):
                f.unlink()

    def live_nodes(self) -> list[int]:
        return [int(i) for i in self.cluster.live_ids()]

    def _reload(self) -> None:
        for i in range(len(self.nodes)):
            d = self.persist_dir / f"node_{i}"
            for f in d.glob("*"):
                blob = f.read_bytes()
                self._blobs[i][f.name] = blob
                self.cluster.writable("used_mb")[i] += len(blob) / 1e6
