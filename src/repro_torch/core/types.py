"""Core datatypes shared by the D-Rex algorithms, simulator and checkpointer.

Sizes are in MB (the paper's unit); times in seconds; bandwidths in MB/s;
``delta_t`` retention windows in days (converted to year-fractions at the
reliability boundary, matching Eq. 1's convention).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

DAYS_PER_YEAR = 365.25


@dataclasses.dataclass
class StorageNode:
    """A heterogeneous storage node (paper Table 1 'known' quantities)."""

    node_id: int
    capacity_mb: float                 # size(S_i)
    write_bw: float                    # B_w(S_i), MB/s
    read_bw: float                     # B_r(S_i), MB/s
    annual_failure_rate: float         # lambda_rate of Eq. (1)
    name: str = ""
    used_mb: float = 0.0
    failed: bool = False
    rack: int = 0                      # failure domain: rack id
    zone: int = 0                      # failure domain: zone id (racks nest in zones)

    @property
    def free_mb(self) -> float:        # F(S_i, t)
        return self.capacity_mb - self.used_mb

    def pr_failure(self, delta_t_days: float) -> float:
        from .reliability import pr_failure

        return float(pr_failure(self.annual_failure_rate, delta_t_days / DAYS_PER_YEAR))

    def can_fit(self, chunk_mb: float) -> bool:
        return not self.failed and self.free_mb >= chunk_mb


@dataclasses.dataclass(frozen=True)
class DataItem:
    """A store request (paper Table 1, per-item knowns)."""

    item_id: int
    size_mb: float                     # size(d)
    arrival_time: float                # submission timestamp (seconds)
    delta_t_days: float                # retention Delta t_d
    reliability_target: float          # RT(d) in (0, 1)


@dataclasses.dataclass(frozen=True)
class Placement:
    """An algorithm's decision for one item: (K, P, M) of Problem 1."""

    k: int                             # data chunks K_d
    p: int                             # parity chunks P_d
    node_ids: tuple[int, ...]          # mapping M_d, |M| == k + p

    @property
    def n(self) -> int:
        return self.k + self.p

    def chunk_size_mb(self, size_mb: float) -> float:
        # ceil at MB-fraction granularity is not meaningful for floats;
        # the paper's ceil(size/K) is over MB — we keep exact division,
        # consistent for all algorithms being compared.
        return size_mb / self.k

    def __post_init__(self):
        if self.k < 1 or self.p < 0:
            raise ValueError(f"invalid EC parameters K={self.k} P={self.p}")
        if len(self.node_ids) != self.k + self.p:
            raise ValueError(
                f"mapping has {len(self.node_ids)} nodes, need K+P={self.k + self.p}"
            )
        if len(set(self.node_ids)) != len(self.node_ids):
            raise ValueError("mapping nodes must be distinct")


@dataclasses.dataclass
class ClusterView:
    """Mutable view of the cluster the scheduler sees at decision time.

    Thin wrapper over parallel numpy arrays so the algorithms can operate
    vectorized; kept in sync by the simulator/checkpoint manager.
    """

    capacity_mb: np.ndarray
    used_mb: np.ndarray
    write_bw: np.ndarray
    read_bw: np.ndarray
    afr: np.ndarray
    alive: np.ndarray                  # bool mask
    #: failure-domain topology: rack/zone id per node.  Optional at
    #: construction (older call sites build the view positionally from
    #: the six flat arrays); normalized to int64 zeros in __post_init__
    #: so a topology-free cluster is "one rack in one zone".
    rack: Optional[np.ndarray] = None
    zone: Optional[np.ndarray] = None

    def __post_init__(self):
        n = int(self.capacity_mb.shape[0])
        if self.rack is None:
            self.rack = np.zeros(n, dtype=np.int64)
        else:
            self.rack = np.asarray(self.rack, dtype=np.int64)
        if self.zone is None:
            self.zone = np.zeros(n, dtype=np.int64)
        else:
            self.zone = np.asarray(self.zone, dtype=np.int64)

    @classmethod
    def from_nodes(cls, nodes: Sequence[StorageNode]) -> "ClusterView":
        return cls(
            capacity_mb=np.array([n.capacity_mb for n in nodes], dtype=np.float64),
            used_mb=np.array([n.used_mb for n in nodes], dtype=np.float64),
            write_bw=np.array([n.write_bw for n in nodes], dtype=np.float64),
            read_bw=np.array([n.read_bw for n in nodes], dtype=np.float64),
            afr=np.array([n.annual_failure_rate for n in nodes], dtype=np.float64),
            alive=np.array([not n.failed for n in nodes], dtype=bool),
            rack=np.array([getattr(n, "rack", 0) for n in nodes], dtype=np.int64),
            zone=np.array([getattr(n, "zone", 0) for n in nodes], dtype=np.int64),
        )

    #: fields shared (and write-protected) by :meth:`share_snapshot`.
    _ARRAY_FIELDS = (
        "capacity_mb", "used_mb", "write_bw", "read_bw",
        "afr", "alive", "rack", "zone",
    )

    #: bound on cached ``fail_probs`` retention windows per view.
    _MAX_FP_ANCHORS = 16

    @property
    def n_nodes(self) -> int:
        return int(self.capacity_mb.shape[0])

    @property
    def free_mb(self) -> np.ndarray:
        return self.capacity_mb - self.used_mb

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.alive)[0]

    def fail_probs(self, delta_t_days: float) -> np.ndarray:
        """Per-node failure probabilities for one retention window.

        Cached per ``delta_t`` against an AFR-content mirror, so repeated
        decisions stop re-exponentiating all N rates: when the AFRs are
        untouched the cached vector is returned; when some entries
        changed (or the view grew by a join) only the touched tail/
        entries are recomputed — ``pr_failure`` is elementwise, so the
        sliced recompute is bit-equal to the full-array one.  Returned
        arrays are write-protected shared state; callers must copy
        before mutating."""
        from .reliability import pr_failure

        key = float(delta_t_days)
        cache: dict = self.__dict__.setdefault("_fp_cache", {})
        mirror: Optional[np.ndarray] = self.__dict__.get("_fp_afr")
        afr = self.afr
        if mirror is None or not (
            mirror.shape == afr.shape and np.array_equal(mirror, afr)
        ):
            self._fp_refresh(mirror, cache)
        fp = cache.get(key)
        if fp is None:
            if len(cache) >= self._MAX_FP_ANCHORS:
                cache.clear()
            fp = pr_failure(afr, key / DAYS_PER_YEAR)
            fp = np.asarray(fp, dtype=np.float64)
            fp.setflags(write=False)
            cache[key] = fp
        return fp

    def _fp_refresh(self, mirror: Optional[np.ndarray], cache: dict) -> None:
        """Touched-entry refresh of every cached fail-prob vector after
        an AFR content change (edit or elastic join)."""
        from .reliability import pr_failure

        afr = self.afr
        n = afr.shape[0]
        if mirror is None or n < mirror.shape[0]:
            cache.clear()  # shrink or first use: no prefix to reuse
        else:
            old = mirror.shape[0]
            changed = np.nonzero(mirror != afr[:old])[0]
            for key in list(cache):
                vec = cache[key]
                new = np.empty(n, dtype=np.float64)
                new[:old] = vec
                if changed.size:
                    new[changed] = pr_failure(afr[changed], key / DAYS_PER_YEAR)
                if n > old:
                    new[old:] = pr_failure(afr[old:], key / DAYS_PER_YEAR)
                new.setflags(write=False)
                cache[key] = new
        self.__dict__["_fp_afr"] = afr.copy()

    # -- copy-on-write mutation plumbing ------------------------------------

    def writable(self, name: str) -> np.ndarray:
        """The named field array, un-shared for writing.

        After :meth:`share_snapshot` the view's arrays are write-
        protected (they are shared with the published snapshot); the
        first mutation of a field copies it — the snapshot keeps the
        original — and every mutator below routes through here.  Cost is
        one flag check per mutation and one O(N) copy per field per
        snapshot *only if the field actually changes*."""
        arr = getattr(self, name)
        if not arr.flags.writeable:
            arr = arr.copy()
            setattr(self, name, arr)
            bufs = self.__dict__.get("_growth_bufs")
            if bufs:  # the old growth buffer now backs the snapshot
                bufs.pop(name, None)
        return arr

    def share_snapshot(self) -> "ClusterView":
        """Read-only snapshot sharing this view's buffers (copy-on-write).

        O(1): no array is copied at publish time.  Both the snapshot and
        the live view's arrays become write-protected; the live view
        un-shares a field lazily on its next mutation (see
        :meth:`writable`), so a snapshot costs one copy per field that
        actually changes afterwards — not eight O(N) copies per window.
        Direct out-of-band writes to a shared array raise ``ValueError``
        (loud, instead of silently corrupting a published epoch)."""
        for name in self._ARRAY_FIELDS:
            getattr(self, name).setflags(write=False)
        return ClusterView(
            self.capacity_mb, self.used_mb, self.write_bw, self.read_bw,
            self.afr, self.alive, self.rack, self.zone,
        )

    # -- mutators ------------------------------------------------------------

    def commit(self, placement: Placement, chunk_mb: float) -> None:
        ids = np.asarray(placement.node_ids)
        self.writable("used_mb")[ids] += chunk_mb

    def charge(self, node_ids: Sequence[int], chunk_mb: float) -> None:
        """Reserve ``chunk_mb`` on each node (repair reservations) —
        the exact array op :meth:`commit` performs."""
        self.writable("used_mb")[np.asarray(list(node_ids))] += chunk_mb

    def release(self, node_ids: Sequence[int], chunk_mb: float) -> None:
        ids = np.asarray(list(node_ids))
        used = self.writable("used_mb")
        used[ids] -= chunk_mb
        np.maximum(used, 0.0, out=used)

    def fail_node(self, node_id: int) -> None:
        self.writable("alive")[node_id] = False

    def fail_stop(self, node_id: int) -> None:
        """Fail-stop: the node dies and its bytes are permanently lost
        (the churn paths' canonical failure op)."""
        self.writable("alive")[node_id] = False
        self.writable("used_mb")[node_id] = 0.0

    def heal_node(self, node_id: int) -> None:
        """Fail-stop recovery: the node returns alive and *empty* (its
        chunks were permanently lost when it failed)."""
        self.writable("alive")[node_id] = True
        self.writable("used_mb")[node_id] = 0.0

    def restore(self, used_mb: np.ndarray, alive: np.ndarray) -> None:
        """Overwrite occupancy/liveness from a snapshot (rollback)."""
        self.writable("used_mb")[:] = used_mb
        self.writable("alive")[:] = alive

    def nodes_in_rack(self, rack_id: int) -> np.ndarray:
        return np.nonzero(self.rack == rack_id)[0]

    def nodes_in_zone(self, zone_id: int) -> np.ndarray:
        return np.nonzero(self.zone == zone_id)[0]

    def add_node(self, node: StorageNode) -> int:
        """Append a node to the view (elastic join) and return its id.

        Views index nodes by position, so a joining node's id is always
        the previous ``n_nodes`` regardless of the ``node_id`` recorded
        on the :class:`StorageNode`.

        Growth is amortized O(1): each per-node field is a length-n view
        over a geometrically doubled backing buffer, so long
        ``node_join_schedule``s don't pay np.append's O(n) copy per join.
        External semantics are unchanged — shape, dtype and values of the
        exposed arrays match the old append-per-call implementation
        exactly, and any rebinding invalidates stale mirrors by shape
        (see ``core.incremental``'s trackers)."""
        nid = self.n_nodes
        bufs = self.__dict__.get("_growth_bufs")
        if bufs is None:
            bufs = {}
            self.__dict__["_growth_bufs"] = bufs
        for name, value in (
            ("capacity_mb", float(node.capacity_mb)),
            ("used_mb", float(node.used_mb)),
            ("write_bw", float(node.write_bw)),
            ("read_bw", float(node.read_bw)),
            ("afr", float(node.annual_failure_rate)),
            ("alive", not node.failed),
            ("rack", int(getattr(node, "rack", 0))),
            ("zone", int(getattr(node, "zone", 0))),
        ):
            arr = getattr(self, name)
            buf = bufs.get(name)
            # Only reuse a buffer the current field array is a prefix view
            # of — anything else (fresh view, external rebinding, buffer
            # full, or an array shared read-only with a snapshot, whose
            # backing buffer must not be written through) reallocates
            # with doubled headroom.
            if (
                buf is None
                or arr.base is not buf
                or buf.shape[0] <= nid
                or not arr.flags.writeable
            ):
                buf = np.empty(max(4, 2 * (nid + 1)), dtype=arr.dtype)
                buf[:nid] = arr
                bufs[name] = buf
            buf[nid] = value
            setattr(self, name, buf[: nid + 1])
        return nid

    def copy(self) -> "ClusterView":
        return ClusterView(
            self.capacity_mb.copy(), self.used_mb.copy(), self.write_bw.copy(),
            self.read_bw.copy(), self.afr.copy(), self.alive.copy(),
            self.rack.copy(), self.zone.copy(),
        )


@dataclasses.dataclass(frozen=True)
class ECTimeModel:
    """Linear encode/decode cost model (paper §4.4: linear regression over
    measurements across sizes and (K, P); functional form follows the IDA
    complexity analysis the paper's Fig. 1 is based on [28]).

    Reed-Solomon work: each of the P parity chunks is a K-term GF dot
    product over chunk bytes -> encode work = P * size multiply-adds; a
    worst-case decode re-applies a KxK matrix -> K * size multiply-adds.
    Hence (matching Fig. 1: encode ~flat in K at fixed P, decode linear
    in K):

        T_encode(N, K, size) = e0 + e_byte*size + e_mult*(N-K)*size
        T_decode(K, size)    = d0 + d_byte*size + d_mult*K*size

    Replication (K == 1) has no coding math (paper §3.1:
    T_encode = T_decode = 0); only the constant dispatch cost remains.

    Defaults are calibrated against our own GF(2^8) codec measurements
    (benchmarks/fig1_encode_breakdown.py recalibrates; see EXPERIMENTS.md).
    """

    e0: float = 1e-3
    e_byte: float = 2.0e-4             # s per MB striped (memcpy-level)
    e_mult: float = 1.2e-3             # s per parity-MB GF dot-product
    d0: float = 1e-3
    d_byte: float = 2.0e-4
    d_mult: float = 1.2e-3             # s per (K * MB) GF dot-product

    def t_encode(self, n: int, k: int, size_mb: float) -> float:
        if k == 1:
            return self.e0
        return self.e0 + self.e_byte * size_mb + self.e_mult * (n - k) * size_mb

    def t_decode(self, k: int, size_mb: float) -> float:
        if k == 1:
            return self.d0
        return self.d0 + self.d_byte * size_mb + self.d_mult * k * size_mb

    # Elementwise variants over parallel (n, k) arrays — the ONLY other
    # place the cost model's functional form lives; keep in lockstep with
    # the scalar methods above (D-Rex SC scores all candidate windows
    # through these).

    def t_encode_many(self, n, k, size_mb: float):
        n = np.asarray(n)
        k = np.asarray(k)
        return np.where(
            k == 1,
            self.e0,
            self.e0 + self.e_byte * size_mb + self.e_mult * (n - k) * size_mb,
        )

    def t_decode_many(self, k, size_mb: float):
        k = np.asarray(k)
        return np.where(
            k == 1,
            self.d0,
            self.d0 + self.d_byte * size_mb + self.d_mult * k * size_mb,
        )


@dataclasses.dataclass(frozen=True)
class PlacementConstraints:
    """Failure-domain constraints on a mapping (rack/zone topology).

    A mapping satisfies the constraints when no more than ``max_per_rack``
    of its chunks share a rack, no more than ``max_per_zone`` share a
    zone, and the mapping spans at least ``min(min_racks, n)`` distinct
    racks and ``min(min_zones, n)`` distinct zones (the ``min`` keeps
    small mappings satisfiable: a 2-chunk mapping cannot span 3 racks).

    ``None`` caps are unlimited; the all-default instance is
    :attr:`unconstrained` and must behave exactly like passing no
    constraints at all.  With ``max_per_rack <= P`` a single rack event
    destroys at most P chunks of any conforming item, which keeps the
    item decodable — the durability contract the invariant harness pins.
    """

    max_per_rack: Optional[int] = None
    max_per_zone: Optional[int] = None
    min_racks: int = 1
    min_zones: int = 1

    def __post_init__(self):
        for label, v in (("max_per_rack", self.max_per_rack),
                         ("max_per_zone", self.max_per_zone)):
            if v is not None and v < 1:
                raise ValueError(f"{label} must be >= 1 or None, got {v}")
        if self.min_racks < 1 or self.min_zones < 1:
            raise ValueError("min_racks/min_zones must be >= 1")

    @property
    def unconstrained(self) -> bool:
        return (
            self.max_per_rack is None
            and self.max_per_zone is None
            and self.min_racks <= 1
            and self.min_zones <= 1
        )

    def satisfied_by(
        self, node_ids: Sequence[int], rack: np.ndarray, zone: np.ndarray
    ) -> bool:
        """Whether a mapping meets caps and spread under this topology."""
        ids = np.asarray(list(node_ids), dtype=np.int64)
        n = ids.shape[0]
        if n == 0:
            return True
        racks = rack[ids]
        zones = zone[ids]
        if self.max_per_rack is not None:
            if np.bincount(racks - racks.min()).max() > self.max_per_rack:
                return False
        if self.max_per_zone is not None:
            if np.bincount(zones - zones.min()).max() > self.max_per_zone:
                return False
        if np.unique(racks).shape[0] < min(self.min_racks, n):
            return False
        if np.unique(zones).shape[0] < min(self.min_zones, n):
            return False
        return True


@dataclasses.dataclass(frozen=True)
class Decision:
    """Result of one scheduling call."""

    placement: Optional[Placement]     # None => write failed
    # Diagnostics for benchmarks / EXPERIMENTS.md:
    candidates_considered: int = 0
    reason: str = ""
    #: dependency window for batched rescoring: the node ids whose free
    #: space this decision's score depended on, or ``None`` when the
    #: score depends on cluster-global state (the conservative default —
    #: any commit invalidates it).  Only meaningful from schedulers that
    #: declare the ``windowed_scoring`` capability; consumed by
    #: ``PlacementEngine._place_many_batched``.
    window: Optional[tuple[int, ...]] = None
