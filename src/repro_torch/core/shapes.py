"""Shared shape-bucket planning and launch-signature census.

The PyTorch port keeps the JAX package's pad planning unchanged, because
the coding path pads the byte axis of every launch through
:func:`ec_block_pad` and the port's chunks, slices and census are held
equal to the reference's:

* **Geometric rungs.**  Pads are exact multiples of 8 up to
  ``GEOMETRIC_FROM``, then grow by ``GROWTH`` per rung, so a quantity
  that grows one step at a time crosses O(log) distinct pads.  Batch
  pads stay powers of two.
* **Hysteresis band.**  A :class:`ShapeBucketer` remembers the last pad
  it issued per axis kind and keeps issuing it while the requested size
  stays within the band (``n <= held`` and ``held <= SHRINK_BAND x``
  the natural rung), so oscillation around a rung boundary reuses one
  shape instead of flapping between two.
* **Launch census.**  Kernel wrappers report the static signature of
  every launch through :func:`record_compile`; :func:`compile_cache_stats`
  counts distinct signatures and calls per kernel (telemetry, and the
  zero-launch checks of the systematic decode fast path).

Pads only ever enlarge a zero-filled region that callers slice off, so
results are invariant to which bucket a call lands in.
"""

from __future__ import annotations

import threading

__all__ = [
    "ShapeBucketer",
    "batch_pad",
    "compile_cache_stats",
    "ec_block_pad",
    "issued_shapes",
    "node_pad",
    "record_compile",
    "reset",
    "start_pad",
]

#: pads are always multiples of this (vector-lane friendly; matches the
#: pre-bucketing ladders so small-cluster shapes are unchanged).
ALIGN = 8

#: largest exact-multiple-of-ALIGN rung; geometric growth above.  Chosen
#: to coincide with ``reliability._AUTO_EXACT_LIMIT`` — below it shapes
#: are small enough that per-8 compiles are cheap and memory is noise.
GEOMETRIC_FROM = 64

#: per-rung growth factor above GEOMETRIC_FROM (each rung costs at most
#: ~25% padding waste, and a cluster doubling in size crosses ~3 rungs).
GROWTH = 1.25

#: a held pad is kept while it is at most this factor above the natural
#: rung for the requested size — i.e. a cluster must shrink below about
#: half the held pad before the bucketer lets the shape shrink.
SHRINK_BAND = 2.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def rung(n: int) -> int:
    """Smallest ladder pad >= ``n`` (multiples of 8, then geometric)."""
    n = max(1, int(n))
    if n <= GEOMETRIC_FROM:
        return max(ALIGN, _round_up(n, ALIGN))
    r = GEOMETRIC_FROM
    while r < n:
        r = _round_up(int(r * GROWTH), ALIGN)
    return r


def pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (batch axes; inherently geometric)."""
    return 1 << max(0, int(n) - 1).bit_length()


class ShapeBucketer:
    """Hysteresis-banded pad planner with a compile-cache census.

    One instance (the module-level default) is shared by every kernel in
    the process so that e.g. the SC and LB kernels agree on the node pad
    for the same cluster.  Thread-safe: the simulator and checkpoint
    plane may place from different threads.
    """

    def __init__(self):
        self._lock = threading.Lock()
        #: kind -> last pad issued (the hysteresis memory).
        self._held: dict[str, int] = {}
        #: kernel name -> set of static signatures seen.
        self._compiled: dict[str, set[tuple]] = {}
        #: kernel name -> total batch calls recorded.
        self._calls: dict[str, int] = {}
        self.queries = 0
        self.band_hits = 0

    # -- pad planning -------------------------------------------------------

    def bucket(self, kind: str, n: int) -> int:
        """Banded pad for axis ``kind``: the natural rung, unless the
        previously issued pad still covers ``n`` within the band."""
        natural = rung(n)
        with self._lock:
            self.queries += 1
            held = self._held.get(kind)
            if held is not None and n <= held and held <= natural * SHRINK_BAND:
                self.band_hits += 1
                return held
            self._held[kind] = natural
            return natural

    # -- compile census -----------------------------------------------------

    def record_compile(self, kernel: str, signature: tuple) -> bool:
        """Note one launch's static signature; True if it is new."""
        with self._lock:
            seen = self._compiled.setdefault(kernel, set())
            self._calls[kernel] = self._calls.get(kernel, 0) + 1
            if signature in seen:
                return False
            seen.add(signature)
            return True

    def issued_shapes(self, kernel: str) -> frozenset:
        with self._lock:
            return frozenset(self._compiled.get(kernel, ()))

    def stats(self) -> dict:
        """Telemetry snapshot: per-kernel compile/call counts plus the
        bucketer's own query/band counters."""
        with self._lock:
            return {
                "queries": self.queries,
                "band_hits": self.band_hits,
                "kernels": {
                    k: {"compiles": len(v), "calls": self._calls.get(k, 0)}
                    for k, v in sorted(self._compiled.items())
                },
            }

    def reset(self) -> None:
        """Forget held pads and the census (tests)."""
        with self._lock:
            self._held.clear()
            self._compiled.clear()
            self._calls.clear()
            self.queries = 0
            self.band_hits = 0


#: process-wide default bucketer shared by all kernels.
DEFAULT = ShapeBucketer()


def node_pad(L: int) -> int:
    """Padded node-axis length for ``L`` live nodes (shared by every
    kernel so one cluster size maps to one compiled extent)."""
    return DEFAULT.bucket("nodes", L)


def batch_pad(B: int) -> int:
    """Padded batch-axis length (power of two; at most 2x waste and at
    most log2(MAX_SCORING_GROUP) distinct shapes)."""
    return pow2(B)


def start_pad(s: int) -> int:
    """Padded start-axis length for the SC kernel's window starts."""
    return DEFAULT.bucket("sc_starts", s)


def ec_block_pad(n_blocks: int) -> int:
    """Padded byte-block count for the EC coding kernels' byte axis.

    The bit-matmul kernels are compiled per (bit-matrix shape, byte-block
    count); bucketing the block count through the shared rungs means a
    checkpoint whose cohort sizes churn step to step reuses one compiled
    extent per (K, P, bucket) instead of recompiling per distinct byte
    length (the padded tail columns are zeros and are sliced off).

    Below ALIGN blocks the ladder is powers of two instead of the
    multiple-of-8 floor: a small group's chunks are often 1-4 blocks
    wide, and padding them all to 8 would waste up to 8x compute on the
    per-item path for no compile-count benefit (1/2/4/8 is still only
    four shapes)."""
    n = max(1, int(n_blocks))
    if n < ALIGN:
        return pow2(n)
    return DEFAULT.bucket("ec_blocks", n)


def record_compile(kernel: str, signature: tuple) -> bool:
    return DEFAULT.record_compile(kernel, signature)


def issued_shapes(kernel: str) -> frozenset:
    return DEFAULT.issued_shapes(kernel)


def compile_cache_stats() -> dict:
    return DEFAULT.stats()


def reset() -> None:
    DEFAULT.reset()
