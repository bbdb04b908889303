"""Public wrappers over the coding kernel.

``encode_chunks`` / ``decode_chunks`` operate on (K, B) byte matrices;
``encode_chunks_many`` / ``decode_chunks_many`` batch whole cohorts of
same-matrix codings into ONE kernel launch; ``repro_torch.ec.codec``
builds the item-level API (split/pad/join) on top of these.  Everything
is uint8 tensors in, uint8 tensors out, on the input's device,
byte-identical to the JAX package's ``repro.kernels.ops``:

* **Cached coding matrices.**  The host-side Cauchy / decode matrices
  and their GF(2) bit-matrix expansions are pure functions of ``(k, p)``
  (encode) and ``(k, p, surviving_rows)`` (decode), memoized in LRU
  caches; each entry keeps one uint8 copy of its bit matrix per device.
  ``matrix_cache_stats`` exposes build/hit counters.
* **Multi-item launches.**  The code is linear per byte column:
  ``M @ [D1 | D2 | ...] == [M@D1 | M@D2 | ...]``, so a cohort of groups
  sharing a matrix concatenates along the byte axis into one launch.
* **Shape buckets.**  The byte axis is padded to a bucketed block count
  (:func:`repro_torch.core.shapes.ec_block_pad`) exactly as the
  reference pads it, and every launch records its signature in the
  shared census (``compile_cache_stats``).

Dispatch is one rule: a CUDA tensor goes to the Hopper kernel, a CPU
tensor to its plain version (both through
:func:`repro_torch.kernels.rs_bitmatmul.gf_bitmatmul`), and
``use_kernel=False`` to the GF-table oracle.  Inputs that are not
tensors are placed on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import functools
import threading as _threading

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import shapes as _shapes
from repro_torch.ec import gf256
from . import ref as _ref
from .rs_bitmatmul import gf_bitmatmul

__all__ = [
    "encode_chunks",
    "decode_chunks",
    "encode_chunks_many",
    "decode_chunks_many",
    "encode_chunks_ref",
    "decode_chunks_ref",
    "launch_stats",
    "reset_launch_stats",
    "matrix_cache_stats",
    "reset_matrix_caches",
    "DEFAULT_BLOCK_BYTES",
    "MATRIX_CACHE_SIZE",
]

#: byte-axis block the launches are padded to (the reference kernel's
#: default tile; the CUDA kernel takes any width, but the padding keeps
#: the census and the slicing equal to the reference's).
DEFAULT_BLOCK_BYTES = 2048

#: LRU bound on the decode-matrix cache (erasure patterns are
#: combinatorial, so the decode cache must evict).
MATRIX_CACHE_SIZE = 256

#: kernel name under which every coding launch records its signature.
CENSUS_KERNEL = "rs_bitmatmul"

#: build counters behind the LRU caches.  ``lru_cache`` does not hold its
#: lock while the builder runs, so concurrent misses both build: every
#: update goes through :func:`_note_build` under ``_builds_lock``.
_MATRIX_BUILDS = {"encode": 0, "decode": 0}
_builds_lock = _threading.Lock()

#: CUDA kernel launches by purpose (CPU calls do not count).
_LAUNCHES = {"encode": 0, "decode": 0}
_launch_lock = _threading.Lock()


def _note_build(kind: str) -> None:
    with _builds_lock:
        _MATRIX_BUILDS[kind] += 1


class _BitMatrix:
    """One coding matrix's (8R, 8K) uint8 bit matrix, with a copy per
    device made on first use."""

    __slots__ = ("host", "_on", "_lock")

    def __init__(self, host: np.ndarray):
        self.host = torch.from_numpy(host.astype(np.uint8))
        self._on: dict[torch.device, torch.Tensor] = {}
        self._lock = _threading.Lock()

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.host.shape)

    def on(self, device: torch.device) -> torch.Tensor:
        if device.type == "cpu":
            return self.host
        with self._lock:
            t = self._on.get(device)
            if t is None:
                t = self.host.to(device)
                self._on[device] = t
            return t


@functools.lru_cache(maxsize=MATRIX_CACHE_SIZE)
def _encode_matrices(k: int, p: int):
    """(Cauchy GF matrix, bit matrix) for encode — cached.  The numpy
    matrix is read-only: cached arrays are shared."""
    _note_build("encode")
    cauchy = gf256.cauchy_matrix(p, k)
    cauchy.setflags(write=False)
    return cauchy, _BitMatrix(gf256.gf_to_bitmatrix(cauchy))


@functools.lru_cache(maxsize=MATRIX_CACHE_SIZE)
def _decode_matrices(k: int, p: int, rows: tuple):
    """(decode GF matrix, bit matrix) for one erasure pattern — cached so
    repeated decodes of the same pattern pay the Gauss-Jordan inversion
    exactly once."""
    _note_build("decode")
    dec = gf256.decode_matrix(k, p, np.asarray(rows, dtype=np.int64))
    dec.setflags(write=False)
    return dec, _BitMatrix(gf256.gf_to_bitmatrix(dec))


def matrix_cache_stats() -> dict:
    """Telemetry: matrix builds vs cache hits (see MATRIX_CACHE_SIZE)."""
    enc, dec = _encode_matrices.cache_info(), _decode_matrices.cache_info()
    with _builds_lock:
        encode_builds = _MATRIX_BUILDS["encode"]
        decode_builds = _MATRIX_BUILDS["decode"]
    return {
        "encode_builds": encode_builds,
        "decode_builds": decode_builds,
        "encode_cache": {"hits": enc.hits, "misses": enc.misses,
                         "size": enc.currsize, "maxsize": enc.maxsize},
        "decode_cache": {"hits": dec.hits, "misses": dec.misses,
                         "size": dec.currsize, "maxsize": dec.maxsize},
    }


def reset_matrix_caches() -> None:
    """Clear the matrix caches and build counters (tests)."""
    _encode_matrices.cache_clear()
    _decode_matrices.cache_clear()
    with _builds_lock:
        _MATRIX_BUILDS["encode"] = 0
        _MATRIX_BUILDS["decode"] = 0


def launch_stats() -> dict:
    """CUDA kernel launches made for encodes and for decodes."""
    with _launch_lock:
        return dict(_LAUNCHES)


def reset_launch_stats() -> None:
    with _launch_lock:
        _LAUNCHES["encode"] = 0
        _LAUNCHES["decode"] = 0


def _rows_key(surviving_rows) -> tuple:
    return tuple(int(r) for r in np.asarray(surviving_rows).reshape(-1))


def _as_u8(x, device=None) -> torch.Tensor:
    """A (K, B) uint8 tensor: tensors stay on their device unless
    ``device`` is given; anything else is placed on ``device``."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"coding input must be uint8, got {x.dtype}")
        return x if device is None else x.to(resolve_device(device))
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint8))
    if not arr.flags.writeable:  # e.g. np.frombuffer over fabric bytes
        arr = arr.copy()
    return torch.from_numpy(arr).to(resolve_device(device))


# -- one launch: pad -> census -> kernel --------------------------------------


def _pad_to_bucket(data: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    """Pad the byte axis to a *bucketed* multiple of ``block`` (zeros)."""
    k, b = data.shape
    blocks = -(-b // block)  # ceil; at least 1 block
    target = _shapes.ec_block_pad(max(1, blocks)) * block
    if target != b:
        padded = data.new_zeros((k, target))
        padded[:, :b] = data
        data = padded
    return data, b


def _bitmatmul(
    bitm: _BitMatrix, data: torch.Tensor, *, block_bytes: int, kind: str
) -> torch.Tensor:
    """One coding launch on a block-aligned (K, B) byte matrix."""
    r8, k8 = bitm.shape
    _shapes.record_compile(
        CENSUS_KERNEL,
        (r8, k8, data.shape[1] // block_bytes, block_bytes, data.device.type),
    )
    out = gf_bitmatmul(bitm.on(data.device), data.contiguous())
    if data.device.type == "cuda":
        with _launch_lock:
            _LAUNCHES[kind] += 1
    return out


# -- per-item API (the bit-for-bit oracle for the _many paths) ---------------


def encode_chunks(
    data_chunks,
    p: int,
    *,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
    use_kernel: bool = True,
    device=None,
) -> torch.Tensor:
    """Parity chunks (P, B) for systematic Cauchy-RS over (K, B) data."""
    data = _as_u8(data_chunks, device)
    k, b = data.shape
    if b == 0:  # empty item: a well-defined empty parity, no kernel call
        return data.new_zeros((p, 0))
    cauchy, bitm = _encode_matrices(k, p)
    if not use_kernel:
        return _ref.encode_ref(data, cauchy)
    padded, b = _pad_to_bucket(data, block_bytes)
    return _bitmatmul(bitm, padded, block_bytes=block_bytes, kind="encode")[:, :b]


def decode_chunks(
    surviving_chunks,
    surviving_rows,
    k: int,
    p: int,
    *,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
    use_kernel: bool = True,
    device=None,
) -> torch.Tensor:
    """Reconstruct the K data chunks from any K surviving chunk rows.

    ``surviving_rows``: indices into the N=K+P rows matching the order of
    ``surviving_chunks`` (K, B)."""
    surv = _as_u8(surviving_chunks, device)
    dec, bitm = _decode_matrices(k, p, _rows_key(surviving_rows))
    if surv.shape[1] == 0:
        return surv.new_zeros((k, 0))
    if not use_kernel:
        return _ref.decode_ref(surv, dec)
    padded, b = _pad_to_bucket(surv, block_bytes)
    return _bitmatmul(bitm, padded, block_bytes=block_bytes, kind="decode")[:, :b]


# -- multi-item API: one launch per cohort -----------------------------------


def _matmul_concat(
    mats: list[torch.Tensor],
    gf_matrix: np.ndarray,
    bitm: _BitMatrix,
    out_rows: int,
    *,
    block_bytes: int,
    use_kernel: bool,
    kind: str,
) -> list[torch.Tensor]:
    """Apply one coding matrix to many (K, B_i) matrices in one launch.
    Returns (out_rows, B_i) views of one output tensor."""
    devices = {m.device for m in mats}
    if len(devices) != 1:
        raise ValueError(f"cohort spans devices {sorted(map(str, devices))}")
    widths = [m.shape[1] for m in mats]
    outs: list = [None] * len(mats)
    live = [i for i, w in enumerate(widths) if w > 0]
    for i, w in enumerate(widths):
        if w == 0:
            outs[i] = mats[i].new_zeros((out_rows, 0))
    if live:
        cat = torch.cat([mats[i] for i in live], dim=1)
        total = cat.shape[1]
        if use_kernel:
            padded, _ = _pad_to_bucket(cat, block_bytes)
            out = _bitmatmul(bitm, padded, block_bytes=block_bytes, kind=kind)
            out = out[:, :total]
        else:
            out = _ref.gf_matmul_ref(gf_matrix, cat)
        off = 0
        for i in live:
            outs[i] = out[:, off : off + widths[i]]
            off += widths[i]
    return outs


def encode_chunks_many(
    data_chunks_list,
    p: int,
    *,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
    use_kernel: bool = True,
    device=None,
) -> list[torch.Tensor]:
    """Parity for a cohort of (K, B_i) data matrices sharing K and P.

    The cohort is stacked along the byte axis into ONE kernel launch
    (byte lengths may differ — the code is columnwise); results are
    byte-identical to per-item :func:`encode_chunks`.  Returns a list of
    (P, B_i) tensors in input order."""
    mats = [_as_u8(d, device) for d in data_chunks_list]
    if not mats:
        return []
    k = mats[0].shape[0]
    for m in mats:
        if m.shape[0] != k:
            raise ValueError(
                f"cohort mixes K: {m.shape[0]} vs {k} (partition by (K, P) "
                "first — see repro_torch.ec.codec.plan_cohorts)"
            )
    cauchy, bitm = _encode_matrices(k, p)
    return _matmul_concat(
        mats, cauchy, bitm, p,
        block_bytes=block_bytes, use_kernel=use_kernel, kind="encode",
    )


def decode_chunks_many(
    surviving_chunks_list,
    surviving_rows_list,
    k: int,
    p: int,
    *,
    block_bytes: int = DEFAULT_BLOCK_BYTES,
    use_kernel: bool = True,
    device=None,
) -> list[torch.Tensor]:
    """Reconstruct many items sharing (K, P): one launch per distinct
    erasure pattern (the decode matrix depends on the surviving rows).

    Returns a list of (K, B_i) tensors in input order."""
    mats = [_as_u8(c, device) for c in surviving_chunks_list]
    if len(mats) != len(surviving_rows_list):
        raise ValueError("chunks/rows length mismatch")
    by_pattern: dict[tuple, list[int]] = {}
    for i, rows in enumerate(surviving_rows_list):
        by_pattern.setdefault(_rows_key(rows), []).append(i)
    outs: list = [None] * len(mats)
    for rows_key, idxs in by_pattern.items():
        dec, bitm = _decode_matrices(k, p, rows_key)
        got = _matmul_concat(
            [mats[i] for i in idxs], dec, bitm, k,
            block_bytes=block_bytes, use_kernel=use_kernel, kind="decode",
        )
        for i, out in zip(idxs, got):
            outs[i] = out
    return outs


def encode_chunks_ref(data_chunks, p: int, *, device=None) -> torch.Tensor:
    """Oracle path (log/exp tables)."""
    return encode_chunks(data_chunks, p, use_kernel=False, device=device)


def decode_chunks_ref(
    surviving_chunks, surviving_rows, k: int, p: int, *, device=None
) -> torch.Tensor:
    return decode_chunks(
        surviving_chunks, surviving_rows, k, p, use_kernel=False, device=device
    )
