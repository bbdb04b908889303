"""Hopper kernels for ``jax.random``'s draws: threefry2x32 normal fills and
Gumbel-max sampling, in CUDA.

Replaces what XLA compiles for the JAX package's two seeded draws (not
Pallas kernels): ``jax.random.normal`` in ``dense_init``
(``src/repro/models/layers.py:32``), which ``init_params`` calls once per
leaf, and ``jax.random.categorical`` in the serving engine's ``_sample``
(``src/repro/serve/engine.py:51``).  The source is ``csrc/threefry.cu``;
its draws equal ``jax.random``'s bit for bit (threefry2x32 in the
partitionable scheme, then XLA's CPU ``log1p``/``erf_inv``/``log``
expansions with the same fused multiply-adds), and equal the plain
versions :func:`repro_torch.kernels.ref.threefry_normal_ref` and
:func:`repro_torch.kernels.ref.gumbel_argmax_ref`.

**What bounds it.**  Operations.  A normal draw costs
:data:`NORMAL_INT_OPS` int32 operations (the hash and the uniform's bits) and
:data:`NORMAL_F32_SHARED` f32 operations plus those of its ``log1p``
branch, and writes 2 bytes (bf16) or 4 (f32): Qwen3-8B's embed leaf,
151,936 x 4,096 = 622 M draws, is ~1.24 GB of bf16 (0.37 ms at 3.35
TB/s) but ~2.6 ms of int32 work on 132 SMs x 64 INT32 lanes.  A Gumbel-max
row costs the hash and two ``log``s a vocabulary entry.

**What the design does about it.**  Nothing leaves registers but the
output: one thread a draw in a grid-stride loop, one grid row a key of
the leaf's key table (a stacked leaf is one launch), the cast to bf16
fused into the store.  Gumbel-max fills the card at any batch: a (slices,
rows) grid of blocks that each take :data:`GUMBEL_SLICE` entries of one
row (at a decode batch of 4: 256 blocks over 65,536 entries a row, 596
over 151,936, on 132 SMs) and reduce them in shuffles and shared memory
into a (rows, slices) scratch buffer, then a warp a row reduces the
slices into the token (launched as a programmatic dependent of the first
pass, so its launch overlaps it).  The noise is never written.

**Build.**  ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside
this file (listed in ``.gitignore``; :mod:`repro_torch.kernels.nvcc`),
loaded with ``ctypes``.

**Dispatch.**  A CUDA output launches the kernel or raises; the CPU takes
the plain versions.  Nothing falls back.  ``launches`` counts kernel
launches by kernel name (CPU calls do not count).
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np
import torch

from . import nvcc as _nvcc
from . import ref as _ref

__all__ = [
    "threefry_normal",
    "gumbel_argmax",
    "build",
    "launches",
    "reset_launches",
    "normal_bound_s",
    "gumbel_bound_s",
    "GUMBEL_SLICE",
    "SOURCE",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "threefry.cu"

#: kernel launches since import or the last :func:`reset_launches`; a
#: ``gumbel_argmax`` call counts one, though it runs two passes.
launches = {"threefry_normal": 0, "gumbel_argmax": 0}
#: vocabulary entries a ``gumbel_argmax`` pass-1 block takes (``kSlice`` in
#: csrc/threefry.cu).
GUMBEL_SLICE = 1024

# Operations a normal draw needs, counted from csrc/threefry.cu as the least
# the hash can take.  int32: 20 rounds of add, funnel shift and xor (60); the
# key injections into x1 (the first and 5 more, each one add of a per-thread
# constant, k + i); the 5th injection into x0 (the other four, and the first,
# fold into the next round's add as one three-input add); bits1 ^ bits2; the
# uniform's shift and or.  The third key word and the k + i constants are
# computed once a thread, and the counter's hi/lo words are the halves of its
# 64-bit index, so neither is counted a draw.  f32, on every path: the
# uniform (add, fma, max), -u*u, the erf_inv branch test, its 9-term Horner
# chain with the shift of w (10), the |u| == 1 test and select, the
# multiplies by u, sqrt(2) and std, the cast.  The log1p branch adds
# LOG1P_SMALL_OPS below sqrt(2) - 1 (16 fmas, a division counted as one,
# 4 mul/add, the test) and LOG1P_LARGE_OPS above it (the add of 1 and
# XLA's log: 3 int32-style bit ops counted as f32 work, 17 multiply/add/fma
# and 6 selects and tests).
NORMAL_INT_OPS = 20 * 3 + 1 + 5 + 1 + 1 + 2
NORMAL_F32_SHARED = 3 + 1 + 1 + 10 + 2 + 3 + 1
LOG1P_SMALL_OPS = 16 + 1 + 4 + 1
LOG1P_LARGE_OPS = 1 + 3 + 17 + 6
#: a Gumbel-max element: the hash as above, the uniform (add, max), two of
#: XLA's logs (LOG_OPS each: 3 bit ops, 17 multiply/add/fma, 6 selects and
#: tests), two negations, the add of the logit and the argmax's compare.
LOG_OPS = 3 + 17 + 6
GUMBEL_F32_OPS = 2 + 2 * LOG_OPS + 2 + 1 + 2
#: the int32 and f32 lane rates of one H100 SXM at its 1.98 GHz boost clock:
#: 132 SMs x 64 INT32 lanes, and 132 x 128 FP32 lanes (one op a lane a cycle;
#: 67 TFLOP/s counts an fma as two).
INT32_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 132 * 128 * 1.98e9

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernels (once per source content) and return the
    library path.  ``verbose`` adds ``-Xptxas -v`` and prints its report."""
    return _nvcc.build(SOURCE, verbose=verbose)


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.threefry_normal.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.threefry_normal.restype = ctypes.c_int
            lib.gumbel_argmax.argtypes = [
                ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.gumbel_argmax.restype = ctypes.c_int
            _lib = lib
        return _lib


def _key_table(keys) -> np.ndarray:
    keys = np.asarray(keys)
    if keys.dtype != np.uint32 or keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"need a (n_keys, 2) uint32 key table, got "
                         f"{keys.dtype} {keys.shape}")
    return np.ascontiguousarray(keys)


def threefry_normal(keys, count: int, dtype, device, *, std=None,
                    offset: int = 0) -> torch.Tensor:
    """(n_keys, count) ``dtype`` (f32 or bf16) on ``device``: row k holds
    draws ``offset .. offset + count - 1`` of
    ``jax.random.normal(keys[k], shape, f32)`` (flat), times ``f32(std)``
    when given, cast round-to-nearest-even.  ``keys``: (n_keys, 2) uint32.
    A CUDA device launches the kernel; the CPU runs
    :func:`repro_torch.kernels.ref.threefry_normal_ref`."""
    keys = _key_table(keys)
    dev = torch.device(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"threefry_normal writes f32 or bf16, not {dtype}")
    if count < 0 or offset < 0:
        raise ValueError(f"count {count} and offset {offset} must be >= 0")
    if dev.type == "cpu":
        return _ref.threefry_normal_ref(keys, offset, count, std, dtype, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 0 < keys.shape[0] <= 65535:
        raise ValueError(f"{keys.shape[0]} keys: a launch takes 1 to 65,535")
    out = torch.empty((keys.shape[0], count), dtype=dtype, device=dev)
    if count == 0:
        return out
    table = torch.from_numpy(keys.view(np.int32)).to(dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.threefry_normal(
            table.data_ptr(), keys.shape[0], count, offset,
            0.0 if std is None else float(np.float32(std)), int(std is not None),
            int(dtype == torch.bfloat16), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"threefry_normal launch failed: CUDA error {err}")
    launches["threefry_normal"] += 1
    return out


def gumbel_argmax(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for (B, V) f32
    ``logits``: (B,) int64 on their device.  CUDA logits launch the
    kernel; CPU logits run :func:`repro_torch.kernels.ref.gumbel_argmax_ref`."""
    key = np.asarray(key)
    if key.dtype != np.uint32 or key.shape != (2,):
        raise ValueError(f"need one (2,) uint32 key, got {key.dtype} {key.shape}")
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"need (B, V) f32 logits, got {logits.dtype} "
                         f"{tuple(logits.shape)}")
    if logits.device.type == "cpu":
        return _ref.gumbel_argmax_ref(key, logits)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    rows, vocab = logits.shape
    if rows == 0 or vocab == 0:
        raise ValueError(f"empty logits {tuple(logits.shape)}")
    if vocab > 2**31 - 1 - GUMBEL_SLICE:
        raise ValueError(f"vocabulary {vocab}: the kernel indexes it in int32")
    logits = logits.contiguous()
    out = torch.empty((rows,), dtype=torch.int64, device=logits.device)
    # each (row, slice)'s best: f32 values, then int32 indices
    parts = rows * -(-vocab // GUMBEL_SLICE)
    scratch = torch.empty((2 * parts,), dtype=torch.int32, device=logits.device)
    lib = _library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.gumbel_argmax(int(key[0]), int(key[1]), logits.data_ptr(), rows,
                                vocab, scratch.data_ptr(), 8 * parts, out.data_ptr(),
                                stream)
    if err != 0:
        raise RuntimeError(f"gumbel_argmax launch failed: CUDA error {err}")
    launches["gumbel_argmax"] += 1
    return out


def normal_bound_s(count: int, small_share: float, out_bytes: int) -> tuple[float, str]:
    """The least time one H100 SXM could take for ``count`` draws: the
    larger of the operations (int32 lanes alone, and all operations over
    the FP32 lanes' issue rate) and the bytes written at 3.35 TB/s; and
    which of the two bounds it."""
    ints = NORMAL_INT_OPS * count
    f32 = (NORMAL_F32_SHARED + small_share * LOG1P_SMALL_OPS
           + (1.0 - small_share) * LOG1P_LARGE_OPS) * count
    ops_s = max(ints / INT32_OPS_PER_S, (ints + f32) / F32_OPS_PER_S)
    bytes_s = count * out_bytes / 3.35e12
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def gumbel_bound_s(rows: int, vocab: int) -> tuple[float, str]:
    """The least time one H100 SXM could take for a (rows, vocab)
    Gumbel-max: its operations as in :func:`normal_bound_s`, or the f32
    logits read and the tokens written at 3.35 TB/s."""
    n = rows * vocab
    ints, f32 = NORMAL_INT_OPS * n, GUMBEL_F32_OPS * n
    ops_s = max(ints / INT32_OPS_PER_S, (ints + f32) / F32_OPS_PER_S)
    bytes_s = (4 * n + 8 * rows) / 3.35e12
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
