"""Hopper kernel for Cauchy-RS coding: a mod-2 bit-matrix product in CUDA.

Replaces the JAX package's Pallas TPU kernel ``gf_bitmatmul``
(``src/repro/kernels/rs_bitmatmul.py:56``, body ``_coding_kernel``) with
the same interface and function: bit matrix (8R, 8K) and data (K, B)
uint8 in, (R, B) uint8 out, equal to the GF(2^8) product of the matrix
the bit matrix expands.  The source is ``csrc/rs_bitmatmul.cu``.

**What bounds it.**  Every input byte is read once and every output byte
written once: (K + R) * B bytes of device-memory traffic.  At the
checkpoint's main-path shapes (encode R=1, K=3, a 16-group wave of
~358 MB) that is ~0.43 ms at an H100 SXM's 3.35 TB/s.  The XOR work,
~8 * K * R integer operations per 4 byte columns, takes over only at
large K * R.

**What the design does about it.**  The TPU kernel inflates bytes into
f32 bit planes for its matrix unit; this kernel never leaves byte
granularity.  Each thread loads 16 bytes per input row with one vector
load, turns each bit plane into byte masks in registers, and
XOR-accumulates the staged coefficient bytes into up to eight output
rows at once, so device memory sees each byte once and the integer work
stays in registers and shared memory.

**Build.**  ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside
this file (listed in ``.gitignore``; :mod:`repro_torch.kernels.nvcc`),
loaded with ``ctypes``.

**Dispatch.**  A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version :func:`repro_torch.kernels.ref.bitmatmul_ref`.
Nothing falls back.  ``launches`` counts kernel launches (CPU calls do
not count).
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from . import nvcc as _nvcc
from . import ref as _ref

__all__ = ["gf_bitmatmul", "build", "launches", "reset_launches", "SOURCE"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "rs_bitmatmul.cu"

#: kernel launches since import or the last :func:`reset_launches`.
launches = 0
_launch_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    with _launch_lock:
        launches = 0


def _count_launch() -> None:
    """One more launch, under a lock: a checkpointer's save launches from
    its worker thread while the caller may launch too."""
    global launches
    with _launch_lock:
        launches += 1


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernel (once per source content) and return the
    library path.  ``verbose`` adds ``-Xptxas -v`` and prints its report."""
    return _nvcc.build(SOURCE, verbose=verbose)


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rs_bitmatmul.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ]
            lib.rs_bitmatmul.restype = ctypes.c_int
            lib.rs_bitmatmul_row_tile.argtypes = [ctypes.c_int]
            lib.rs_bitmatmul_row_tile.restype = ctypes.c_int
            lib.rs_bitmatmul_max_coef_words.argtypes = []
            lib.rs_bitmatmul_max_coef_words.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(bit_matrix: torch.Tensor, data: torch.Tensor) -> tuple[int, int, int]:
    if bit_matrix.dim() != 2 or data.dim() != 2:
        raise ValueError(
            f"need a 2-D bit matrix and 2-D data, got "
            f"{tuple(bit_matrix.shape)} and {tuple(data.shape)}"
        )
    r8, k8 = bit_matrix.shape
    if r8 % 8 or k8 % 8 or r8 == 0 or k8 == 0:
        raise ValueError(f"bit matrix shape {tuple(bit_matrix.shape)} is not (8R, 8K)")
    k, b = data.shape
    if k != k8 // 8:
        raise ValueError(
            f"data {tuple(data.shape)} does not match bit matrix "
            f"{tuple(bit_matrix.shape)} (K={k8 // 8})"
        )
    if data.dtype != torch.uint8:
        raise TypeError(f"data must be uint8, got {data.dtype}")
    return r8 // 8, k, b


def gf_bitmatmul(bit_matrix: torch.Tensor, data_chunks: torch.Tensor) -> torch.Tensor:
    """out (R, B) uint8 = GF(2^8) matrix product via the mod-2 bit matrix.

    ``bit_matrix``: (8R, 8K) in {0, 1} (from ``gf_to_bitmatrix``), uint8
    on the data's device for the kernel; ``data_chunks``: (K, B) uint8,
    any B.  CUDA tensors launch the kernel; CPU tensors run
    :func:`repro_torch.kernels.ref.bitmatmul_ref`."""
    r, k, b = _check(bit_matrix, data_chunks)
    if data_chunks.device.type == "cpu":
        return _ref.bitmatmul_ref(bit_matrix, data_chunks)
    if data_chunks.device.type != "cuda":
        raise ValueError(f"unsupported device {data_chunks.device}")
    if bit_matrix.device != data_chunks.device or bit_matrix.dtype != torch.uint8:
        raise ValueError(
            "the kernel needs a uint8 bit matrix on the data's device, got "
            f"{bit_matrix.dtype} on {bit_matrix.device}"
        )
    if not (bit_matrix.is_contiguous() and data_chunks.is_contiguous()):
        raise ValueError("bit matrix and data must be contiguous")
    lib = _library()
    words = lib.rs_bitmatmul_row_tile(r) * k * 8
    if words > lib.rs_bitmatmul_max_coef_words():
        raise ValueError(
            f"K={k} needs {words} coefficient words of shared memory, above "
            f"the {lib.rs_bitmatmul_max_coef_words()} a block reserves"
        )
    out = torch.empty((r, b), dtype=torch.uint8, device=data_chunks.device)
    if b == 0:
        return out
    with torch.cuda.device(data_chunks.device):
        stream = torch.cuda.current_stream(data_chunks.device).cuda_stream
        err = lib.rs_bitmatmul(
            bit_matrix.data_ptr(), data_chunks.data_ptr(), out.data_ptr(),
            r, k, b, stream,
        )
    if err != 0:
        raise RuntimeError(f"rs_bitmatmul launch failed: CUDA error {err}")
    _count_launch()
    return out
