"""Hopper kernel for the Poisson-binomial parity frontier, in CUDA.

Replaces the in-jit dynamic programme of the JAX package's decision
programs: the masked DP over every suffix start in D-Rex SC's window
scorer (``src/repro/core/sc_kernel.py:133``, inside ``_score_windows``)
and the start-0 DP of the greedy scorers
(``src/repro/core/greedy_kernel.py:125``, ``_prefix_frontier``).  These
are XLA programs, not Pallas kernels; the DP is the one place of the
decision path where plain torch ops cannot keep the exactness contract
(``torch.cumsum`` on CUDA re-associates, and an eager ``scan`` costs
about eight launches per step).  The source is
``csrc/pb_frontier.cu``.

**Contract.**  ``probs (B, L) f64``, ``targets (B,) f64``, ``n_starts
S``, ``L_live`` and ``width W`` in; ``mp (B, S, L) int64`` out.
``mp[b, s, i]`` is the minimum parity meeting ``targets[b]`` for the
window ``probs[b, s..i]``, or -1 where it is infeasible, ``i < s``,
``i >= L_live``, or no ``j <= i - s`` reaches the target.  This is
:meth:`repro_torch.core.reliability.ParityFrontier.upto_many`'s contract
(``mp[b, s, s + m] == upto_many()[s, m]``) and the in-jit DP's
``cols.T``.

**What bounds it.**  The work is data-dependent: 3 f64 operations per
updated DP entry (the support grows by one per step) plus one add per
CDF term scanned, against 8 bytes per input and output element.  Each
step also pays a block barrier and a serial scan, so at the decision
path's widths the kernel is latency-bound, not bound by the FP64 rate.

**What the design does about it.**  One block per (item, start) row
runs the whole DP with the row in shared memory, so the XLA scan's
per-step launches and device-memory round trips disappear; the serial
scan is O(min parity) per step, not O(width), and overlaps the next
step's update.  Later work can make it faster; this version is right
first.

**Build.**  ``nvcc`` for ``sm_90a`` with ``-fmad=false`` (no FMA
contraction, so products and sums round separately as in numpy), at
first use, into ``_build/`` (:mod:`repro_torch.kernels.nvcc`), loaded
with ``ctypes``.

**Dispatch.**  A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version :func:`repro_torch.kernels.ref.pb_frontier_ref`.
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

__all__ = ["frontier", "build", "launches", "reset_launches", "SOURCE"]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "pb_frontier.cu"
FLAGS = ("-fmad=false",)

#: kernel launches since import or the last :func:`reset_launches`.
launches = 0

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    global launches
    launches = 0


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the kernel (once per source content) and return the
    library path.  ``verbose`` adds ``-Xptxas -v`` and prints its report."""
    return _nvcc.build(SOURCE, FLAGS, verbose=verbose)


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pb_frontier.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.pb_frontier.restype = ctypes.c_int
            lib.pb_frontier_max_width.argtypes = []
            lib.pb_frontier_max_width.restype = ctypes.c_int
            _lib = lib
        return _lib


def frontier(
    probs: torch.Tensor,
    targets: torch.Tensor,
    n_starts: int,
    L_live: int,
    width: int,
) -> torch.Tensor:
    """``mp (B, n_starts, L) int64`` on the inputs' device (see the module
    docstring).  CUDA tensors launch the kernel; CPU tensors run
    :func:`repro_torch.kernels.ref.pb_frontier_ref`."""
    global launches
    if probs.dim() != 2 or targets.dim() != 1 or targets.shape[0] != probs.shape[0]:
        raise ValueError(
            f"need probs (B, L) and targets (B,), got {tuple(probs.shape)} "
            f"and {tuple(targets.shape)}"
        )
    if probs.dtype != torch.float64 or targets.dtype != torch.float64:
        raise TypeError(f"need float64 inputs, got {probs.dtype} and {targets.dtype}")
    if probs.device != targets.device:
        raise ValueError(f"inputs on {probs.device} and {targets.device}")
    n_starts, L_live, width = int(n_starts), int(L_live), int(width)
    if n_starts < 1 or width < 1:
        raise ValueError(f"need n_starts >= 1 and width >= 1, got {n_starts}, {width}")
    if probs.device.type == "cpu":
        return _ref.pb_frontier_ref(probs, targets, n_starts, L_live, width)
    if probs.device.type != "cuda":
        raise ValueError(f"unsupported device {probs.device}")
    B, L = probs.shape
    out = torch.empty((B, n_starts, L), dtype=torch.int64, device=probs.device)
    if B == 0 or L == 0:
        return out
    probs, targets = probs.contiguous(), targets.contiguous()
    lib = _library()
    with torch.cuda.device(probs.device):
        max_w = lib.pb_frontier_max_width()
        if width > max_w:
            raise ValueError(
                f"width {width} exceeds the {max_w} DP entries a block's "
                "shared memory holds on this device"
            )
        stream = torch.cuda.current_stream(probs.device).cuda_stream
        err = lib.pb_frontier(
            probs.data_ptr(), targets.data_ptr(), out.data_ptr(),
            B, L, n_starts, L_live, width, stream,
        )
    if err != 0:
        raise RuntimeError(f"pb_frontier launch failed: CUDA error {err}")
    launches += 1
    return out
