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

**What bounds it.**  The operations bound (3 f64 operations per updated
DP entry plus one add per CDF term scanned, at the FP64 rate) and the
bytes (8 per input and output element) are far below what a
step-at-a-time design reaches: the fixed summation order leaves every
(row, step) a serial chain of ``mp + 1`` dependent adds, ``mp`` the
step's minimum parity (~70 on the 10,000-node scale lane), and only the
DP update carries from one step to the next.

**What the design does about it.**  One warp per (item, start) row, up
to four rows per block, with nothing wider than a warp synchronised.
Two variants, chosen by :func:`plan`:

* ``registers`` for ``W <= 1152``: the row lives in registers, lane
  ``l`` owning the contiguous entries ``[l*C, l*C + C)`` with ``C`` the
  smallest of :data:`REG_CHUNKS` that covers ``W``.  The chains of
  different steps are independent, so the warp advances 32 steps,
  staging each step's first ``K`` entries in its own shared-memory slot,
  and then the 32 lanes run the 32 steps' in-order chains side by side.
  Where ``K`` cannot cover every admissible parity it is used only while
  the previous parity sits :data:`STAGE_GUARD` below it; a step whose hit
  lies past ``K`` replays the row (same arithmetic, same bits), and a
  block that cannot stage scans step by step in lane order (the running
  sum handed between lanes by shuffle).  Mass only moves up the row, so
  a first pass keeps only the first 128 entries (4 a lane) and settles
  every step whose parity lies below 128; a row with a step it cannot
  settle runs again at full width.
* ``shared`` for wider rows, up to the shared-memory opt-in (14,528
  entries on an H100): two alternating rows of ``W`` doubles per warp in
  shared memory, the update spread over the lanes, and the scan reading
  32 terms at once and adding them in order by shuffle broadcast.

Both compute the same bits; nothing falls back to the plain version.

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
import dataclasses
import functools
import pathlib
import threading

import torch

from . import nvcc as _nvcc
from . import ref as _ref

__all__ = [
    "frontier", "plan", "Plan", "device_limits", "build", "launches",
    "reset_launches", "SOURCE", "REG_CHUNKS",
]

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "pb_frontier.cu"
FLAGS = ("-fmad=false",)

#: DP entries per lane the ``registers`` variant is built for
#: (``pb_frontier_regs<C>``); the widest covers ``W <= 32 * 36 = 1152``.
REG_CHUNKS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 36)
MAX_ROWS_PER_BLOCK = 4
_VARIANT_ID = {"registers": 0, "shared": 1}

#: kernel launches since import or the last :func:`reset_launches`.
launches = 0
_launch_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()


#: how far below a staged step's K the previous step's parity must lie for
#: a ``registers`` block to stage its steps past their last admissible
#: parity (a parity grows by at most one a step, 32 steps a block).
STAGE_GUARD = 40


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the variant, its DP entries per lane (``registers``
    only, else 0), rows (warps) per block, threads, dynamic shared bytes,
    blocks, and for ``registers`` the doubles a staged step keeps
    (``stage_k``, odd so that 32 lanes reading 32 slots meet no bank
    twice) and the staging guard."""

    variant: str
    chunk: int
    rows_per_block: int
    threads: int
    shared_bytes: int
    blocks: int
    stage_k: int = 0
    guard: int = STAGE_GUARD


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, width: int, n_sms: int, max_shared: int) -> Plan:
    """The launch for ``n_rows = B * S`` rows of ``width`` DP entries on a
    card with ``n_sms`` SMs and ``max_shared`` opt-in shared bytes per
    block.  Rows per block spread the rows over the SMs first (one row a
    warp scheduler, so nothing shares the issue slot a serial scan
    waits on), then pack up to four.  A ``registers`` row stages 32 slots
    of ``stage_k`` doubles: its whole width where that fits, else as many
    as the block's shared memory holds.  Raises ``ValueError`` naming the
    width when one row does not fit a block's shared memory."""
    n_rows, width = int(n_rows), int(width)
    if n_rows < 1 or width < 1 or n_sms < 1:
        raise ValueError(f"need n_rows, width and n_sms >= 1, got {n_rows}, {width}, {n_sms}")
    rpb = max(1, min(MAX_ROWS_PER_BLOCK, -(-n_rows // n_sms)))
    chunk = next((c for c in REG_CHUNKS if 32 * c >= width), 0)
    if chunk:
        cap = max_shared // (rpb * 32 * 8)
        stage_k = min(width | 1, cap - (1 - cap % 2))
        if stage_k < 1:
            raise ValueError(f"no shared memory to stage width {width} on this device")
        return Plan("registers", chunk, rpb, 32 * rpb, rpb * 32 * 8 * stage_k,
                    -(-n_rows // rpb), stage_k)
    row_bytes = 2 * 8 * width
    fit = max_shared // row_bytes
    if fit < 1:
        raise ValueError(
            f"width {width} exceeds the {max_shared // 16} DP entries a "
            "block's shared memory holds on this device"
        )
    rpb = min(rpb, fit)
    return Plan("shared", 0, rpb, 32 * rpb, rpb * row_bytes, -(-n_rows // rpb))


def loaded() -> bool:
    """Has this process built (or found built) and loaded the kernel's
    library?"""
    return _lib is not None


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
    library path.  ``verbose`` adds ``-Xptxas -v`` and prints its report
    (registers, spills and shared memory of every variant)."""
    return _nvcc.build(SOURCE, FLAGS, verbose=verbose)


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pb_frontier.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                *([ctypes.c_int] * 11), ctypes.c_void_p,
            ]
            lib.pb_frontier.restype = ctypes.c_int
            lib.pb_frontier_max_shared.argtypes = []
            lib.pb_frontier_max_shared.restype = ctypes.c_int
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def device_limits(device: torch.device) -> tuple[int, int]:
    """``(n_sms, max_shared)`` of a CUDA device, for :func:`plan`."""
    with torch.cuda.device(device):
        n_sms = torch.cuda.get_device_properties(device).multi_processor_count
        return n_sms, _library().pb_frontier_max_shared()


def frontier(
    probs: torch.Tensor,
    targets: torch.Tensor,
    n_starts: int,
    L_live: int,
    width: int,
    *,
    launch: Plan | None = None,
) -> torch.Tensor:
    """``mp (B, n_starts, L) int64`` on the inputs' device (see the module
    docstring).  CUDA tensors launch the kernel; CPU tensors run
    :func:`repro_torch.kernels.ref.pb_frontier_ref`.  ``launch`` replaces
    :func:`plan`'s choice (tests force the rarer paths with it)."""
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
    pl = launch or plan(B * n_starts, width, *device_limits(probs.device))
    with torch.cuda.device(probs.device):
        stream = torch.cuda.current_stream(probs.device).cuda_stream
        err = lib.pb_frontier(
            probs.data_ptr(), targets.data_ptr(), out.data_ptr(),
            B, L, n_starts, L_live, width, _VARIANT_ID[pl.variant], pl.chunk,
            pl.rows_per_block, pl.shared_bytes, pl.stage_k, pl.guard, stream,
        )
    if err != 0:
        raise RuntimeError(f"pb_frontier launch failed ({pl}): CUDA error {err}")
    _count_launch()
    return out
