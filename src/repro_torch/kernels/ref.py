"""Plain PyTorch versions of the port's hand-written kernels.

Integer tensor ops that run on the CPU and on CUDA alike:

* :func:`gf_mul_ref` / :func:`gf_matmul_ref` are the log/exp-table
  multiplication with XOR accumulation of the paper's CPU algorithm —
  the semantics every coding path must match byte for byte.
* :func:`bitmatmul_ref` is the plain version of the CUDA kernel in
  :mod:`repro_torch.kernels.rs_bitmatmul`: the same mod-2 bit-matrix
  product, in the same per-bit-plane XOR form the kernel uses.  The
  wrapper takes it for CPU tensors, and the chip smoke holds the kernel
  against it on the card.
* :func:`pb_frontier_ref` is the plain version of the parity-frontier
  kernel in :mod:`repro_torch.kernels.pb_frontier`: the torch twin of
  ``ParityFrontier.upto_many``, a loop over window ends with an explicit
  left-to-right running sum for the CDF.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.ec.gf256 import GF_EXP, GF_LOG

__all__ = [
    "gf_mul_ref",
    "gf_matmul_ref",
    "encode_ref",
    "decode_ref",
    "bitmatmul_ref",
    "pb_frontier_ref",
]

#: (exp, log) tables per device: (512,) uint8 doubled exp, (256,) int64 log.
_TABLES: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_tables_lock = threading.Lock()


def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    with _tables_lock:
        got = _TABLES.get(device)
        if got is None:
            got = (
                torch.from_numpy(GF_EXP.copy()).to(device),
                torch.from_numpy(GF_LOG.astype(np.int64)).to(device),
            )
            _TABLES[device] = got
        return got


def _u8(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x if device is None else x.to(device)
        return t.to(torch.uint8)
    t = torch.from_numpy(np.array(x, dtype=np.uint8))
    return t if device is None else t.to(device)


def gf_mul_ref(a, b) -> torch.Tensor:
    """Elementwise (broadcasting) GF(2^8) multiply via log/exp tables."""
    a = _u8(a)
    b = _u8(b, a.device)
    exp, log = _tables(a.device)
    out = exp[log[a.long()] + log[b.long()]]
    return torch.where((a == 0) | (b == 0), torch.zeros_like(out), out)


def gf_matmul_ref(m, data) -> torch.Tensor:
    """(R, K) GF matrix times (K, B) byte matrix -> (R, B) bytes.

    products[r, k, b] XOR-reduced over k (R*K*B multiply-XOR ops)."""
    data = _u8(data)
    m = _u8(m, data.device)
    r, k = m.shape
    k2, b = data.shape
    if k != k2:
        raise ValueError(f"shape mismatch: {tuple(m.shape)} x {tuple(data.shape)}")
    acc = torch.zeros((r, b), dtype=torch.uint8, device=data.device)
    for i in range(k):
        acc ^= gf_mul_ref(m[:, i : i + 1], data[i : i + 1, :])
    return acc


def encode_ref(data_chunks, cauchy) -> torch.Tensor:
    """Systematic encode: parity (P, B) = C (P, K) x data (K, B)."""
    return gf_matmul_ref(cauchy, data_chunks)


def decode_ref(surviving_chunks, dec_matrix) -> torch.Tensor:
    """Reconstruct data (K, B) from K surviving chunks via the inverted
    generator submatrix (K, K)."""
    return gf_matmul_ref(dec_matrix, surviving_chunks)


def _coefficient_bytes(bit_matrix: torch.Tensor) -> torch.Tensor:
    """(R, K, 8) uint8: ``c[r, k, j]`` is the byte that bit ``j`` of an
    input byte of row ``k`` contributes to output row ``r`` — column
    ``8k+j`` of rows ``8r..8r+7`` of the bit matrix, packed LSB-first."""
    bm = bit_matrix.to(torch.int32) & 1
    r8, k8 = bm.shape
    if r8 % 8 or k8 % 8:
        raise ValueError(f"bit matrix shape {tuple(bm.shape)} is not (8R, 8K)")
    weights = torch.arange(8, device=bm.device, dtype=torch.int32)
    planes = bm.reshape(r8 // 8, 8, k8 // 8, 8)          # (R, i, K, j)
    packed = (planes << weights[None, :, None, None]).sum(dim=1)
    return packed.to(torch.uint8)                          # (R, K, j)


def bitmatmul_ref(bit_matrix, data_chunks) -> torch.Tensor:
    """Mod-2 bit-matrix product — the plain version of the CUDA kernel.

    ``bit_matrix``: (8R, 8K) in {0, 1} (any integer or float dtype);
    ``data_chunks``: (K, B) uint8.  Returns (R, B) uint8, equal to
    ``gf_matmul_ref(m, data)`` when ``bit_matrix = gf_to_bitmatrix(m)``:
    ``out[r] = XOR_{k, j} (bit j of data[k]) * c[r, k, j]``, which is
    ``out_bits = bit_matrix @ data_bits (mod 2)`` with the eight output
    bits of each row kept packed in one byte.
    """
    data = _u8(data_chunks)
    bm = bit_matrix if isinstance(bit_matrix, torch.Tensor) else torch.from_numpy(
        np.array(bit_matrix)
    )
    coef = _coefficient_bytes(bm.to(data.device))            # (R, K, 8)
    r, k, _ = coef.shape
    k2, b = data.shape
    if k != k2:
        raise ValueError(
            f"shape mismatch: bit matrix for K={k}, data {tuple(data.shape)}"
        )
    out = torch.zeros((r, b), dtype=torch.uint8, device=data.device)
    for kk in range(k):
        for j in range(8):
            bit = (data[kk] >> j) & 1                       # (B,) in {0, 1}
            out ^= coef[:, kk, j : j + 1] * bit[None, :]
    return out


def pb_frontier_ref(
    probs: torch.Tensor,
    targets: torch.Tensor,
    n_starts: int,
    L_live: int,
    width: int,
) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.pb_frontier.frontier`.

    ``probs (B, L) f64``, ``targets (B,) f64`` -> ``mp (B, S, L) int64``:
    ``mp[b, s, i]`` is the smallest parity whose CDF over the window
    ``probs[b, s..i]`` reaches ``targets[b]`` (-1 where none ``<= i - s``
    does, ``i < s`` or ``i >= L_live``), from a DP row of ``width``
    entries.  The arithmetic is numpy's, operation for operation: the DP
    step multiplies and adds in separate ops (no fused op), and the CDF
    is ``np.cumsum``'s left-to-right running sum, one ``add`` per term
    written into ``runs`` (never ``torch.cumsum``, which re-associates on
    CUDA).  A running sum of non-negative terms is monotone, so the first
    term that reaches the target is ``argmax(cumsum >= target)``.  Each
    step sums as many terms as the previous step needed and extends
    (doubling) only while some row has not reached its target: one host
    sync per step, not one per term.
    """
    B, L = probs.shape
    S, W = int(n_starts), int(width)
    dev = probs.device
    out = torch.full((B, S, L), -1, dtype=torch.int64, device=dev)
    dp = torch.zeros((B, S, W), dtype=torch.float64, device=dev)
    dp[:, :, 0] = 1.0
    runs = torch.empty((B, S, W), dtype=torch.float64, device=dev)
    q_all = 1.0 - probs                  # the oracle's (1 - p), elementwise
    starts = torch.arange(S, device=dev)
    cols = torch.arange(W, device=dev)
    target = targets[:, None, None]
    hint = 1
    for i in range(min(L, int(L_live))):
        a = min(i + 1, S)                # starts 0..a-1 have a window [s..i]
        top = min(i + 1, W - 1)          # entries above are zero and stay so
        head = dp[:, :a, : top + 1]
        nd = head * q_all[:, i, None, None]
        nd[:, :, 1:] += head[:, :, :-1] * probs[:, i, None, None]
        dp[:, :a, : top + 1] = nd
        jlim = min(i, W - 1)             # last admissible parity (start 0)
        jmax = (i - starts[:a]).clamp(max=W - 1)
        run = runs[:, :a]
        run[:, :, 0] = dp[:, :a, 0]
        done = 0
        want = min(jlim, hint)
        while True:
            for j in range(done + 1, want + 1):
                torch.add(run[:, :, j - 1], dp[:, :a, j], out=run[:, :, j])
            done = want
            reach = (run[:, :, : done + 1] >= target) & (
                cols[: done + 1] <= jmax[:, None]
            )
            hit = reach.any(dim=2)
            if done >= jlim or not bool((~hit & (jmax > done)).any()):
                break
            want = min(jlim, 2 * done + 1)
        hint = max(hint, done)
        first = torch.argmax(reach.to(torch.int32), dim=2)
        out[:, :a, i] = torch.where(hit, first, -1)
    return out
