"""The table of peaks and the work each kernel's inputs need.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit): HBM3 at 3.35 TB/s, FP64 vector at 34 TFLOP/s.  The
counts come from the checkpoint manifest and the cluster, never from the
program's launch plan, so fusing or skipping launches does not move
them.
"""

from __future__ import annotations

from drexbench.reference import drex_sc

__all__ = ["HBM_BYTES_PER_S", "FP64_OPS_PER_S", "encode_bytes", "decode_bytes", "frontier_ops"]

HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12


def encode_bytes(groups) -> float:
    """HBM bytes an encode of these manifest groups needs: every data
    chunk byte read once, every parity chunk byte written once, and the
    (8P x 8K) bit-matrix read once per group."""
    total = 0.0
    for g in groups:
        total += (g["k"] + g["p"]) * g["chunk_len"] + 64 * g["p"] * g["k"]
    return total


def decode_bytes(groups, lost_rows) -> float:
    """HBM bytes a restore's decode needs: for each group that lost data
    rows, K surviving chunks read once and each lost data row written
    once.  ``lost_rows[i]`` is the number of data rows group i lost."""
    total = 0.0
    for g, e in zip(groups, lost_rows):
        if e:
            total += (g["k"] + e) * g["chunk_len"] + 64 * e * g["k"]
    return total


def frontier_ops(n_decisions: int, n_live: int) -> float:
    """Float64 operations of the D-Rex SC frontier DP, as the oracle
    defines it, for ``n_decisions`` decisions over ``n_live`` nodes."""
    return n_decisions * drex_sc.frontier_dp_ops(n_live)
