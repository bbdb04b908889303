"""GF(2^8) arithmetic and Cauchy Reed-Solomon matrix machinery (host side).

The code is the classic systematic Cauchy-RS construction (Jerasure
lineage): generator G = [I_K ; C] with C a P x K Cauchy matrix over
GF(2^8). Every square submatrix of a Cauchy matrix is nonsingular, so any
K of the K+P chunk rows of G are invertible -> any K chunks recover the
item. Field polynomial 0x11d (x^8+x^4+x^3+x^2+1), generator alpha = 2.

Everything here is control-plane numpy (tiny matrices), copied from the
JAX package; the data plane is in repro_torch/kernels (the CUDA bit-matrix
kernel) with repro_torch/kernels/ref.py as the plain PyTorch oracle.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "GF_EXP",
    "GF_LOG",
    "gf_mul",
    "gf_inv",
    "gf_matmul",
    "gf_mat_inv",
    "cauchy_matrix",
    "generator_matrix",
    "decode_matrix",
    "gf_to_bitmatrix",
]

_POLY = 0x11D


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]  # doubled so exp[a+b] needs no mod
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a, b):
    """Elementwise GF(2^8) product (numpy uint8 arrays or scalars)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = GF_EXP[GF_LOG[a].astype(np.int64) + GF_LOG[b].astype(np.int64)]
    return np.where((a == 0) | (b == 0), np.uint8(0), out)


def gf_inv(a):
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return GF_EXP[255 - GF_LOG[a].astype(np.int64)]


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(m,n) @ (n,p) over GF(2^8): XOR-accumulated products."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    # products[m, n, p] then XOR-reduce over n
    prod = gf_mul(a[:, :, None], b[None, :, :])
    return np.bitwise_xor.reduce(prod, axis=1)


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(2^8); raises if singular."""
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    a = m.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if a[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise np.linalg.LinAlgError("singular matrix over GF(2^8)")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pinv = gf_inv(a[col, col])
        a[col] = gf_mul(a[col], pinv)
        inv[col] = gf_mul(inv[col], pinv)
        for row in range(n):
            if row != col and a[row, col] != 0:
                factor = a[row, col]
                a[row] ^= gf_mul(factor, a[col])
                inv[row] ^= gf_mul(factor, inv[col])
    return inv


def cauchy_matrix(p: int, k: int) -> np.ndarray:
    """P x K Cauchy matrix C[i,j] = 1/(x_i ^ y_j), x_i = i, y_j = p + j.

    Requires p + k <= 256 (distinct field points)."""
    if p + k > 256:
        raise ValueError(f"Cauchy construction needs P+K <= 256, got {p + k}")
    xs = np.arange(p, dtype=np.uint8)[:, None]
    ys = np.arange(p, p + k, dtype=np.uint8)[None, :]
    return gf_inv(xs ^ ys)


def generator_matrix(k: int, p: int) -> np.ndarray:
    """Systematic generator [I_K ; C] of shape (K+P, K)."""
    return np.concatenate([np.eye(k, dtype=np.uint8), cauchy_matrix(p, k)], axis=0)


def decode_matrix(k: int, p: int, surviving_rows: np.ndarray) -> np.ndarray:
    """(K,K) matrix mapping K surviving chunks -> K data chunks.

    ``surviving_rows``: indices (into the N=K+P chunk rows) of the K
    chunks being used for reconstruction."""
    rows = np.asarray(surviving_rows, dtype=np.int64)
    if rows.shape != (k,):
        raise ValueError(f"need exactly K={k} surviving rows, got {rows.shape}")
    if np.unique(rows).size != k or rows.min() < 0 or rows.max() >= k + p:
        raise ValueError("surviving rows must be distinct indices in [0, K+P)")
    g = generator_matrix(k, p)
    return gf_mat_inv(g[rows, :])


# -- bit-matrix construction (the coding kernels' operand) ------------------

_BIT_BASIS = np.array([1 << j for j in range(8)], dtype=np.uint8)


def gf_to_bitmatrix(m: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix (R, K) into its GF(2) bit-matrix (8R, 8K).

    Multiplication by a constant g is linear over GF(2); column j of the
    8x8 block for g holds the bits of g * x^j. With LSB-first bit order:

        out_bits[r*8 + i, k*8 + j] = bit i of gf_mul(m[r, k], 1 << j)

    so that ``parity_bits = bitmatrix @ data_bits (mod 2)`` computes the
    same code as ``parity = m @ data`` over GF(2^8).
    """
    m = np.asarray(m, dtype=np.uint8)
    r, k = m.shape
    # prods[r, k, j] = m[r,k] * 2^j  -> bits[r, k, i, j]
    prods = gf_mul(m[:, :, None], _BIT_BASIS[None, None, :])
    bits = (prods[:, :, None, :] >> np.arange(8)[None, None, :, None]) & 1
    # lay out as (r, i) x (k, j)
    return bits.transpose(0, 2, 1, 3).reshape(8 * r, 8 * k).astype(np.uint8)
