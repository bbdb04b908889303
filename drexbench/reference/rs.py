"""A plain numpy systematic Cauchy Reed-Solomon code over GF(2^8).

Field polynomial 0x11d with generator 2; the generator matrix is
``[I_K ; C]`` with ``C[i, j] = 1 / (i ^ (P + j))`` (Jerasure's Cauchy
construction).  Products are looked up in a 256 x 256 table, so every
parity byte is an XOR of K table reads: nothing here shares code with
the program's bit-matrix kernel or its tables.

The checkpoint layout the benchmark holds the program to: a leaf's raw
bytes are cut into groups of ``group_bytes``; each group is zero-padded
to a power-of-two bucket of at least 4096 bytes, then to K equal data
rows; chunk row r of a group is data row r for r < K and parity row
r - K after.

``data_rows`` and ``encode_rows`` take numpy arrays, or plain torch
uint8 tensors, on which they make the same table reads on the tensor's
own device (a card codes a 64 MB group in milliseconds, where numpy
takes about half a second).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MUL", "bucket_len", "chunk_len", "cauchy", "encode_rows", "data_rows"]

_POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    return exp, log


_EXP, _LOG = _tables()
_a = np.arange(256)
#: MUL[a, b] = a * b in GF(2^8).
MUL = np.where(
    (_a[:, None] == 0) | (_a[None, :] == 0), 0, _EXP[_LOG[_a][:, None] + _LOG[_a][None, :]]
).astype(np.uint8)


def _inv(a: int) -> int:
    return int(_EXP[255 - _LOG[a]])


def cauchy(k: int, p: int) -> np.ndarray:
    """The (P, K) Cauchy block of the generator."""
    return np.array([[_inv(i ^ (p + j)) for j in range(k)] for i in range(p)], dtype=np.uint8)


def bucket_len(nbytes: int) -> int:
    """The padded length of a group of ``nbytes``."""
    bucket = 4096
    while bucket < nbytes:
        bucket <<= 1
    return bucket


def chunk_len(nbytes: int, k: int) -> int:
    """Bytes in each of a group's K + P chunks."""
    return -(-bucket_len(nbytes) // k)


def data_rows(payload, k: int):
    """(K, chunk_len) data rows of one group's raw bytes."""
    n = int(payload.shape[0])
    clen = chunk_len(n, k)
    if isinstance(payload, np.ndarray):
        rows = np.zeros(k * clen, dtype=np.uint8)
    else:
        import torch

        rows = torch.zeros(k * clen, dtype=torch.uint8, device=payload.device)
    rows[:n] = payload
    return rows.reshape(k, clen)


def encode_rows(data, p: int):
    """(P, chunk_len) parity rows of (K, chunk_len) data rows."""
    k = data.shape[0]
    c = cauchy(k, p)
    if isinstance(data, np.ndarray):
        out = np.zeros((p, data.shape[1]), dtype=np.uint8)
        for i in range(p):
            for j in range(k):
                out[i] ^= np.take(MUL[c[i, j]], data[j])
        return out
    import torch

    mul = torch.from_numpy(MUL).to(data.device)
    out = torch.zeros((p, data.shape[1]), dtype=torch.uint8, device=data.device)
    for j in range(k):
        index = data[j].to(torch.int64)
        for i in range(p):
            out[i] ^= mul[int(c[i, j])][index]
    return out
