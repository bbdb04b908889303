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
* :func:`threefry_normal_ref` and :func:`gumbel_argmax_ref` are the plain
  versions of the two kernels in :mod:`repro_torch.kernels.threefry`:
  ``jax.random``'s threefry2x32 counter hash in int64 ops masked to 32
  bits, and the f32 arithmetic XLA's CPU backend compiles for
  ``normal`` and ``gumbel`` (its ``log``, ``log1p`` and ``erf_inv``
  expansions, operation for operation, with the multiply-adds its code
  generator fuses done as one rounding), so that the draws are
  ``jax.random``'s bit for bit.
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
    "threefry2x32_ref",
    "threefry_bits_ref",
    "uniform_from_bits_ref",
    "normal_from_bits_ref",
    "gumbel_from_bits_ref",
    "threefry_normal_ref",
    "gumbel_argmax_ref",
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


# ---------------------------------------------------------------------------
# jax.random's threefry2x32 draws
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

# The f32 constants of XLA's CPU expansions, as the compiled code holds them.
# log (Cephes): x * (c0 + x * (...)) in three interleaved Horner chains.
_LOG_P = tuple(float.fromhex(h) for h in (
    "0x1.204376p-4", "-0x1.d7a37p-4", "-0x1.fcba9ep-4", "0x1.23d37ep-3",
    "0x1.999d58p-3", "-0x1.fffff8p-3", "0x1.de4a34p-4", "-0x1.555cap-3",
    "0x1.555554p-2"))
_LOG_Q1 = float.fromhex("-0x1.bd0106p-13")    # -2.12194440e-4
_LOG_Q2 = float.fromhex("0x1.63p-1")          # 0.693359375
_SQRTHF = float.fromhex("0x1.6a09e6p-1")      # sqrt(0.5)
_TINY = float.fromhex("0x1p-126")
# log1p's rational approximation for |x| < sqrt(2) - 1.
_LOG1P_SMALL = float.fromhex("0x1.a8279ap-2")
_LOG1P_DEN = tuple(float.fromhex(h) for h in (
    "0x1.e2035ap+3", "0x1.4c30b6p+6", "0x1.bb865ap+7", "0x1.351946p+8",
    "0x1.b0db14p+7", "0x1.e0f304p+5"))
_LOG1P_NUM = tuple(float.fromhex(h) for h in (
    "0x1.7bc096p-15", "0x1.fe818ap-2", "0x1.a509f4p+2", "0x1.de9738p+4",
    "0x1.e798ecp+5", "0x1.c8e75ap+5", "0x1.40a202p+4"))
# erf_inv (Giles' single-precision polynomial), w < 5 and w >= 5.
_ERFINV_LT5 = tuple(float.fromhex(h) for h in (
    "0x1.e2cb1p-26", "0x1.70966cp-22", "-0x1.d8e6aep-19", "-0x1.26b582p-18",
    "0x1.ca65b6p-13", "-0x1.48a81p-10", "-0x1.11c9dep-8", "0x1.f91ec6p-3",
    "0x1.805c5ep+0"))
_ERFINV_GE5 = tuple(float.fromhex(h) for h in (
    "-0x1.a3e136p-13", "0x1.a76ad6p-14", "0x1.61b8e4p-10", "-0x1.e17bcep-9",
    "0x1.7824f6p-8", "-0x1.f38baep-8", "0x1.354afcp-7", "0x1.006db6p+0",
    "0x1.6a9efcp+1"))
_SQRT2 = float.fromhex("0x1.6a09e6p+0")
_NORMAL_LO = float.fromhex("-0x1.fffffep-1")  # nextafter(-1, 0) in f32


def threefry2x32_ref(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """jax's threefry2x32 hash of the counter pairs ``(x0, x1)`` under the
    key ``(k0, k1)``: 20 rounds, a key injection every 4.  ``x0``, ``x1``
    are int64 tensors holding 32-bit words; so are the two results.  The
    key words are ints or int64 tensors that broadcast against them (a
    key a row)."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ _KS_PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_bits_ref(key, offset: int, count: int, device=None) -> torch.Tensor:
    """``jax.random.bits``'s 32-bit words ``offset .. offset + count - 1``
    of a leaf drawn under ``key`` (partitionable threefry: the counter is
    the flat index as (hi, lo) words, the word ``bits1 ^ bits2``), as
    int64 on ``device``."""
    idx = torch.arange(offset, offset + count, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32_ref(int(key[0]), int(key[1]), idx >> 32, idx & _M32)
    return b0 ^ b1


def _f32_of_bits(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32).view(torch.float32)


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, as a fused multiply-add gives.
    The product of two f32 values is exact in f64, so only the f64 sum
    rounds.  Rounding that sum to f32 again is the correctly rounded
    result unless it landed exactly on an f32 midpoint (or in the f32
    subnormal range); those few elements are redone with the sum rounded
    to odd (a TwoSum error term nudges an inexact, even sum one f64 ulp
    towards the true sum), which makes the final rounding exact."""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else b
    c64 = c.double() if isinstance(c, torch.Tensor) else torch.full(
        (), c, dtype=torch.float64, device=a.device)
    s = a64 * b64 + c64
    sb = s.view(torch.int64)
    # the 29 f64 mantissa bits below an f32's last bit: 1 then zeros
    redo = ((sb & 0x1FFFFFFF) == 0x10000000) | (s.abs() < _TINY)
    if bool(redo.any()):
        i = redo.nonzero(as_tuple=True)
        ai = a64.expand_as(s)[i]
        bi = b64.expand_as(s)[i] if isinstance(b64, torch.Tensor) else b64
        ci = c64.expand_as(s)[i]
        p = ai * bi
        si = p + ci
        bv = si - ci
        err = (p - (si - bv)) + (ci - bv)
        sib = si.view(torch.int64)
        nudge = (err != 0) & ((sib & 1) == 0)
        away = (err > 0) == (si > 0)
        sib = torch.where(nudge, torch.where(away, sib + 1, sib - 1), sib)
        s = s.clone()
        s[i] = sib.view(torch.float64)
    return s.float()


def _xla_log(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` on the CPU: the exponent split off, the mantissa
    folded into [sqrt(0.5), sqrt(2)), a degree-9 polynomial in three
    chains; 0 -> -inf, inf -> inf, negative or NaN -> NaN (all bits set)."""
    tiny = _const(_TINY, v)
    vv = torch.where(v > _TINY, v, tiny)
    b = vv.view(torch.int32)
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((b >> 23) - 127).float() + 1.0
    lt = m < _SQRTHF
    x = (m - 1.0) + torch.where(lt, m, torch.zeros_like(m))
    e = e - lt.float()
    z = x * x
    z3 = z * x
    p, x64, z3 = _LOG_P, x.double(), z3.double()    # f64 copies: exact
    q0 = _fma(_fma(x, p[0], p[1]), x64, p[6])
    q1 = _fma(_fma(x, p[2], p[3]), x64, p[7])
    q2 = _fma(_fma(x, p[4], p[5]), x64, p[8])
    r = _fma(_fma(_fma(q0, z3, q1), z3, q2), z3, e * _LOG_Q1)
    out = _fma(e, _LOG_Q2, (x - z * 0.5) + r)
    nan = torch.full((), -1, dtype=torch.int32, device=v.device).view(torch.float32)
    out = torch.where(v > 0, out, nan)
    out = torch.where(v == 0, _const(float("-inf"), v), out)
    return torch.where(v == float("inf"), _const(float("inf"), v), out)


def _xla_log1p(y: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log1p`` on the CPU: Cephes' rational approximation for
    |y| < sqrt(2) - 1, else ``log(1 + y)``; each branch computed on its
    own elements only (gathered by index: a boolean-mask gather takes
    torch's intra-op pool even at a few thousand elements)."""
    shape, y = y.shape, y.reshape(-1)
    small = y.abs() < _LOG1P_SMALL
    si, li = small.nonzero().squeeze(1), (~small).nonzero().squeeze(1)
    out = torch.empty_like(y)
    out.index_copy_(0, li, _xla_log(y.index_select(0, li) + 1.0))
    y = y.index_select(0, si)
    y2, y64 = y * y, y.double()
    den = torch.ones_like(y)
    for c in _LOG1P_DEN:
        den = _fma(den, y64, c)
    num = torch.full_like(y, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, y64, c)
    ratio = (num.double() / den.double()).float()     # one rounding, as f32 div
    out.index_copy_(0, si, y + _fma(y2, -0.5, (y * y2) * ratio))
    return out.reshape(shape)


def _erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv``: ``w = -log1p(-u*u)``, a 9-term Horner
    polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times ``u``."""
    lg = _xla_log1p(u * (-u))
    lt = lg > -5.0
    # sqrt only where w >= 5 (|u| near 1, under 1% of draws): torch's
    # sqrt takes its intra-op pool above 2,048 elements
    ge = (~lt).reshape(-1).nonzero().squeeze(1)
    root = torch.zeros_like(lg).reshape(-1)
    root.index_copy_(0, ge, torch.sqrt((-lg.reshape(-1).index_select(0, ge)).double())
                     .float())                       # one rounding, as f32 sqrt
    root = root.reshape(lg.shape)
    w = torch.where(lt, -2.5 - lg, root - 3.0)
    p = torch.where(lt, _const(_ERFINV_LT5[0], u), _const(_ERFINV_GE5[0], u))
    w64 = w.double()
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w64, torch.where(lt, _const(a, u), _const(b, u)))
    p = torch.where(u.abs() == 1.0, _const(float("inf"), u), p)
    return u * p


def uniform_from_bits_ref(b: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1): the word's top 23 bits as a mantissa over 1.0, minus 1."""
    return _f32_of_bits((b >> 9) | 0x3F800000) - 1.0


def normal_from_bits_ref(b: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s f32 draw from its word: uniform on
    [nextafter(-1, 0), 1), then ``sqrt(2) * erf_inv``."""
    lo = _const(_NORMAL_LO, b)
    u = torch.maximum(_fma(uniform_from_bits_ref(b), 2.0, lo), lo)
    return _erf_inv(u) * _SQRT2


def gumbel_from_bits_ref(b: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s f32 draw from its word: -log(-log(u)),
    u uniform on [tiny, 1)."""
    u = torch.maximum(uniform_from_bits_ref(b), _const(_TINY, b))
    return -_xla_log(-_xla_log(u))


def _chunk(device: torch.device) -> int:
    """Draws a slice: on the CPU below torch's intra-op grain (32,768
    elements), so that each of the slice's hundreds of short elementwise
    ops runs on the calling thread (with several processes sharing the
    cores, an intra-op pool a process oversubscribes them: six processes
    on 8 cores took 27 s a million draws with 8 threads each, 0.6 s on
    one) and its temporaries stay in cache."""
    return 1 << 24 if device.type == "cuda" else 1 << 14


def threefry_normal_ref(keys, offset: int, count: int, std, dtype,
                        device=None) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.threefry.threefry_normal`.

    ``keys``: (n_keys, 2) uint32 (numpy) -> (n_keys, count) ``dtype`` on
    ``device``: row k holds draws ``offset .. offset + count - 1`` of
    ``jax.random.normal(keys[k], shape, f32)`` (flat), times ``f32(std)``
    when ``std`` is not None, cast round-to-nearest-even.  Draw i depends
    only on (key, i), so any window of a leaf can be recomputed alone.
    Works on every key at once, in slices of the count that bound the
    int64 temporaries."""
    keys = np.asarray(keys, dtype=np.uint32).reshape(-1, 2)
    dev = torch.device("cpu" if device is None else device)
    n_keys = keys.shape[0]
    out = torch.empty((n_keys, count), dtype=dtype, device=dev)
    k = torch.from_numpy(keys.astype(np.int64)).to(dev)
    step = max(1, _chunk(dev) // max(n_keys, 1))
    for lo in range(0, count, step):
        n = min(step, count - lo)
        idx = torch.arange(offset + lo, offset + lo + n, dtype=torch.int64, device=dev)
        b0, b1 = threefry2x32_ref(k[:, :1], k[:, 1:], idx >> 32, idx & _M32)
        z = normal_from_bits_ref((b0 ^ b1).reshape(-1)).view(n_keys, n)
        if std is not None:
            z = z * float(np.float32(std))
        out[:, lo:lo + n] = z.to(dtype)
    return out


def gumbel_argmax_ref(key, logits: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.threefry.gumbel_argmax`.

    ``jax.random.categorical(key, logits, axis=-1)`` for (B, V) f32
    ``logits``: ``argmax(gumbel(key, (B, V)) + logits)`` per row, the
    lowest index on a tie and NaN counted as the maximum, as
    ``jnp.argmax``; (B,) int64 on the logits' device."""
    b, v = logits.shape
    g = torch.empty((b * v,), dtype=torch.float32, device=logits.device)
    step = _chunk(logits.device)
    for lo in range(0, b * v, step):
        n = min(step, b * v - lo)
        g[lo:lo + n] = gumbel_from_bits_ref(threefry_bits_ref(key, lo, n, logits.device))
    return torch.argmax(g.view(b, v) + logits, dim=-1)
