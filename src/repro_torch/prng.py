"""``jax.random``'s default PRNG for the port: the part the JAX package calls.

Keys are what jax's key data are: host numpy ``uint32`` arrays of shape
``(..., 2)``, a leading shape holding a stack of keys.
:func:`PRNGKey`, :func:`split` and :func:`fold_in` run in numpy (a few
threefry2x32 hashes, exact and cheap).  :func:`normal` and
:func:`categorical` run on the card through the kernels of
:mod:`repro_torch.kernels.threefry`, and on the CPU only when asked,
through their plain versions.  From the same key they draw what jax 0.9
draws (``jax_threefry_partitionable`` on, its default): the counter of
draw i is the flat index i as (hi, lo) 32-bit words and its word is
``bits1 ^ bits2``; a stack of keys draws as ``jax.vmap`` over them, each
slice counting from 0.

The reference's calls and theirs here: ``PRNGKey(seed)`` (trainer,
serving engine, launcher), ``split`` (every ``init_*``, the serving
loop), ``fold_in`` (whisper's encoder MLP), ``normal`` in f32 through
``dense_init``, ``categorical`` over f32 logits on the last axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import threefry as _threefry

__all__ = [
    "PRNGKey",
    "split",
    "fold_in",
    "normal",
    "categorical",
]


def _hash(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """threefry2x32 in numpy uint32 (wrapping adds) over broadcasting
    arrays.  Keys stay on the host in numpy, never torch, so that splits
    work under ``FakeTensorMode`` (the dry run's traced ``init_params``)."""
    k0, k1, x0, x1 = np.broadcast_arrays(*(np.asarray(a, np.uint32) for a in (k0, k1, x0, x1)))
    shape = x0.shape
    k0, k1, x0, x1 = (np.array(a, np.uint32, ndmin=1) for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0.reshape(shape), x1.reshape(shape)


def _key(key) -> np.ndarray:
    key = np.asarray(key)
    if key.dtype != np.uint32 or key.ndim < 1 or key.shape[-1] != 2:
        raise ValueError(f"a key is uint32 of shape (..., 2), got {key.dtype} {key.shape}")
    return key


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data: ``[0, seed]`` as uint32
    (a negative seed as its 32-bit two's complement), for the int32 seeds
    jax takes without 64-bit mode."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} is outside the int32 range")
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def split(key, num=2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``num`` (an int or a shape) new keys
    per key.  A single key (2,) gives (*num, 2), as jax; a stack (..., 2)
    gives (*num, ..., 2), so that ``split(keys, n)[i]`` is the i-th split
    of every key of the stack (jax's ``vmap`` of ``split``, i first)."""
    key = _key(key)
    shape = (num,) if isinstance(num, int) else tuple(num)
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    lead = key.shape[:-1]
    b0, b1 = _hash(key[..., 0, None], key[..., 1, None],
                   (idx >> np.uint64(32)).astype(np.uint32),
                   (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    out = np.stack([b0, b1], axis=-1)                       # (*lead, n, 2)
    out = np.moveaxis(out, len(lead), 0)                    # (n, *lead, 2)
    return np.ascontiguousarray(out.reshape(*shape, *lead, 2))


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counter
    ``(0, data)`` under ``key`` (every key of a stack)."""
    key = _key(key)
    b0, b1 = _hash(key[..., 0], key[..., 1], np.uint32(0),
                   np.uint32(int(data) & 0xFFFFFFFF))
    return np.stack([b0, b1], axis=-1)


def normal(key, shape, dtype=torch.float32, *, std=None, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, f32)``, times ``f32(std)`` when
    given (a second rounding, as the reference's ``* std``), cast to
    ``dtype``; a stack of keys (..., 2) draws (..., *shape), one leaf a
    key.  On the card (``device=None`` is CUDA) one launch of
    ``threefry_normal`` for the whole stack; ``device="cpu"`` runs the
    plain version; ``device="meta"`` draws nothing."""
    key = _key(key)
    shape = tuple(int(s) for s in shape)
    lead = key.shape[:-1]
    dev = resolve_device(device)
    if dev.type == "meta":
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)
    out_dtype = dtype if dtype in (torch.float32, torch.bfloat16) else torch.float32
    flat = _threefry.threefry_normal(key.reshape(-1, 2), math.prod(shape), out_dtype,
                                     dev, std=std)
    return flat.reshape(*lead, *shape).to(dtype)


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for f32 ``logits``
    (..., V): int64 (...) on their device, through ``gumbel_argmax``
    (the plain version on the CPU)."""
    key = _key(key).reshape(2)
    lead = logits.shape[:-1]
    flat = logits.reshape(-1, logits.shape[-1])
    return _threefry.gumbel_argmax(key, flat).reshape(lead)
