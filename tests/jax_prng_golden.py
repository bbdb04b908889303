"""Golden draws of ``jax.random`` for the port's PRNG (``repro_torch.prng``).

``golden()`` computes them with jax on the CPU; ``tests/data/jax_prng_golden.npz``
holds what it gave under jax 0.9.0.  ``tests/test_torch_prng.py`` holds the
file to jax's current output (a jax release that moves its draws fails
there) and the port to the file; ``chip_smoke.py`` holds the card's kernels
to the file without importing jax.  Rewrite the file with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/jax_prng_golden.py
"""

from __future__ import annotations

import pathlib

import numpy as np

PATH = pathlib.Path(__file__).resolve().parent / "data" / "jax_prng_golden.npz"

SEEDS = (0, 1, 7, 42, 2**31 - 1)
FOLD_DATA = (0, 1, 7, 12345)
NORMAL_SIZES = (1, 7, 4097, 65539)
#: a stacked leaf: one key a slice, as ``jax.vmap`` over ``split`` draws it.
STACK = (36, 1024)
#: counters with a high word, hashed under PRNGKey(7).
HASH_COUNTERS = ((0, 0), (0, 1), (1, 0), (3, 0xFFFFFFFF), (0xFFFFFFFF, 12))
CATEGORICAL_SHAPES = ((4, 256), (4, 65536), (4, 151936))
CATEGORICAL_SEEDS = (0, 3)


def categorical_logits(rows: int, vocab: int) -> np.ndarray:
    """Exact f32 logits in [0, 16) from integer hashing (no RNG, so every
    numpy and every machine makes the same ones)."""
    idx = np.arange(rows * vocab, dtype=np.uint64).reshape(rows, vocab)
    return (((idx * np.uint64(2654435761)) % np.uint64(65536)).astype(np.float32)
            / np.float32(4096.0))


def golden() -> dict[str, np.ndarray]:
    import jax
    import jax.extend.random as jr
    import jax.numpy as jnp

    k7 = jax.random.PRNGKey(7)
    out = {
        "seeds": np.array(SEEDS, np.int64),
        "keys": np.stack([np.asarray(jax.random.PRNGKey(s)) for s in SEEDS]),
        "split_2": np.asarray(jax.random.split(k7)),
        "split_5": np.asarray(jax.random.split(k7, 5)),
        "split_3x4": np.asarray(jax.random.split(k7, (3, 4))),
        "fold_data": np.array(FOLD_DATA, np.int64),
        "fold_in": np.stack([np.asarray(jax.random.fold_in(k7, d)) for d in FOLD_DATA]),
        "bits": np.asarray(jax.random.bits(k7, (4097,))),
        "hash_counters": np.array(HASH_COUNTERS, np.uint32),
    }
    hi, lo = out["hash_counters"].T
    h0, h1 = jr.threefry_2x32(k7, jnp.concatenate([jnp.asarray(hi), jnp.asarray(lo)])).reshape(2, -1)
    out["hash"] = np.stack([np.asarray(h0), np.asarray(h1)], axis=1)
    for n in NORMAL_SIZES:
        out[f"normal_{n}"] = np.asarray(jax.random.normal(k7, (n,), jnp.float32))
    stack_keys = jax.random.split(jax.random.PRNGKey(0), STACK[0])
    out["stack_keys"] = np.asarray(stack_keys)
    out["normal_stack"] = np.asarray(
        jax.vmap(lambda k: jax.random.normal(k, (STACK[1],), jnp.float32))(stack_keys))
    for rows, vocab in CATEGORICAL_SHAPES:
        logits = categorical_logits(rows, vocab)
        out[f"categorical_{rows}x{vocab}"] = np.stack([
            np.asarray(jax.random.categorical(jax.random.PRNGKey(s), logits, axis=-1))
            for s in CATEGORICAL_SEEDS]).astype(np.int64)
    return out


def load() -> dict[str, np.ndarray]:
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    PATH.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PATH, **golden())
    print(PATH, PATH.stat().st_size, "bytes")
