"""The port's ``jax.random`` (``repro_torch.prng``) held against jax 0.9 on
the CPU, through the plain versions of its kernels
(``repro_torch.kernels.ref``).

Every comparison is bit for bit.  ``normal`` is exact too, 100% of draws
at 0 ulp: the plain version repeats XLA's CPU code for it operation for
operation, its fused multiply-adds included (``kernels/ref.py``).  The
golden file ``tests/data/jax_prng_golden.npz`` (what ``chip_smoke.py``
holds the card's kernels to) is held to jax's current output, so a jax
release that moves its draws fails here.
"""

from __future__ import annotations

import concurrent.futures
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gumbel_cases
import jax_prng_golden as golden_mod
from repro_torch import prng
from repro_torch.kernels import ref, threefry

#: the share of f32 normal draws that must be bit-equal to jax's, and the
#: largest difference in ulps allowed (both met exactly: 1.0 and 0).
NORMAL_EQUAL_SHARE = 1.0
NORMAL_MAX_ULP = 0


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint32)


def _bits(key, shape, offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` through the plain version, as int64;
    ``offset`` skips that many words of the flat leaf."""
    return ref.threefry_bits_ref(key, offset, math.prod(shape)).reshape(shape)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in f32 ulps (monotone integer images of the floats)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 2**31 - 1])
def test_prngkey(seed):
    assert np.array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))
    assert prng.PRNGKey(seed).dtype == np.uint32


@pytest.mark.parametrize("num", [2, 5, (3, 4), 96])
def test_split(num):
    key, jkey = prng.PRNGKey(7), jax.random.PRNGKey(7)
    assert np.array_equal(prng.split(key, num), np.asarray(jax.random.split(jkey, num)))


def test_split_of_a_stack_is_the_vmapped_split():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = jax.vmap(lambda k: jax.random.split(k, 6))(keys)        # (4, 6, 2)
    assert np.array_equal(prng.split(np.asarray(keys), 6),
                          np.moveaxis(np.asarray(want), 1, 0))


@pytest.mark.parametrize("data", [0, 1, 7])
def test_fold_in(data):
    key, jkey = prng.PRNGKey(7), jax.random.PRNGKey(7)
    assert np.array_equal(prng.fold_in(key, data), np.asarray(jax.random.fold_in(jkey, data)))
    keys = jax.random.split(jkey, 3)
    assert np.array_equal(prng.fold_in(np.asarray(keys), data),
                          np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, data))(keys)))


def test_fold_in_one_is_the_second_split():
    key = prng.PRNGKey(0)
    assert np.array_equal(prng.fold_in(key, 1), prng.split(key, 2)[1])


SHAPES = [(1,), (7,), (65539,), (1, 1), (7, 1), (1, 65539), (1, 7, 1), (7, 1, 1),
          (1, 1, 65539), (1, 1, 1, 7), (7, 1, 1, 1), (65539, 1, 1, 1)]


@functools.lru_cache(maxsize=None)
def _jax_bits_uniform() -> dict:
    """jax's bits and uniform under ``PRNGKey(42)`` at every shape of
    SHAPES.  jax compiles each shape anew; the shapes are computed on
    threads, since XLA compiles outside the GIL."""
    jkey = jax.random.PRNGKey(42)

    def one(shape):
        return (np.asarray(jax.random.bits(jkey, shape)),
                np.asarray(jax.random.uniform(jkey, shape, jnp.float32)))

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(SHAPES, pool.map(one, SHAPES)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bits_and_uniform(shape):
    want_bits, want_u = _jax_bits_uniform()[shape]
    got = _bits(prng.PRNGKey(42), shape)
    assert tuple(got.shape) == shape
    assert np.array_equal(_u32(got.numpy()), want_bits)
    u = ref.uniform_from_bits_ref(got).numpy()
    assert np.array_equal(u.view(np.int32), want_u.view(np.int32))


def test_bits_offset_is_a_window():
    key = prng.PRNGKey(5)
    whole = _bits(key, (5000,))
    assert torch.equal(_bits(key, (1000,), offset=3000), whole[3000:4000])


@pytest.mark.parametrize("seed", [0, 7])
def test_normal_share_and_ulps(seed):
    """f32 normal at 2^18 draws: every draw bit-equal (the stated bound:
    share ``NORMAL_EQUAL_SHARE``, at most ``NORMAL_MAX_ULP`` ulps)."""
    n = 1 << 18
    got = prng.normal(prng.PRNGKey(seed), (n,), device="cpu").numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32))
    share = float(np.mean(got.view(np.int32) == want.view(np.int32)))
    assert share >= NORMAL_EQUAL_SHARE
    assert int(_ulps(got, want).max()) <= NORMAL_MAX_ULP


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normal_times_std_cast(dtype):
    """The reference's ``dense_init``: ``normal * std`` in f32, then cast."""
    std = 1.0 / np.sqrt(96)
    got = prng.normal(prng.PRNGKey(3), (96, 40), dtype, std=std, device="cpu")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = (jax.random.normal(jax.random.PRNGKey(3), (96, 40), jnp.float32) * std).astype(jdt)
    assert got.dtype == dtype
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_normal_of_a_stack_is_the_vmapped_draw():
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    want = jax.vmap(lambda k: jax.random.normal(k, (3, 17), jnp.float32))(keys)
    got = prng.normal(np.asarray(keys), (3, 17), device="cpu")
    assert tuple(got.shape) == (5, 3, 17)
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


def test_normal_window_and_meta():
    keys = prng.split(prng.PRNGKey(9), 2)
    whole = ref.threefry_normal_ref(keys, 0, 3000, None, torch.float32)
    assert torch.equal(ref.threefry_normal_ref(keys, 1000, 777, None, torch.float32),
                       whole[:, 1000:1777])
    meta = prng.normal(keys, (4, 5), torch.bfloat16, device="meta")
    assert meta.is_meta and tuple(meta.shape) == (2, 4, 5)


@pytest.mark.parametrize("shape", [(4, 256), (2, 3, 50)])
def test_gumbel_and_categorical(shape):
    key, jkey = prng.PRNGKey(11), jax.random.PRNGKey(11)
    g = ref.gumbel_from_bits_ref(_bits(key, shape)).numpy()
    assert np.array_equal(g.view(np.int32),
                          np.asarray(jax.random.gumbel(jkey, shape, jnp.float32)).view(np.int32))
    logits = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 3
    for temperature in (0.7, 1.0):
        scaled = torch.from_numpy(logits) / torch.tensor(temperature, dtype=torch.float32)
        got = prng.categorical(key, scaled).numpy()
        want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits) / temperature,
                                                 axis=-1))
        assert got.shape == shape[:-1]
        assert np.array_equal(got, want)


def test_gumbel_argmax_ties_and_nan():
    """Lowest index on an exact tie, NaN as the maximum (``jnp.argmax``)."""
    key = prng.PRNGKey(0)
    logits = torch.full((3, 40), -1e30)
    logits[0, [5, 9]] = 1e30                   # +noise cannot split them: a tie
    logits[1, 7] = float("nan")
    logits[2, [2, 30]] = float("nan")
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(0), logits.numpy(), axis=-1))
    got = threefry.gumbel_argmax(key, logits).numpy()
    assert got.tolist() == want.tolist() == [5, 7, 2]


@functools.lru_cache(maxsize=None)
def _jax_edge_tokens() -> dict:
    """jax's categorical tokens on every case of ``gumbel_cases`` at both
    temperatures, compiled on threads as ``_jax_bits_uniform`` is."""
    jkey = jax.random.PRNGKey(gumbel_cases.SEED)

    def one(name):
        logits = jnp.asarray(gumbel_cases.case(name)[0])
        return [np.asarray(jax.random.categorical(jkey, logits / t, axis=-1))
                for t in gumbel_cases.TEMPERATURES]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(gumbel_cases.NAMES, pool.map(one, gumbel_cases.NAMES)))


@pytest.mark.parametrize("name", gumbel_cases.NAMES)
def test_categorical_edge_cases(name):
    """The kernel's edge cases (widths about its slice, ties, NaNs and
    ``-inf`` across slices): the plain version equals
    ``jax.random.categorical`` at both temperatures."""
    logits, token = gumbel_cases.case(name)
    key = prng.PRNGKey(gumbel_cases.SEED)
    for temperature, want in zip(gumbel_cases.TEMPERATURES, _jax_edge_tokens()[name]):
        scaled = torch.from_numpy(logits) / torch.tensor(temperature, dtype=torch.float32)
        got = prng.categorical(key, scaled).numpy()
        assert np.array_equal(got, want)
        if token is not None:
            assert got.tolist() == [token] * logits.shape[0]


def test_key_checks():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**31)
    with pytest.raises(ValueError):
        prng.split(np.zeros(2, np.int64))
    with pytest.raises(ValueError):
        threefry.threefry_normal(np.zeros((2, 3), np.uint32), 4, torch.float32, "cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng.normal(prng.PRNGKey(0), (4,))


def test_golden_file_is_jax_output():
    """The committed golden draws equal what this jax computes now."""
    stored, now = golden_mod.load(), golden_mod.golden()
    assert sorted(stored) == sorted(now)
    for name, want in now.items():
        assert stored[name].dtype == want.dtype and np.array_equal(stored[name], want), name


def test_port_equals_golden_file():
    """What ``chip_smoke.py`` checks on the card, here through the plain
    versions."""
    g = golden_mod.load()
    assert np.array_equal(np.stack([prng.PRNGKey(int(s)) for s in g["seeds"]]), g["keys"])
    k7 = prng.PRNGKey(7)
    assert np.array_equal(prng.split(k7), g["split_2"])
    assert np.array_equal(prng.split(k7, 5), g["split_5"])
    assert np.array_equal(prng.split(k7, (3, 4)), g["split_3x4"])
    assert np.array_equal(np.stack([prng.fold_in(k7, int(d)) for d in g["fold_data"]]),
                          g["fold_in"])
    assert np.array_equal(_u32(_bits(k7, (4097,)).numpy()), g["bits"])
    hi, lo = (torch.from_numpy(g["hash_counters"][:, i].astype(np.int64)) for i in (0, 1))
    h0, h1 = ref.threefry2x32_ref(0, 7, hi, lo)
    assert np.array_equal(np.stack([h0.numpy(), h1.numpy()], 1).astype(np.uint32), g["hash"])
    for n in golden_mod.NORMAL_SIZES:
        got = prng.normal(k7, (n,), device="cpu").numpy()
        assert np.array_equal(got.view(np.int32), g[f"normal_{n}"].view(np.int32)), n
    assert np.array_equal(prng.split(prng.PRNGKey(0), golden_mod.STACK[0]), g["stack_keys"])
    got = prng.normal(g["stack_keys"], (golden_mod.STACK[1],), device="cpu").numpy()
    assert np.array_equal(got.view(np.int32), g["normal_stack"].view(np.int32))
    rows, vocab = golden_mod.CATEGORICAL_SHAPES[0]
    logits = torch.from_numpy(golden_mod.categorical_logits(rows, vocab))
    got = np.stack([prng.categorical(prng.PRNGKey(s), logits).numpy()
                    for s in golden_mod.CATEGORICAL_SEEDS])
    assert np.array_equal(got, g[f"categorical_{rows}x{vocab}"])


def test_cuda_kernels_match_plain_and_jax():
    """On a card: both kernels bit-equal to their plain versions and to
    the golden draws (``chip_smoke.py``'s ``[prng]`` does this at full
    width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = golden_mod.load()
    keys = g["stack_keys"]
    got = threefry.threefry_normal(keys, 1024, torch.float32, "cuda")
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy().view(np.int32), g["normal_stack"].view(np.int32))
    for dtype, std in ((torch.float32, None), (torch.bfloat16, 0.02)):
        got = threefry.threefry_normal(keys[:3], 70_001, dtype, "cuda", std=std, offset=5)
        want = ref.threefry_normal_ref(keys[:3], 5, 70_001, std, dtype, "cuda")
        assert torch.equal(got, want)
    logits = torch.from_numpy(golden_mod.categorical_logits(4, 65536)).cuda()
    for seed, want in zip(golden_mod.CATEGORICAL_SEEDS, g["categorical_4x65536"]):
        assert threefry.gumbel_argmax(prng.PRNGKey(seed), logits).cpu().numpy().tolist() \
            == want.tolist()
