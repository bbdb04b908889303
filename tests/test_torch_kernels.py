"""The port's EC byte path held against the JAX package, byte for byte.

Same inputs (numpy, seeded) go through ``repro`` and ``repro_torch``;
every comparison is exact equality (bytes and discrete counters).  The
JAX side runs its Pallas kernel in interpret mode (``pallas=True``) and
its off-TPU XLA twin (the default); the port runs on the CPU, where its
wrapper takes the kernel's plain version.  The CUDA kernel itself is
held against that plain version on the card by ``chip_smoke.py`` and by
``test_cuda_kernel_matches_plain`` (skipped without a card).
"""

import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.ec import gf256 as jgf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.ec import ECCodec
from repro_torch.ec import gf256 as tgf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rs_bitmatmul

CPU = "cpu"


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class TestHostMatrices:
    def test_tables_equal(self):
        np.testing.assert_array_equal(tgf.GF_EXP, jgf.GF_EXP)
        np.testing.assert_array_equal(tgf.GF_LOG, jgf.GF_LOG)

    @pytest.mark.parametrize("k,p", [(2, 1), (3, 1), (3, 2), (4, 2), (6, 3), (10, 4), (16, 4)])
    def test_cauchy_generator_bit_matrices_equal(self, k, p):
        np.testing.assert_array_equal(tgf.cauchy_matrix(p, k), jgf.cauchy_matrix(p, k))
        np.testing.assert_array_equal(
            tgf.generator_matrix(k, p), jgf.generator_matrix(k, p)
        )
        c = jgf.cauchy_matrix(p, k)
        np.testing.assert_array_equal(tgf.gf_to_bitmatrix(c), jgf.gf_to_bitmatrix(c))

    @pytest.mark.parametrize("k,p", [(2, 2), (3, 1), (3, 3), (4, 2)])
    def test_decode_matrices_equal_every_pattern(self, k, p):
        for rows in itertools.combinations(range(k + p), k):
            rows = np.array(rows)
            np.testing.assert_array_equal(
                tgf.decode_matrix(k, p, rows), jgf.decode_matrix(k, p, rows)
            )


class TestOracles:
    @pytest.mark.parametrize("r,k", [(1, 2), (1, 3), (2, 3), (3, 3), (3, 6), (4, 8), (4, 16)])
    def test_bitmatmul_and_gf_matmul_equal(self, r, k):
        rng = np.random.default_rng(r * 10 + k)
        m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        data = rng.integers(0, 256, size=(k, 777), dtype=np.uint8)
        bm = jgf.gf_to_bitmatrix(m)
        want = np.asarray(jref.bitmatmul_ref(bm, data))
        np.testing.assert_array_equal(_np(tref.bitmatmul_ref(bm, data)), want)
        np.testing.assert_array_equal(
            _np(tref.bitmatmul_ref(torch.from_numpy(bm.astype(np.float32)), data)), want
        )
        np.testing.assert_array_equal(
            _np(tref.gf_matmul_ref(m, data)), np.asarray(jref.gf_matmul_ref(m, data))
        )
        np.testing.assert_array_equal(want, jgf.gf_matmul(m, data))

    def test_gf_mul_ref_equal(self):
        a = np.repeat(np.arange(256, dtype=np.uint8), 256)
        b = np.tile(np.arange(256, dtype=np.uint8), 256)
        np.testing.assert_array_equal(
            _np(tref.gf_mul_ref(a, b)), np.asarray(jref.gf_mul_ref(a, b))
        )


class TestEncodeDecode:
    @pytest.mark.parametrize(
        "k,p,nbytes",
        [(2, 1, 2048), (3, 2, 2048), (4, 2, 4096), (6, 3, 2048),
         (8, 2, 6144), (10, 4, 2048), (16, 4, 4096), (3, 1, 70_000)],
    )
    def test_encode_equals_pallas_and_xla(self, k, p, nbytes):
        rng = np.random.default_rng(k * 1000 + p)
        data = rng.integers(0, 256, size=(k, nbytes), dtype=np.uint8)
        got = _np(tops.encode_chunks(data, p, device=CPU))
        np.testing.assert_array_equal(
            got, np.asarray(jops.encode_chunks(data, p, pallas=True))
        )
        np.testing.assert_array_equal(
            got, np.asarray(jops.encode_chunks(data, p, pallas=False))
        )
        np.testing.assert_array_equal(
            _np(tops.encode_chunks(data, p, use_kernel=False, device=CPU)), got
        )

    @pytest.mark.parametrize("nbytes", [1, 7, 100, 2047, 2048, 2049, 10_000])
    def test_unaligned_widths(self, nbytes):
        rng = np.random.default_rng(nbytes)
        data = rng.integers(0, 256, size=(4, nbytes), dtype=np.uint8)
        got = _np(tops.encode_chunks(data, 2, device=CPU))
        assert got.shape == (2, nbytes)
        np.testing.assert_array_equal(
            got, np.asarray(jops.encode_chunks(data, 2, pallas=True))
        )

    @pytest.mark.parametrize("block", [256, 1024, 2048])
    def test_block_sizes(self, block):
        rng = np.random.default_rng(block)
        data = rng.integers(0, 256, size=(5, 4096), dtype=np.uint8)
        got = _np(tops.encode_chunks(data, 3, block_bytes=block, device=CPU))
        np.testing.assert_array_equal(
            got, np.asarray(jops.encode_chunks(data, 3, block_bytes=block, pallas=True))
        )

    @pytest.mark.parametrize(
        "k,p", [(k, p) for k in range(1, 6) for p in range(1, 6) if k + p <= 6]
    )
    def test_decode_every_erasure_pattern(self, k, p):
        rng = np.random.default_rng(100 * k + p)
        data = rng.integers(0, 256, size=(k, 1500), dtype=np.uint8)
        chunks = jgf.gf_matmul(jgf.generator_matrix(k, p), data)
        for rows in itertools.combinations(range(k + p), k):
            rows = np.array(rows)
            got = _np(tops.decode_chunks(chunks[rows], rows, k, p, device=CPU))
            np.testing.assert_array_equal(got, data)
            np.testing.assert_array_equal(
                got,
                np.asarray(jops.decode_chunks(chunks[rows], rows, k, p, pallas=True)),
            )
            np.testing.assert_array_equal(
                got, np.asarray(jops.decode_chunks(chunks[rows], rows, k, p))
            )

    def test_many_equals_reference_many(self):
        rng = np.random.default_rng(3)
        datas = [rng.integers(0, 256, size=(4, n), dtype=np.uint8) for n in (3000, 0, 17, 4096)]
        got = tops.encode_chunks_many(datas, 2, device=CPU)
        want = jops.encode_chunks_many(datas, 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        rows = [np.array([1, 2, 4, 5]), np.array([0, 2, 3, 5]), np.array([1, 2, 4, 5])]
        full = [jgf.gf_matmul(jgf.generator_matrix(4, 2), d) for d in datas[:1] + datas[2:]]
        surv = [f[r] for f, r in zip(full, rows)]
        got = tops.decode_chunks_many(surv, rows, 4, 2, device=CPU)
        want = jops.decode_chunks_many(surv, rows, 4, 2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


class TestCachesAndCounters:
    def _drive(self, ops_mod, **kw):
        rng = np.random.default_rng(9)
        data = rng.integers(0, 256, size=(4, 3000), dtype=np.uint8)
        ops_mod.reset_matrix_caches()
        for _ in range(3):
            ops_mod.encode_chunks(data, 2, **kw)
        ops_mod.encode_chunks_many([data, data], 2, **kw)
        chunks = jgf.gf_matmul(jgf.generator_matrix(4, 2), data)
        for rows in ([1, 2, 4, 5], [0, 2, 3, 5], [1, 2, 4, 5]):
            r = np.array(rows)
            ops_mod.decode_chunks(chunks[r], r, 4, 2, **kw)
        return ops_mod.matrix_cache_stats()

    def test_matrix_cache_stats_equal(self):
        assert self._drive(tops, device=CPU) == self._drive(jops)

    def test_cpu_calls_launch_nothing(self):
        before = rs_bitmatmul.launches
        tops.reset_launch_stats()
        tops.encode_chunks(np.ones((3, 5000), np.uint8), 1, device=CPU)
        assert rs_bitmatmul.launches == before
        assert tops.launch_stats() == {"encode": 0, "decode": 0}

    def test_kernel_wrapper_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            rs_bitmatmul.gf_bitmatmul(
                torch.zeros((15, 16), dtype=torch.uint8),
                torch.zeros((2, 2048), dtype=torch.uint8),
            )
        with pytest.raises(ValueError):
            rs_bitmatmul.gf_bitmatmul(
                torch.zeros((8, 24), dtype=torch.uint8),
                torch.zeros((2, 2048), dtype=torch.uint8),
            )


class TestDevices:
    def test_cuda_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        data = np.zeros((3, 100), np.uint8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.encode_chunks(data, 1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tops.encode_chunks(data, 1, device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ECCodec(3, 1).encode(b"abc")

    def test_cuda_kernel_matches_plain(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernel has no CPU mode")
        rng = np.random.default_rng(0)
        for r, k, b in [(1, 3, 4096), (3, 3, 4097), (16, 16, 2048), (9, 5, 33)]:
            m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
            bm = torch.from_numpy(jgf.gf_to_bitmatrix(m)).cuda()
            d = torch.from_numpy(rng.integers(0, 256, size=(k, b), dtype=np.uint8)).cuda()
            got = rs_bitmatmul.gf_bitmatmul(bm, d)
            torch.cuda.synchronize()
            assert torch.equal(got, tref.bitmatmul_ref(bm, d))


def test_import_hygiene():
    """Importing every port module loads no jax and nothing of ``repro``."""
    code = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for n in names:
    importlib.import_module(n)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "repro") or m.startswith("jax")
)
print(len(names), bad)
assert not bad, bad
"""
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=env,
    )
    assert out.returncode == 0, out.stderr + out.stdout
    n_modules = int(out.stdout.split()[0])
    # every module of the port so far: a module dropped from the package
    # fails here
    assert n_modules >= 70
