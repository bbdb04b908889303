"""The port's item-level codec held against the JAX package's.

``encode_many`` / ``decode_many``, ``plan_cohorts`` and ``encode_batch``
of ``repro_torch.ec.codec`` on the CPU must give byte-identical chunks
and payloads to ``repro.ec.codec`` over mixed-(K, P) cohorts, tail
buckets and empty payloads, with the same systematic fast path (no
launch, no matrix build).  Every comparison is exact equality.
"""

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # dev-only dep (requirements-dev.txt)
    from _hypothesis_stub import given, settings, strategies as st

from repro.ec import codec as jcodec
from repro_torch.core import shapes as tshapes
from repro_torch.ec import codec as tcodec
from repro_torch.kernels import ops as tops

CPU = "cpu"


def _payloads(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in lengths]


def _tc(k, p, **kw):
    return tcodec.ECCodec(k, p, device=CPU, **kw)


def _same_chunks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype.itemsize == 1 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


class TestEncode:
    @given(
        k=st.integers(2, 8),
        p=st.integers(1, 4),
        lengths=st.lists(st.integers(0, 9000), min_size=1, max_size=8),
        seed=st.integers(0, 2**31),
    )
    @settings(max_examples=15, deadline=None)
    def test_property_encode_many_equal(self, k, p, lengths, seed):
        payloads = _payloads(lengths, seed)
        want = jcodec.ECCodec(k, p).encode_many(payloads)
        _same_chunks(_tc(k, p).encode_many(payloads), want)
        _same_chunks([_tc(k, p).encode(pl) for pl in payloads], want)

    @pytest.mark.parametrize("use_kernel", [True, False])
    def test_mixed_kp_batch_equal(self, use_kernel):
        specs = [(3, 2), (6, 3), (3, 2), (4, 2), (6, 3), (3, 1)]
        payloads = _payloads([5000, 100, 0, 8192, 2048, 4096 * 3 + 1], seed=3)
        got = tcodec.encode_batch(specs, payloads, use_kernel=use_kernel, device=CPU)
        _same_chunks(got, jcodec.encode_batch(specs, payloads, use_kernel=use_kernel))

    @pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 3 * 2048 * 9 + 5, 70_001])
    def test_tail_buckets_equal(self, n):
        payload = _payloads([n], seed=n)[0]
        _same_chunks(
            [_tc(3, 1).encode(payload)], [jcodec.ECCodec(3, 1).encode(payload)]
        )

    def test_tensor_and_numpy_payloads(self):
        import torch

        payload = _payloads([4321], seed=8)[0]
        arr = np.frombuffer(payload, dtype=np.uint8)
        want = jcodec.ECCodec(4, 2).encode(payload)
        _same_chunks([_tc(4, 2).encode(arr)], [want])
        _same_chunks([_tc(4, 2).encode(torch.from_numpy(arr.copy()))], [want])

    def test_plan_cohorts_equal(self):
        specs = [(3, 2), (6, 3), (3, 2), (4, 2), (6, 3), (3, 2)]
        assert tcodec.plan_cohorts(specs) == jcodec.plan_cohorts(specs)
        assert tcodec.plan_cohorts([]) == jcodec.plan_cohorts([]) == []

    def test_empty_payloads(self):
        got = _tc(3, 1).encode_many([b"", b"abc", b""])
        want = jcodec.ECCodec(3, 1).encode_many([b"", b"abc", b""])
        _same_chunks(got, want)
        assert tuple(got[0].shape) == (4, 0)
        assert tuple(_tc(4, 2).encode(b"").shape) == (6, 0)


class TestDecode:
    @given(
        k=st.integers(2, 6),
        p=st.integers(1, 3),
        lengths=st.lists(st.integers(0, 6000), min_size=1, max_size=6),
        seed=st.integers(0, 2**31),
    )
    @settings(max_examples=15, deadline=None)
    def test_property_decode_many_equal(self, k, p, lengths, seed):
        rng = np.random.default_rng(seed)
        payloads = _payloads(lengths, seed)
        jc, tc = jcodec.ECCodec(k, p), _tc(k, p)
        parts = []
        for pl, chunks in zip(payloads, jc.encode_many(payloads)):
            keep = np.sort(rng.choice(k + p, size=k, replace=False))
            parts.append((chunks[keep], keep, len(pl)))
        want = jc.decode_many(parts)
        got = tc.decode_many(parts)
        assert [g.numpy().tobytes() for g in got] == want == payloads
        assert [tc.decode(*part).numpy().tobytes() for part in parts] == want

    def test_extra_rows_pick_systematic_first(self):
        payload = _payloads([9999], seed=4)[0]
        chunks = jcodec.ECCodec(4, 2).encode(payload)
        rows = np.array([5, 3, 1, 0, 2])
        want = jcodec.ECCodec(4, 2).decode(chunks[rows], rows, 9999)
        assert _tc(4, 2).decode(chunks[rows], rows, 9999).numpy().tobytes() == want

    def test_too_few_chunks_raise(self):
        chunks = jcodec.ECCodec(4, 2).encode(b"x" * 100)
        with pytest.raises(ValueError):
            _tc(4, 2).decode(chunks[:3], np.arange(3), 100)

    def test_systematic_fast_path_launches_nothing(self):
        """All-systematic items decode with zero launches or matrix work,
        as in the JAX package."""
        payloads = _payloads([4000, 2000], seed=5)
        chunks = jcodec.ECCodec(3, 2).encode_many(payloads)
        rows = np.arange(3)
        tops.reset_matrix_caches()
        tops.reset_launch_stats()
        stats = tshapes.compile_cache_stats()["kernels"]
        before = stats.get(tops.CENSUS_KERNEL, {"calls": 0})["calls"]
        got = _tc(3, 2).decode_many(
            [(c[:3], rows, len(pl)) for c, pl in zip(chunks, payloads)]
        )
        after = tshapes.compile_cache_stats()["kernels"].get(
            tops.CENSUS_KERNEL, {"calls": 0}
        )["calls"]
        assert [g.numpy().tobytes() for g in got] == payloads
        assert after == before
        assert tops.matrix_cache_stats()["decode_builds"] == 0

    def test_groups_by_erasure_pattern(self):
        payloads = _payloads([3000, 3000, 3000], seed=9)
        chunks = jcodec.ECCodec(4, 2).encode_many(payloads)
        rows_a, rows_b = np.array([1, 2, 4, 5]), np.array([0, 2, 3, 5])
        parts = [
            (chunks[0][rows_a], rows_a, 3000),
            (chunks[1][rows_b], rows_b, 3000),
            (chunks[2][rows_a], rows_a, 3000),
        ]
        tops.reset_matrix_caches()
        got = _tc(4, 2).decode_many(parts)
        assert [g.numpy().tobytes() for g in got] == payloads
        assert tops.matrix_cache_stats()["decode_builds"] == 2

    def test_empty_payloads(self):
        payloads = [b"", b"some payload bytes"]
        chunks = jcodec.ECCodec(3, 1).encode_many(payloads)
        keep = np.array([0, 1, 3])
        parts = [(c[keep], keep, len(pl)) for c, pl in zip(chunks, payloads)]
        got = _tc(3, 1).decode_many(parts)
        assert [g.numpy().tobytes() for g in got] == payloads
