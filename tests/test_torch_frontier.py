"""The parity-frontier kernel's plain version held against the JAX package.

``repro_torch.kernels.pb_frontier.frontier`` on CPU tensors runs its
plain version (``kernels.ref.pb_frontier_ref``); it must equal the JAX
package's numpy ``ParityFrontier.upto_many`` and its in-jit
``greedy_kernel._prefix_frontier`` *exactly* (integer outputs), on
hypothesis-drawn probabilities and on ulp-tight targets set to a CDF
value the DP itself produces.  ``batch_pr_avail_exact`` is held against
the JAX function in 64-bit mode within 1e-15 absolute: the final
sum over ``parity + 1`` entries is torch's reduction against XLA's, and
the CDF lies in [0, 1], so the two may differ in the last ulp (2.2e-16
at 1.0).  The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py`` and by ``test_cuda_kernel_matches_plain``
(skipped without a card).

The JAX package's jitted programs are loaded as in
``test_torch_decisions.py`` (``load_jax_x64``): this jax names the
scoped 64-bit switch ``jax.enable_x64``, not ``jax.experimental.enable_x64``.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # dev-only dep (requirements-dev.txt)
    from _hypothesis_stub import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.core import reliability as jrel
from repro_torch.core import prefilter, shapes
from repro_torch.core import reliability as trel
from repro_torch.core.sc_kernel import _shape_plan
from repro_torch.kernels import pb_frontier, ref
from test_torch_decisions import load_jax_x64

F64 = torch.float64


def _frontier(probs_rows, targets, n_starts, L_live=None, width=None):
    p = torch.from_numpy(np.asarray(probs_rows, dtype=np.float64))
    t = torch.tensor(targets, dtype=F64)
    L = p.shape[1]
    return pb_frontier.frontier(
        p, t, n_starts, L if L_live is None else L_live, L + 1 if width is None else width
    ).numpy()


def _as_upto_many(mp_row: np.ndarray) -> np.ndarray:
    """(S, L) kernel layout (by window end) -> upto_many layout (by
    window length - 1), -1 past the end."""
    S, L = mp_row.shape
    out = np.full((S, L), -1, dtype=np.int64)
    for s in range(S):
        out[s, : L - s] = mp_row[s, s:]
    return out


def _cdf_values(probs: np.ndarray) -> list[float]:
    """Every running-sum CDF value the start-0 DP produces, computed the
    oracle's way (numpy DP step, left-to-right cumsum)."""
    L = probs.shape[0]
    dp = np.zeros(L + 1)
    dp[0] = 1.0
    vals = []
    for pi in probs:
        nd = dp * (1.0 - pi)
        nd[1:] += dp[:-1] * pi
        dp = nd
        vals.extend(float(v) for v in np.cumsum(dp)[: L])
    return vals


def _scale_lane_probs(L: int, seed: int) -> np.ndarray:
    """Fail probabilities like the 10,000-node scale lane's: AFR uniform in
    [0.001, 0.1], 365-day retention (parities in the tens at L ~ 300)."""
    rng = np.random.default_rng(seed)
    return jrel.pr_failure(rng.uniform(0.001, 0.1, L), 1.0)


def _truncated(up: np.ndarray, width: int) -> np.ndarray:
    """``upto_many`` under a DP row of ``width`` entries: mass only moves up
    the row, so the CDF below ``width`` is unchanged, and a parity above
    ``width - 1`` becomes infeasible."""
    return np.where(up <= width - 1, up, -1)


class TestPlainVersion:
    @given(
        probs=st.lists(st.floats(0.0, 1.0), min_size=1, max_size=12),
        target=st.floats(0.5, 0.9999999),
    )
    @settings(max_examples=60, deadline=None)
    def test_equals_upto_many(self, probs, target):
        p = np.array(probs)
        L = len(p)
        got = _frontier(p[None], [target], L)[0]
        np.testing.assert_array_equal(
            _as_upto_many(got), jrel.ParityFrontier(p, target).upto_many()
        )

    @given(
        probs=st.lists(st.floats(0.0, 0.6), min_size=2, max_size=10),
        pick=st.integers(0, 10_000),
        nudge=st.sampled_from([-1, 0, 1]),
    )
    @settings(max_examples=60, deadline=None)
    def test_ulp_tight_targets(self, probs, pick, nudge):
        # The target is a CDF value the DP produces (or one ulp either
        # side): the compare is decided by the last bit of the sum.
        p = np.array(probs)
        vals = [v for v in _cdf_values(p) if 0.0 < v < 1.0] or [0.5]
        t = float(vals[pick % len(vals)])
        t = float(np.nextafter(t, np.inf if nudge > 0 else -np.inf)) if nudge else t
        got = _frontier(p[None], [t], len(p))[0]
        np.testing.assert_array_equal(
            _as_upto_many(got), jrel.ParityFrontier(p, t).upto_many()
        )

    @pytest.mark.parametrize("L,S", [(2, 1), (3, 2), (17, 1), (17, 8), (17, 16), (40, 8)])
    def test_batched_rows_and_start_subsets(self, L, S):
        rng = np.random.default_rng(L * 31 + S)
        targets = [0.5, 0.99, 0.999, 0.9999999]
        probs = rng.uniform(0.0, 0.3, size=(len(targets), L))
        got = _frontier(probs, targets, S)
        for b, t in enumerate(targets):
            want = jrel.ParityFrontier(probs[b], t).upto_many(n_starts=S)
            np.testing.assert_array_equal(_as_upto_many(got[b]), want)

    @pytest.mark.parametrize("L,L_live", [(16, 10), (24, 24), (80, 65)])
    def test_prefix_rows_equal_jax_prefix_frontier(self, L, L_live):
        # The S = 1 call the greedy scorers make, against the JAX
        # package's in-jit DP (live-count mask and padded tail included).
        jgreedy = load_jax_x64("greedy_kernel")
        rng = np.random.default_rng(L + L_live)
        for t in (0.9, 0.999, 0.9999999):
            probs = np.zeros(L)
            probs[:L_live] = rng.uniform(0.0, 0.2, size=L_live)
            got = _frontier(probs[None], [t], 1, L_live=L_live)[0, 0]
            with jax.enable_x64(True):
                want = np.asarray(
                    jgreedy._prefix_frontier(
                        jnp.asarray(probs), jnp.float64(t), L_live, L + 1, L
                    )
                )
            np.testing.assert_array_equal(got, want)

    def test_width_bounds_the_parity(self):
        # The greedy exact region's call: width EXACT + 1 over the first
        # EXACT steps; beyond the live count every entry is -1.
        rng = np.random.default_rng(5)
        probs = rng.uniform(0.0, 0.1, size=(2, 64))
        got = _frontier(probs, [0.99, 0.999999], 1, L_live=50, width=65)
        for b, t in enumerate((0.99, 0.999999)):
            want = jrel.ParityFrontier(probs[b, :50], t).upto(50)
            want_many = jrel.ParityFrontier(probs[b, :50], t).upto_many(n_starts=1)[0]
            np.testing.assert_array_equal(got[b, 0, :50], want_many)
            assert (got[b, 0, 50:] == -1).all()
            assert got[b, 0, :50].tolist() == want.tolist()

    def test_degenerate_and_empty(self):
        for probs in ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0, 1.0], [1.0]):
            p = np.array(probs)
            for t in (0.5, 0.999999):
                got = _frontier(p[None], [t], len(p))[0]
                np.testing.assert_array_equal(
                    _as_upto_many(got), jrel.ParityFrontier(p, t).upto_many()
                )
        assert _frontier(np.zeros((0, 4)), [], 2).shape == (0, 2, 4)

    def test_rejects_bad_arguments(self):
        p = torch.zeros((2, 4), dtype=F64)
        t = torch.zeros(2, dtype=F64)
        with pytest.raises(TypeError):
            pb_frontier.frontier(p.float(), t, 1, 4, 5)
        with pytest.raises(ValueError):
            pb_frontier.frontier(p, t[:1], 1, 4, 5)
        with pytest.raises(ValueError):
            pb_frontier.frontier(p, t, 0, 4, 5)

    def test_cpu_calls_count_no_launch(self):
        pb_frontier.reset_launches()
        _frontier(np.full((1, 5), 0.1), [0.9], 2)
        assert pb_frontier.launches == 0

    @pytest.mark.parametrize("W", [301, 65, 33, 17])
    def test_realistic_parities_equal_upto_many(self, W):
        # Scale-lane-like probabilities at L = 300 (parities in the tens),
        # every start up to 4, untruncated (301) and truncated rows: at 33
        # and 17 the truncation cuts parities the full row reaches.
        L, S = 300, 4
        probs = _scale_lane_probs(L, seed=W)
        targets = [0.99, 0.999, 0.999999]
        got = _frontier(np.tile(probs, (3, 1)), targets, S, width=W)
        cut = False
        for b, t in enumerate(targets):
            up = jrel.ParityFrontier(probs, t).upto_many(n_starts=S)
            np.testing.assert_array_equal(_as_upto_many(got[b]), _truncated(up, W))
            assert up.max() >= 20
            cut |= bool((up > W - 1).any())
        assert cut == (W < 65)

    def test_cuda_kernel_matches_plain(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernel has no CPU mode")
        rng = np.random.default_rng(0)
        for L, S in [(2, 1), (17, 16), (65, 8), (300, 1), (1300, 2)]:
            p = torch.from_numpy(rng.uniform(0.0, 0.2, size=(3, L))).cuda()
            t = torch.tensor([0.5, 0.99, 0.9999999], dtype=F64, device="cuda")
            got = pb_frontier.frontier(p, t, S, L, L + 1)
            torch.cuda.synchronize()
            assert torch.equal(got, ref.pb_frontier_ref(p, t, S, L, L + 1))
        # Realistic parities, truncated rows, and an ulp-tight target with
        # its nextafter neighbours, on every register width the callers use.
        probs = _scale_lane_probs(300, seed=1)
        for W in (301, 65, 33, 17):
            vals = [v for v in _cdf_values(probs[:W]) if 0.99 < v < 1.0] or [0.999]
            tight = vals[len(vals) // 2]
            targets = [0.99, 0.999, tight, np.nextafter(tight, -np.inf),
                       np.nextafter(tight, np.inf)]
            p = torch.from_numpy(np.tile(probs, (5, 1))).cuda()
            t = torch.tensor(targets, dtype=F64, device="cuda")
            for S in (1, 8):
                got = pb_frontier.frontier(p, t, S, 300, W)
                torch.cuda.synchronize()
                assert torch.equal(got, ref.pb_frontier_ref(p, t, S, 300, W)), (W, S)
        # The register variant's rarer block paths, forced by a small staged
        # K (replays, lane-order scans), and rows whose parities pass the
        # 128-entry first pass (the full-width rerun).
        p = torch.from_numpy(np.tile(probs, (4, 1))).cuda()
        t = torch.tensor([0.99, 0.999, 0.99999, 0.5], dtype=F64, device="cuda")
        want = ref.pb_frontier_ref(p, t, 8, 300, 301)
        base = pb_frontier.plan(32, 301, *pb_frontier.device_limits(p.device))
        for stage_k, guard in [(9, 0), (41, pb_frontier.STAGE_GUARD), (1, 0)]:
            forced = dataclasses.replace(base, stage_k=stage_k, guard=guard,
                                         shared_bytes=base.rows_per_block * 256 * stage_k)
            got = pb_frontier.frontier(p, t, 8, 300, 301, launch=forced)
            torch.cuda.synchronize()
            assert torch.equal(got, want), forced
        p = torch.from_numpy(rng.uniform(0.3, 0.6, size=(2, 300))).cuda()
        t = torch.tensor([0.99, 0.999], dtype=F64, device="cuda")
        want = ref.pb_frontier_ref(p, t, 4, 300, 301)
        assert int(want.max()) >= 128
        assert torch.equal(pb_frontier.frontier(p, t, 4, 300, 301), want)


class TestLaunchPlan:
    """The launch plan is pure Python: the variant it picks must hold its
    limits for every width the callers issue."""

    H100 = (132, 232_448)   # SMs, opt-in shared bytes per block

    @staticmethod
    def _check(pl, n_rows, width, max_shared):
        assert 1 <= pl.rows_per_block <= pb_frontier.MAX_ROWS_PER_BLOCK
        assert pl.threads == 32 * pl.rows_per_block
        assert pl.blocks * pl.rows_per_block >= n_rows > (pl.blocks - 1) * pl.rows_per_block
        if pl.variant == "registers":
            assert pl.chunk in pb_frontier.REG_CHUNKS and 32 * pl.chunk >= width
            # 32 staged slots a row, odd stride, at least the whole row or
            # the guard's worth above the scale lane's parities (~70).
            assert pl.stage_k % 2 == 1 and pl.stage_k >= min(width, 200)
            assert pl.shared_bytes == 32 * 8 * pl.stage_k * pl.rows_per_block <= max_shared
            assert pl.guard == pb_frontier.STAGE_GUARD
            smaller = [c for c in pb_frontier.REG_CHUNKS if c < pl.chunk]
            assert not smaller or 32 * max(smaller) < width
        else:
            assert pl.variant == "shared" and pl.chunk == 0
            assert width > 32 * max(pb_frontier.REG_CHUNKS)
            assert pl.shared_bytes == 16 * width * pl.rows_per_block <= max_shared

    @pytest.mark.parametrize(
        "live", [2, 10, 16, 17, 64, 65, 300, 1024, prefilter.sc_cap(1024), 4000, 10_000]
    )
    @pytest.mark.parametrize("batch", [1, 8, 64])
    def test_sc_widths(self, live, batch):
        # D-Rex SC: W = L_pad + 1 over S_pad starts, for live counts up to
        # the pre-filter cap and up to node_pad(10 000) unfiltered.
        S, L_pad = _shape_plan(live, 1024)
        pl = pb_frontier.plan(batch * S, L_pad + 1, *self.H100)
        self._check(pl, batch * S, L_pad + 1, self.H100[1])
        if live <= prefilter.sc_cap(1024):
            assert pl.variant == "registers"

    @pytest.mark.parametrize("live", [8, 33, 64, 65, 256, 1096, 4096, 10_000])
    def test_greedy_widths(self, live):
        # The greedy exact regions (EXACT + 1 <= 65) and least-used's
        # L_pad + 1, start 0 only.
        L_pad = shapes.node_pad(live)
        for W in (min(L_pad, 32) + 1, min(L_pad, 64) + 1, L_pad + 1):
            for batch in (1, 16, 64):
                self._check(pb_frontier.plan(batch, W, *self.H100), batch, W, self.H100[1])

    def test_widths_switch_variant_at_the_register_limit(self):
        top = 32 * max(pb_frontier.REG_CHUNKS)
        assert pb_frontier.plan(8, top, *self.H100).variant == "registers"
        assert pb_frontier.plan(8, top + 1, *self.H100).variant == "shared"
        assert pb_frontier.plan(1, 33, *self.H100).chunk == 2
        assert pb_frontier.plan(1, 65, *self.H100).chunk == 3
        assert pb_frontier.plan(1, 1097, *self.H100).chunk == 36
        assert pb_frontier.plan(1, 17, *self.H100).stage_k == 17
        assert pb_frontier.plan(1, 301, *self.H100).stage_k == 301
        assert pb_frontier.plan(1, 1096, *self.H100).stage_k == 907   # 232,448 // 256
        assert pb_frontier.plan(512, 1097, *self.H100).stage_k == 227

    def test_rows_spread_before_they_pack(self):
        # One wave for the batch (512 rows), the committed stream (8) and
        # the save (960 and 120 rows).
        for n_rows, rpb in [(512, 4), (8, 1), (960, 4), (120, 1), (133, 2)]:
            pl = pb_frontier.plan(n_rows, 1097, *self.H100)
            assert pl.rows_per_block == rpb
            assert pl.blocks <= 2 * self.H100[0]

    def test_opt_in_limit_raises_with_the_width(self):
        widest = self.H100[1] // 16
        assert widest >= shapes.node_pad(10_000) + 1
        pl = pb_frontier.plan(8, widest, *self.H100)
        assert pl.variant == "shared" and pl.rows_per_block == 1
        with pytest.raises(ValueError, match=f"width {widest + 1} "):
            pb_frontier.plan(1, widest + 1, *self.H100)

    def test_rejects_bad_plan_arguments(self):
        with pytest.raises(ValueError):
            pb_frontier.plan(0, 17, *self.H100)
        with pytest.raises(ValueError):
            pb_frontier.plan(4, 0, *self.H100)


class TestBatchPrAvailExact:
    """Held within 1e-15 absolute: the DP steps are the same separately
    rounded ops; only the final (parity + 1)-term sum is reduced in
    torch's order rather than XLA's."""

    TOL = 1e-15

    @pytest.mark.parametrize("parity", [0, 1, 2, 5, 40])
    @pytest.mark.parametrize("n", [1, 6, 33])
    def test_equals_jax(self, parity, n):
        rng = np.random.default_rng(parity * 100 + n)
        pm = rng.uniform(0.0, 0.3, size=(7, n))
        pm[0] = 0.0            # a never-failing (padding) row
        got = trel.batch_pr_avail_exact(pm, parity, device="cpu").numpy()
        with jax.enable_x64(True):
            want = np.asarray(jrel.batch_pr_avail_exact(pm, parity))
        np.testing.assert_allclose(got, want, rtol=0.0, atol=self.TOL)
        assert got[0] == 1.0

    def test_tensor_input_runs_on_its_device(self):
        pm = torch.full((2, 3), 0.1, dtype=F64)
        out = trel.batch_pr_avail_exact(pm, 1)
        assert out.device == pm.device and out.dtype == F64
        for row in out.tolist():
            assert row == pytest.approx(jrel.pr_avail([0.1] * 3, 1), abs=self.TOL)
