"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.

1. **Build** both CUDA kernels (``nvcc`` for ``sm_90a``, one process per
   source, started together) and print the card's name and power limit.
2. **Kernels against their plain versions** on the card.
   ``rs_bitmatmul``: byte-equal over a grid of unaligned widths and (K, R)
   up to 16.  ``pb_frontier``: int64-equal over L in {2, 3, 17, 64, 65,
   rung(1025), node_pad(10 000)}, S in {1, 8, L-1} (cuts below) and
   targets {0.5, 0.99, 0.999, 0.9999999} plus one set exactly to a CDF
   value the plain version computes; equal also to the port's numpy
   ``ParityFrontier.upto_many`` (cuts below).  Then at realistic parities
   (~70): the scale lane's fail probabilities (the freest sc_cap(1024) =
   1096 nodes of the 10,000-node cluster, 365 days), B = 4, S in {1, 8},
   W in {L + 1, 65, 33}, targets 0.99, 0.999 and an ulp-tight one (the
   plain version's running sum at j = mp of the last step that reaches
   0.999) with its two ``nextafter`` neighbours; at W = L + 1 also with
   launches that force the register variant's rarer block paths (row
   replays, lane-order scans), and on rows whose parities pass 127 (the
   full-width rerun).  Every variant of the kernel's launch plan runs and
   is named.
3. **Small checkpoint, every scheduler**: for each of the nine scheduler
   names a small state saved on the card must give the same fabric bytes
   as the port's CPU path, and a restore after a data-row loss must be
   bit-exact.
4. **The simulator at cluster scale** (``[sim]``): ``Simulator(nodes,
   "drex_sc", cfg)`` at its default device over the scale lane's 10,000
   nodes and 256 MEVA items, seeds 0 and 1, through a weighted-random and
   a named failure, a 157-node rack kill, a join and a heal, with 1 MB/s
   repair lanes; every ``SimResult`` field, every stored placement and
   the ``repair_log`` digest must equal the numpy oracle's run.  Then
   Fig. 12's 10-node D-Rex SC run, equal to the CPU's.
5. **The placement service** (``[serve]``): ``PlacementFrontier`` over an
   engine built by name at its default device — serve_load's 100-node
   lane (600 MEVA items at 60, 250 and 1,500 items/s and a churn run, the
   four adaptive schedulers) and D-Rex SC on the 10,000-node cluster
   (256 items at 250 items/s, with and without churn); placements
   digest, reject, repair and loss counts equal to the numpy oracle's,
   and at reject-free rates the placements of a per-item ``place`` loop
   on the card.  No window may return with card work still queued.
   The oracles of phases 4-6 run in worker processes while the card
   works.  Then ``pb_frontier`` is held against its plain version at
   every shape the [sim] and [serve] runs launched it with (the shape
   census, reset before each run), and every launch-plan variant they
   took must have been checked.
6. **Decisions at scale**: the 10,000-node heterogeneous cluster and the
   1-400 MB item generator of the repo's scale lane, seeds 0 and 1.  For
   ``drex_sc``, ``drex_lb`` and ``greedy_least_used`` with the device path
   forced, ``place_batch`` of 64 items on the card must equal
   ``place_scalar`` item by item on the same snapshot; then, on seed 0, a
   committed ``PlacementEngine.place_many`` under the reference's dispatch
   rule must equal the port's CPU oracle path.  ``greedy_min_storage`` is held the
   same way on a 1,000-node cluster from the same generator.  The CPU
   oracles run in worker processes while the card works.
7. **The main path at real size**: the 24 bf16 parameter leaves of
   RWKV6-1.6B (3.20 GB, filled from ``--seed`` on the card) are saved
   through D-Rex SC on the ``most_used`` node set with the default
   checkpoint policy, D-Rex SC scoring the save's groups on the card; the
   72 groups' (K, P, nodes) must equal the CPU oracle's on the same group
   sizes; the node holding row 0 of the first group fails; the state is
   restored and checked bit-exact; ``repair`` runs and the state is
   restored and checked again.  Every launch count is set to 0 just
   before and read just after.
8. **Timing** of each kernel and its plain version, with CUDA events, at
   the shapes the main path launched (and, for ``pb_frontier``, at the
   decisions-at-scale shape, the committed stream's shape and a wide row
   on the shared-memory variant), with the variant and ns per DP step.

Every phase raises on failure.  The last line is the device record; the
line before it lists the kernels.  Without a CUDA device the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import multiprocessing
import pathlib
import re
import resource
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate, int8 tensor-core peak and FP64 vector
#: peak (NVIDIA data sheet, dense), the rates the bounds are taken against.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP64_OPS_PER_S = 34e12

#: RWKV6-1.6B parameter leaves in the JAX package's layout
#: (``repro.models.model.init_params(get_config("rwkv6_1_6b"))`` under
#: ``jax.eval_shape``), all bf16: 1,599,719,424 params, 3.20 GB.
RWKV6_1_6B = [
    ("embed", (65536, 2048)),
    ("final_norm", (2048,)),
    ("layers.cmix.mu_k", (24, 2048)),
    ("layers.cmix.mu_r", (24, 2048)),
    ("layers.cmix.wk", (24, 2048, 7168)),
    ("layers.cmix.wr", (24, 2048, 2048)),
    ("layers.cmix.wv", (24, 7168, 2048)),
    ("layers.norm1", (24, 2048)),
    ("layers.norm2", (24, 2048)),
    ("layers.tmix.bonus_u", (24, 32, 64)),
    ("layers.tmix.decay_bias", (24, 2048)),
    ("layers.tmix.ln_scale", (24, 2048)),
    ("layers.tmix.maa", (24, 5, 2048)),
    ("layers.tmix.td_w1", (24, 2048, 64)),
    ("layers.tmix.td_w2", (24, 64, 2048)),
    ("layers.tmix.tm_w1", (24, 2048, 160)),
    ("layers.tmix.tm_w2", (24, 5, 32, 2048)),
    ("layers.tmix.wg", (24, 2048, 2048)),
    ("layers.tmix.wk", (24, 2048, 2048)),
    ("layers.tmix.wo", (24, 2048, 2048)),
    ("layers.tmix.wr", (24, 2048, 2048)),
    ("layers.tmix.wv", (24, 2048, 2048)),
    ("layers.tmix.x_maa", (24, 2048)),
    ("lm_head", (2048, 65536)),
]
#: what the run leaves out, for its time limit.
CUTS = [
    "optimizer moments (AdamW m, v) left out of the checkpoint: parameters only",
    "greedy_min_storage held on 1,000 nodes with 16 items (its scalar oracle "
    "takes ~0.4 s per item there and grows with the node count squared)",
    "drex_lb's committed place_many holds 24 items, not 256 (its CPU oracle "
    "builds an (L-2) x L penalty matrix per decision: ~1-2 s at 10,000 nodes)",
    "pb_frontier grid: S = L-1 at L = node_pad(10 000) left out (a 4 GB plain "
    "DP); upto_many compared at S <= 8 for L >= rung(1025) and at S = 1 on two "
    "rows for L = node_pad(10 000)",
    "pb_frontier's wide timing row (all 10,000 nodes, shared-memory variant) "
    "uses 7-day fail probabilities (parities ~15, not ~540 at 365 days): the "
    "plain version it is timed against runs one torch op per CDF term",
    "sim_at_scale stores 256 items of the MEVA trace, not its 4,157 (the numpy "
    "oracle it is held against takes ~0.16-0.2 s an item at 10,000 nodes)",
    "serve_at_scale serves 256 MEVA items, not serve_load's 600, for the same "
    "oracle's sake",
]

#: the card every phase runs on (a CPU rehearsal of phases 3-6 at a tiny
#: size sets this to "cpu"; the script itself always runs on "cuda").
DEV = "cuda"
SCALE_NODES = 10_000
SCALE_BATCH = 64
SCALE_COMMITTED = {"drex_sc": 256, "drex_lb": 24, "greedy_least_used": 256}
MS_NODES, MS_ITEMS = 1_000, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(r: int, k: int, b: int) -> tuple[float, str]:
    """Least time for one rs_bitmatmul launch: each input byte read once
    and each output byte written once over HBM, or the mod-2 product's
    2*8R*8K*B operations at the int8 tensor-core peak, whichever is
    larger."""
    t_bytes = ((k + r) * b + 64 * r * k) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * (8 * r) * (8 * k) * b / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def frontier_bound_ms(mp: np.ndarray, S: int, L_live: int, W: int) -> tuple[float, str]:
    """Least time for one pb_frontier launch on these inputs: probs,
    targets and out moved once over HBM, or the f64 operations this data
    needs at the FP64 vector peak — per row (b, s) and step i in
    [s, L_live): 3 per updated DP entry (min(i-s+1, W-1) + 1 of them),
    one for 1 - p, and one add per CDF term the scan reads (found + 1, or
    every admissible term when none reaches the target)."""
    B, _, L = mp.shape
    live = min(L, L_live)
    s = np.arange(S)[:, None]
    i = np.arange(L)[None, :]
    active = (i >= s) & (i < live)
    n_len = i - s + 1
    upd = np.minimum(n_len, W - 1) + 1
    scan = np.where(mp >= 0, mp + 1, np.minimum(n_len - 1, W - 1) + 1)
    ops = float(B * ((3 * upd + 1) * active).sum() + (scan * active[None]).sum())
    t_ops = ops / FP64_OPS_PER_S * 1e3
    t_bytes = 8 * (B * L + B + B * S * L) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- 1. build ------------------------------------------------------------------


def _kernel_name(mangled: str) -> str:
    """``pb_frontier_regs<36>`` from an Itanium-mangled kernel name: the
    first length-prefixed identifier outside the anonymous namespace, and
    its integer template argument."""
    pos = 0
    while True:
        m = re.compile(r"(\d+)").search(mangled, pos)
        if not m:
            return mangled
        n, start = int(m.group(1)), m.end()
        ident = mangled[start:start + n]
        if n >= 3 and len(ident) == n and re.fullmatch(r"[A-Za-z_]\w*", ident) \
                and not ident.startswith("_GLOBAL"):
            targ = re.match(r"ILi(\d+)E", mangled[start + n:])
            return f"{ident}<{targ.group(1)}>" if targ else ident
        pos = start + n if len(ident) == n else m.end()


def ptxas_summary(report: str) -> list[tuple]:
    """(kernel, registers, spill store bytes, spill load bytes, static
    shared bytes) per entry function of an ``-Xptxas -v`` report."""
    rows, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), *spills, int(smem.group(1)) if smem else 0))
            name, spills = None, (0, 0)
    return rows


def phase_build() -> str:
    from repro_torch.kernels import nvcc, pb_frontier, rs_bitmatmul

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as pool:
        libs = list(pool.map(lambda b: b(verbose=True),
                             (rs_bitmatmul.build, pb_frontier.build)))
    log(f"[build] {', '.join(p.name for p in libs)} in {time.perf_counter() - t0:.2f} s")
    for stem, report in nvcc.REPORTS.items():
        for name, regs, spill_st, spill_ld, smem in ptxas_summary(report):
            log(f"[build] ptxas {stem}: {name}: {regs} registers, spill stores "
                f"{spill_st} B, spill loads {spill_ld} B, static shared {smem} B")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    return smi


# -- 2. kernels against their plain versions -----------------------------------


def phase_kernel_grid(seed: int) -> None:
    from repro_torch.ec import gf256
    from repro_torch.kernels import ref, rs_bitmatmul

    rng = np.random.default_rng(seed)
    cases = [(r, k, b) for r in (1, 2, 3, 5, 8, 16) for k in (1, 3, 7, 16)
             for b in (1, 15, 2048, 2049, 65_537)]
    cases += [(1, 3, 22_369_622 * 2), (3, 3, 22_369_622)]
    for r, k, b in cases:
        m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        bm = torch.from_numpy(gf256.gf_to_bitmatrix(m)).cuda()
        d = torch.randint(0, 256, (k, b), dtype=torch.uint8, device="cuda")
        got = rs_bitmatmul.gf_bitmatmul(bm, d)
        want = ref.bitmatmul_ref(bm, d)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version at R={r} K={k} B={b}")
    # an unaligned row start takes the byte-wise path
    d = torch.randint(0, 256, (3 * 4096 + 1,), dtype=torch.uint8, device="cuda")[1:]
    d = d.view(3, 4096)
    bm = torch.from_numpy(gf256.gf_to_bitmatrix(gf256.cauchy_matrix(2, 3))).cuda()
    if not torch.equal(rs_bitmatmul.gf_bitmatmul(bm, d), ref.bitmatmul_ref(bm, d)):
        raise AssertionError("kernel != plain version on an unaligned row start")
    log(f"[kernel] rs_bitmatmul byte-equal to the plain version on {len(cases) + 1} shapes")


def _cdf_value(probs: torch.Tensor, n: int, j: int) -> float:
    """The running-sum CDF at parity ``j`` after ``n`` DP steps from start
    0, in the plain version's arithmetic (an ulp-tight target)."""
    dp = torch.zeros(n + 1, dtype=torch.float64, device=probs.device)
    dp[0] = 1.0
    for i in range(n):
        p = probs[i]
        nd = dp * (1.0 - p)
        nd[1:] = nd[1:] + dp[:-1] * p
        dp = nd
    run = dp[0]
    for jj in range(1, j + 1):
        run = run + dp[jj]
    return float(run)


def frontier_variant(n_rows: int, width: int) -> str:
    """The launch-plan variant ``frontier`` takes on this card, e.g.
    ``registers<36>`` or ``shared``."""
    from repro_torch.kernels import pb_frontier

    pl = pb_frontier.plan(n_rows, width, *pb_frontier.device_limits(torch.device("cuda", 0)))
    return f"registers<{pl.chunk}>" if pl.variant == "registers" else pl.variant


def scale_fail_probs(delta_t_days: float = 365.0, n: int | None = None) -> np.ndarray:
    """Fail probabilities of the scale lane's cluster (seed 0) in D-Rex SC's
    free-descending order: the first ``n`` nodes (default the pre-filter's
    ``sc_cap(1024)`` = 1096)."""
    from repro_torch.core import prefilter
    from repro_torch.core.algorithms import Scheduler

    cluster = scale_cluster(SCALE_NODES, 0)
    by_free = Scheduler._live_sorted(cluster, cluster.free_mb)
    n = prefilter.sc_cap(1024) if n is None else n
    return np.array(cluster.fail_probs(delta_t_days)[by_free][:n], dtype=np.float64)


def tight_target(fp: np.ndarray, width: int, target: float) -> tuple[float, int]:
    """An ulp-tight target and its parity: the running-sum CDF at j = mp of
    the last step (start 0, DP ``width`` entries, numpy's arithmetic) whose
    minimum parity for ``target`` exists."""
    dp = np.zeros(width)
    dp[0] = 1.0
    found = (float("nan"), -1)
    for i, p in enumerate(fp):
        nd = dp * (1.0 - p)
        nd[1:] += dp[:-1] * p
        dp = nd
        cs = np.cumsum(dp[: min(i, width - 1) + 1])
        hit = np.flatnonzero(cs >= target)
        if hit.size:
            found = (float(cs[hit[0]]), int(hit[0]))
    return found


def phase_frontier_grid(seed: int) -> set:
    """The kernel against its plain version over the grid; returns the
    launch plans it exercised."""
    from repro_torch.core import shapes
    from repro_torch.core.reliability import ParityFrontier
    from repro_torch.kernels import pb_frontier, ref

    rng = np.random.default_rng(seed + 1)
    n_cases = 0
    per_L = {}
    variants = set()
    for L in (2, 3, 17, 64, 65, shapes.rung(1025), shapes.node_pad(10_000)):
        t0 = time.perf_counter()
        # Fail probabilities small enough that the min parity stays a few
        # units: the plain version's scan costs one step per parity.
        hi = min(0.3, 2.0 / L)
        probs = torch.from_numpy(rng.uniform(0.0, hi, size=(5, L))).cuda()
        targets = [0.5, 0.99, 0.999, 0.9999999,
                   _cdf_value(probs[4], min(L, 5), 1 if L > 1 else 0)]
        t = torch.tensor(targets, dtype=torch.float64, device="cuda")
        big = L >= shapes.node_pad(10_000)
        for S in sorted({1, min(8, L), max(1, L - 1)}):
            if big and S > 8:
                continue
            got = pb_frontier.frontier(probs, t, S, L, L + 1)
            want = ref.pb_frontier_ref(probs, t, S, L, L + 1)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"pb_frontier != plain version at L={L} S={S}")
            variants.add(frontier_variant(5 * S, L + 1))
            n_cases += 1
            if (L >= shapes.rung(1025) and S > 8) or (big and S > 1):
                continue
            g = got.cpu().numpy()
            p_np = probs.cpu().numpy()
            for b in range(2 if big else 5):
                up = ParityFrontier(p_np[b], targets[b]).upto_many(n_starts=S)
                for s in range(S):
                    if not np.array_equal(g[b, s, s:], up[s, : L - s]):
                        raise AssertionError(
                            f"pb_frontier != upto_many at L={L} S={S} row {b} start {s}"
                        )
        per_L[L] = round(time.perf_counter() - t0, 2)
    log(f"[kernel] pb_frontier int64-equal to the plain version on {n_cases} "
        f"(L, S) cases x 5 targets (one ulp-tight), and to upto_many; s per L {per_L}")
    n_cases += frontier_realistic_cases(variants)
    if not {v.split("<")[0] for v in variants} >= {"registers", "shared"}:
        raise AssertionError(f"a launch-plan variant was not exercised: {sorted(variants)}")
    log(f"[kernel] pb_frontier variants exercised: {sorted(variants)}")
    return variants


def frontier_realistic_cases(variants: set) -> int:
    """The kernel at realistic parities, truncated and not: the scale
    lane's fail probabilities, B = 4, S in {1, 8}, W in {L + 1, 65, 33},
    targets 0.99, 0.999, an ulp-tight one and its two neighbours; each
    call int64-equal to the plain version, and S = 1 at W = L + 1 equal
    to ``upto_many``."""
    from repro_torch.core.reliability import ParityFrontier
    from repro_torch.kernels import pb_frontier, ref

    t0 = time.perf_counter()
    fp = scale_fail_probs()
    L = fp.shape[0]
    probs = torch.from_numpy(np.tile(fp, (5, 1))).cuda()
    n_cases, report = 0, {}
    for W in (L + 1, 65, 33):
        tight, mp = tight_target(fp, W, 0.999)
        tg = [0.99, 0.999, tight, float(np.nextafter(tight, -np.inf)),
              float(np.nextafter(tight, np.inf))]
        t = torch.tensor(tg, dtype=torch.float64, device="cuda")
        want = ref.pb_frontier_ref(probs, t, 8, L, W)  # row s = 0 is the S = 1 call
        for S in (1, 8):
            for rows in ([0, 1, 2, 3], [4, 0, 1, 2]):
                got = pb_frontier.frontier(probs[rows], t[rows], S, L, W)
                torch.cuda.synchronize()
                if not torch.equal(got, want[rows, :S]):
                    raise AssertionError(
                        f"pb_frontier != plain version at scale-lane parities, "
                        f"W={W} S={S} targets {[tg[r] for r in rows]}")
                n_cases += 1
            variants.add(frontier_variant(4 * S, W))
        if W == L + 1:
            n_cases += frontier_forced_paths(probs[:4], t[:4], want[:4], L, W)
            w0 = want[:, 0].cpu().numpy()
            for b, target in enumerate(tg):
                up = ParityFrontier(fp, target).upto_many(n_starts=1)[0, :L]
                if not np.array_equal(w0[b], up):
                    raise AssertionError(f"plain version != upto_many at target {target!r}")
        report[W] = {"tight_parity": mp, "max_parity": int(want.max()),
                     "variant": frontier_variant(4, W)}
    n_cases += frontier_full_width_rows(variants)
    log(f"[kernel] pb_frontier int64-equal to the plain version at scale-lane parities "
        f"on {n_cases} (W, S, targets) calls (B=4, L={L}; 0.99, 0.999, an ulp-tight "
        f"target and its nextafter neighbours; at W=L+1 also staged K of 9, 41 and 1 "
        f"forcing replays and lane-order blocks) and on rows with parities past 127 "
        f"(full-width rerun), upto_many equal at W=L+1: {report}; "
        f"{time.perf_counter() - t0:.2f} s")
    return n_cases


# -- 3. small checkpoint, every scheduler -------------------------------------


def frontier_forced_paths(probs, t, want, L: int, W: int) -> int:
    """The register variant's rarer block paths, forced through a launch
    with a small staged K: guard 0 lets blocks stage past their parities
    (lanes replay the row), a K of 41 with the default guard sends later
    blocks to the step-by-step lane-order scan, and K = 1 does both."""
    from repro_torch.kernels import pb_frontier

    base = pb_frontier.plan(4 * 8, W, *pb_frontier.device_limits(torch.device("cuda", 0)))
    for stage_k, guard in ((9, 0), (41, pb_frontier.STAGE_GUARD), (1, 0)):
        forced = dataclasses.replace(base, stage_k=stage_k, guard=guard,
                                     shared_bytes=base.rows_per_block * 256 * stage_k)
        got = pb_frontier.frontier(probs, t, 8, L, W, launch=forced)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"pb_frontier != plain version with {forced}")
    return 3


def frontier_full_width_rows(variants: set) -> int:
    """Rows whose parities pass 127 (fail probabilities 0.3-0.6 over 300
    nodes): the register variant's 128-entry first pass cannot settle them
    and the row runs again at full width."""
    from repro_torch.kernels import pb_frontier, ref

    rng = np.random.default_rng(7)
    probs = torch.from_numpy(rng.uniform(0.3, 0.6, size=(2, 300))).cuda()
    t = torch.tensor([0.99, 0.999], dtype=torch.float64, device="cuda")
    got = pb_frontier.frontier(probs, t, 4, 300, 301)
    want = ref.pb_frontier_ref(probs, t, 4, 300, 301)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or int(want.max()) < 128:
        raise AssertionError(f"pb_frontier full-width rows: equal {torch.equal(got, want)}, "
                             f"max parity {int(want.max())}")
    variants.add(frontier_variant(8, 301))
    return 1


def phase_small_checkpoint(seed: int) -> None:
    """A small state through the checkpointer on the card and on the CPU,
    for every scheduler: the fabric bytes must be identical, and a
    restore after a data-row loss bit-exact."""
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.core import SCHEDULER_NAMES
    from repro_torch.storage import make_node_set

    gen = torch.Generator(device=DEV).manual_seed(seed)
    state = {
        "w": torch.randn((512, 700), generator=gen, device=DEV).to(torch.bfloat16),
        "b": torch.randn((3001,), generator=gen, device=DEV),
        "n": torch.arange(12345, dtype=torch.int32, device=DEV),
    }
    for name in SCHEDULER_NAMES:
        cks = {}
        for dev in (DEV, "cpu"):
            fabric = StorageFabric(make_node_set("most_used", capacity_scale=1e-5))
            ck = DRexCheckpointer(fabric, name, CheckpointPolicy(item_mb=0.25), device=dev)
            ck.save(state, 1)
            cks[dev] = ck
        if cks[DEV].fabric._blobs != cks["cpu"].fabric._blobs:
            raise AssertionError(f"{name}: card and CPU paths stored different chunk bytes")
        ck = cks[DEV]
        ck.fabric.fail_node(ck._manifests[1]["leaves"][0]["groups"][0]["node_ids"][0])
        got = ck.restore(1, state)
        for key, t in state.items():
            if not torch.equal(got[key], t):
                raise AssertionError(f"{name}: small restore differs at {key}")
        for c in cks.values():
            c.close()
    log(f"[small] {len(SCHEDULER_NAMES)} schedulers: card == CPU chunk bytes; "
        "restore after a data-row loss bit-exact")


# -- 6. decisions at scale ----------------------------------------------------


def scale_cluster(n_nodes: int, seed: int):
    """The scale lane's heterogeneous cluster (benchmarks/scale_cluster.py,
    ``synthetic_cluster``): straight from arrays, racks/zones round-robin."""
    from repro_torch.core import ClusterView

    rng = np.random.default_rng(seed)
    return ClusterView(
        capacity_mb=rng.uniform(2e3, 1e5, n_nodes),
        used_mb=rng.uniform(0.0, 1e3, n_nodes),
        write_bw=rng.uniform(50.0, 400.0, n_nodes),
        read_bw=rng.uniform(50.0, 450.0, n_nodes),
        afr=rng.uniform(0.001, 0.1, n_nodes),
        alive=np.ones(n_nodes, dtype=bool),
        rack=np.arange(n_nodes, dtype=np.int64) % 64,
        zone=np.arange(n_nodes, dtype=np.int64) % 8,
    )


def scale_items(batch: int, seed: int):
    """The scale lane's items (``_items``): 1-400 MB, 365 days, RT 0.99."""
    from repro_torch.core import DataItem

    rng = np.random.default_rng(seed)
    return [
        DataItem(i, float(rng.uniform(1.0, 400.0)), float(i), 365.0, 0.99)
        for i in range(batch)
    ]


def _dkey(d) -> tuple:
    pl = d.placement
    nodes = None if pl is None else (pl.k, pl.p, tuple(int(x) for x in pl.node_ids))
    return nodes, d.candidates_considered, d.reason


def _rkey(r) -> tuple:
    pl = r.placement
    nodes = None if pl is None else (pl.k, pl.p, tuple(int(x) for x in pl.node_ids))
    return r.item_id, nodes, r.reason, r.committed


def oracle_scheduler(name: str):
    """``name`` on the CPU, deciding through its numpy oracle only."""
    from repro_torch.core import create_scheduler

    sched = create_scheduler(name, device="cpu")
    sched.use_kernel = False
    return sched


def oracle_job(kind: str, name: str, n_nodes: int, seed: int, lo: int, hi: int):
    """CPU oracle decisions in a worker process: ``scalar`` runs
    ``place_scalar`` on items ``lo..hi`` of one snapshot (the running
    smallest-size anchor of items ``0..lo`` observed first); ``committed``
    runs a committed ``place_many`` of the first ``hi`` items through the
    numpy oracle."""
    from repro_torch.core import BatchContext, PlacementEngine

    cluster = scale_cluster(n_nodes, seed)
    items = scale_items(hi, seed + 1)
    sched = oracle_scheduler(name)
    t0 = time.perf_counter()
    if kind == "scalar":
        for it in items[:lo]:
            sched.observe_item(it)
        ctx = BatchContext()
        out = [_dkey(sched.place_scalar(it, cluster, ctx)) for it in items[lo:hi]]
    else:
        out = [_rkey(r) for r in PlacementEngine(cluster, sched).place_many(items)]
    return out, time.perf_counter() - t0


def start_oracles(pool) -> dict:
    """Submit every CPU oracle job of phase 4 (longest first)."""
    jobs = {("drex_lb", 0, "committed"): [pool.submit(
        oracle_job, "committed", "drex_lb", SCALE_NODES, 0, 0, SCALE_COMMITTED["drex_lb"])]}
    for seed in (0, 1):
        jobs[("drex_lb", seed, "scalar")] = [
            pool.submit(oracle_job, "scalar", "drex_lb", SCALE_NODES, seed, lo, lo + 8)
            for lo in range(0, SCALE_BATCH, 8)
        ]
    for name in ("drex_sc", "greedy_least_used"):
        jobs[(name, 0, "committed")] = [pool.submit(
            oracle_job, "committed", name, SCALE_NODES, 0, 0, SCALE_COMMITTED[name])]
    jobs[("greedy_min_storage", 0, "committed")] = [pool.submit(
        oracle_job, "committed", "greedy_min_storage", MS_NODES, 0, 0, MS_ITEMS)]
    for seed in (0, 1):
        for name in ("drex_sc", "greedy_least_used"):
            jobs[(name, seed, "scalar")] = [pool.submit(
                oracle_job, "scalar", name, SCALE_NODES, seed, 0, SCALE_BATCH)]
        jobs[("greedy_min_storage", seed, "scalar")] = [pool.submit(
            oracle_job, "scalar", "greedy_min_storage", MS_NODES, seed, 0, MS_ITEMS)]
    return jobs


def _collect(futures) -> tuple[list, float]:
    out, cpu_s = [], 0.0
    for f in futures:
        part, s = f.result()
        out.extend(part)
        cpu_s += s
    return out, cpu_s


def phase_scale(jobs: dict) -> dict:
    """Device decisions at scale against the CPU oracles of ``jobs``."""
    from repro_torch.core import PlacementEngine, create_scheduler, prefilter
    from repro_torch.kernels import pb_frontier

    report = {}
    for name in ("drex_sc", "drex_lb", "greedy_least_used", "greedy_min_storage"):
        n_nodes = MS_NODES if name == "greedy_min_storage" else SCALE_NODES
        n_batch = MS_ITEMS if name == "greedy_min_storage" else SCALE_BATCH
        n_commit = MS_ITEMS if name == "greedy_min_storage" else SCALE_COMMITTED[name]
        for seed in (0, 1):
            cluster = scale_cluster(n_nodes, seed)
            items = scale_items(max(n_batch, n_commit), seed + 1)
            forced = create_scheduler(name, device=DEV)
            forced.KERNEL_MIN_NODES = 0
            forced.KERNEL_MIN_NODES_BATCH = 0
            prefilter.reset_stats()
            pb_frontier.reset_launches()
            t0 = time.perf_counter()
            batch = [_dkey(d) for d in forced.place_batch(items[:n_batch], cluster)]
            batch_s = time.perf_counter() - t0
            launches_batch = pb_frontier.launches
            counters_batch = prefilter.stats().get(name, {})

            scalar, scalar_cpu = _collect(jobs[(name, seed, "scalar")])
            bad_batch = sum(a != b for a, b in zip(batch, scalar)) + abs(len(batch) - len(scalar))
            row = {
                "scheduler": name, "seed": seed, "nodes": n_nodes,
                "batch_items": n_batch, "batch_disagree": bad_batch,
                "batch_ms_per_decision_card": batch_s / n_batch * 1e3,
                "scalar_ms_per_decision_oracle": scalar_cpu / n_batch * 1e3,
                "batch_pb_frontier_launches": launches_batch,
                "batch_prefilter": counters_batch,
            }
            if (name, seed, "committed") in jobs:
                # The committed stream under the reference's dispatch rule.
                prefilter.reset_stats()
                pb_frontier.reset_launches()
                engine = PlacementEngine(cluster.copy(), create_scheduler(name, device=DEV))
                t0 = time.perf_counter()
                committed = [_rkey(r) for r in engine.place_many(items[:n_commit])]
                commit_s = time.perf_counter() - t0
                oracle, oracle_cpu = _collect(jobs[(name, seed, "committed")])
                row.update({
                    "committed_items": n_commit,
                    "committed_disagree": sum(a != b for a, b in zip(committed, oracle))
                    + abs(len(committed) - len(oracle)),
                    "committed_ms_per_decision_card": commit_s / n_commit * 1e3,
                    "committed_ms_per_decision_oracle": oracle_cpu / n_commit * 1e3,
                    "committed_pb_frontier_launches": pb_frontier.launches,
                    "committed_prefilter": prefilter.stats().get(name, {}),
                    "placed": sum(k[1] is not None for k in committed),
                })
            log("[scale] " + json.dumps(row))
            if bad_batch or row.get("committed_disagree"):
                raise AssertionError(f"{name} seed {seed}: device decisions differ from "
                                     f"the oracle ({row})")
            report[f"{name}/{seed}"] = row
    return report


def phase_lb_carry() -> dict:
    """D-Rex LB's device grid (its left-to-right carry is a loop over
    nodes) timed at the filtered width ``lb_cap()`` and on the unfiltered
    fallback over all live nodes: 64 items of the 10,000-node cluster,
    host frontier rows as the scheduler builds them."""
    from repro_torch.core import ParityFrontier, lb_kernel, prefilter
    from repro_torch.core.algorithms import Scheduler

    cluster = scale_cluster(SCALE_NODES, 0)
    items = scale_items(SCALE_BATCH, 1)
    by_free = Scheduler._live_sorted(cluster, cluster.free_mb)
    free = cluster.free_mb[by_free]
    f_avg = float(free.mean())
    dev = np.abs(free - f_avg)
    suffix = np.concatenate([np.cumsum(dev[::-1])[::-1], [0.0]])
    frontier = ParityFrontier(cluster.fail_probs(365.0)[by_free], 0.99)
    sizes = np.array([it.size_mb for it in items])
    out = {}
    for label, m in (("filtered", prefilter.lb_cap()), ("unfiltered", SCALE_NODES)):
        rows = np.tile(frontier.upto(m)[:m], (SCALE_BATCH, 1))
        lb_kernel.lb_batch(rows, sizes, free[:m], f_avg, suffix[: m + 1], device=DEV)
        t0 = time.perf_counter()
        lb_kernel.lb_batch(rows, sizes, free[:m], f_avg, suffix[: m + 1], device=DEV)
        out[label] = {"nodes": m, "items": SCALE_BATCH,
                      "ms_per_call": (time.perf_counter() - t0) * 1e3}
    log("[lb_carry] " + json.dumps(out))
    return out


#: cluster sizes at which the dispatch crossovers are measured (the
#: numpy oracles' cost grows fast with size: ladders stop where the
#: card's lead is plain).
CROSSOVER_LADDERS = {
    "drex_sc": (8, 16, 32, 64, 128, 256, 512),
    "drex_lb": (16, 64, 128, 256, 512, 1024),
    "greedy_min_storage": (8, 16, 24, 32, 64, 128, 256),
    "greedy_least_used": (64, 256, 1024, 4096),
}


def phase_crossovers() -> dict:
    """The ``KERNEL_MIN_NODES`` / ``KERNEL_MIN_NODES_BATCH`` crossovers on
    this card: per scheduler and cluster size (the scale lane's
    generator), the wall time of a single-item decision and of an
    8-item ``place_batch`` on the card (forced) and in the numpy oracle.
    Reported, not applied: the schedulers keep the reference's constants."""
    from repro_torch.core import create_scheduler

    out = {}
    for name, ladder in CROSSOVER_LADDERS.items():
        rows = []
        for n in ladder:
            cluster = scale_cluster(n, 0)
            items = scale_items(8, 1)
            card = create_scheduler(name, device=DEV)
            card.KERNEL_MIN_NODES = 0
            card.KERNEL_MIN_NODES_BATCH = 0
            oracle = oracle_scheduler(name)
            card.place(items[0], cluster)  # warm-up
            row = {"nodes": n}
            for label, sched in (("card", card), ("oracle", oracle)):
                t0 = time.perf_counter()
                for it in items[1:4]:
                    sched.place(it, cluster)
                row[f"single_ms_{label}"] = (time.perf_counter() - t0) / 3 * 1e3
                t0 = time.perf_counter()
                sched.place_batch(items, cluster)
                row[f"batch8_ms_{label}"] = (time.perf_counter() - t0) * 1e3
            rows.append(row)
        first = {kind: next((r["nodes"] for r in rows
                             if r[f"{kind}_ms_card"] < r[f"{kind}_ms_oracle"]), None)
                 for kind in ("single", "batch8")}
        out[name] = {"rows": rows, "card_first_faster_at": first}
        log(f"[crossover] {name} " + json.dumps(out[name]))
    return out


# -- 4-5. the simulator and the placement service ------------------------------


#: sim_at_scale: the MEVA items a run stores, the named victim (failed on
#: day 40, healed on day 60) and the rack killed on day 50.
SIM_ITEMS, SIM_VICTIM, SIM_RACK = 256, 4321, 5
#: serve_lane: benchmarks/serve_load.py's configuration.
SERVE_NODES, SERVE_ITEMS, SERVE_RATES, SERVE_SEED = 100, 600, (60.0, 250.0, 1500.0), 11
SERVE_CFG = {"max_batch": 32, "max_wait_s": 0.05, "queue_capacity": 96}
#: serve_at_scale: drex_sc on the 10,000-node cluster.
SERVE_SCALE_ITEMS, SERVE_SCALE_RATE = 256, 250.0
ADAPTIVE = ("greedy_min_storage", "greedy_least_used", "drex_lb", "drex_sc")
#: path -> the (B, S, L, L_live, W, device) pb_frontier shapes its runs
#: issued (the shape census, reset just before each run).
PATH_SHAPES: dict[str, set] = collections.defaultdict(set)


def entry_device():
    """The ``device`` the new phases give the port's entry points: ``None``,
    their default, which is the card (a CPU rehearsal passes ``"cpu"``)."""
    return None if DEV == "cuda" else DEV


def stream_idle() -> bool:
    """True when the card has no queued work (always on a CPU rehearsal)."""
    return DEV != "cuda" or torch.cuda.current_stream().query()


def scale_nodes(n_nodes: int, seed: int) -> list:
    """The scale lane's cluster as ``StorageNode``s: capacity, occupancy,
    bandwidths, AFR, rack ``i % 64`` and zone ``i % 8``."""
    from repro_torch.core import StorageNode

    c = scale_cluster(n_nodes, seed)
    return [
        StorageNode(node_id=i, capacity_mb=float(c.capacity_mb[i]),
                    write_bw=float(c.write_bw[i]), read_bw=float(c.read_bw[i]),
                    annual_failure_rate=float(c.afr[i]), used_mb=float(c.used_mb[i]),
                    rack=int(c.rack[i]), zone=int(c.zone[i]))
        for i in range(n_nodes)
    ]


def joining_node(node_id: int, capacity_mb: float):
    from repro_torch.core import StorageNode

    return StorageNode(node_id=node_id, capacity_mb=capacity_mb, write_bw=200.0,
                       read_bw=300.0, annual_failure_rate=0.01)


def sim_config(seed: int, n_nodes: int):
    """sim_at_scale's churn: a weighted-random failure, a named one, a
    157-node rack kill, a join and a heal, with 1 MB/s repair lanes."""
    from repro_torch.storage import SimConfig

    return SimConfig(
        failure_schedule=((20.0, -1), (40.0, SIM_VICTIM)),
        rack_failure_schedule=((50.0, SIM_RACK),),
        node_join_schedule=((55.0, joining_node(n_nodes, 5e4)),),
        node_heal_schedule=((60.0, SIM_VICTIM),),
        repair_bw_mbps=1.0, measure_overhead=True, seed=seed,
    )


def fig12_setup():
    """Fig. 12's drex_sc run (tests/test_simulator.py ``_fig12_run``) at RT
    0.9 with seven failures and 0.01 MB/s repair lanes."""
    from repro_torch.storage import SimConfig, make_node_set, make_trace

    nodes = make_node_set("most_unreliable", 0.001)
    cap = sum(n.capacity_mb for n in nodes)
    items = make_trace("meva", seed=1, total_mb=cap * 0.15, reliability=0.9)
    schedule = tuple((70.0 * (i + 1) / 8, -1) for i in range(7))
    return nodes, items, SimConfig(failure_schedule=schedule, seed=1, repair_bw_mbps=0.01)


def sim_fingerprint(sim, res) -> dict:
    """Every ``SimResult`` field but the measured wall times, the stored
    items' (k, p, nodes) and the ``repair_log`` digest of
    tests/test_simulator.py."""
    import hashlib

    log_text = repr([(round(d, 9), i, m) for d, i, m in sim.repair_log]).encode()
    return {
        "stored_mb": res.stored_mb, "total_mb": res.total_mb, "n_stored": res.n_stored,
        "n_failed_writes": res.n_failed_writes, "failed_item_ids": res.failed_item_ids,
        "dropped_mb": res.dropped_mb, "throughput_mbps": res.throughput_mbps,
        "time_breakdown": res.time_breakdown,
        "per_node_used_mb": hashlib.sha256(res.per_node_used_mb.tobytes()).hexdigest(),
        "used_mb_at_failure": sorted(res.used_mb_at_failure.items()),
        "n_node_failures": res.n_node_failures,
        "n_repairs_planned": res.n_repairs_planned,
        "n_repairs_completed": res.n_repairs_completed,
        "n_repairs_aborted": res.n_repairs_aborted,
        "repaired_mb": res.repaired_mb, "repair_read_mb": res.repair_read_mb,
        "repair_log": hashlib.sha256(log_text).hexdigest(),
        "placements": [(s.item.item_id, s.placement.k, s.placement.p,
                        tuple(int(n) for n in s.placement.node_ids))
                       for s in res.stored_items],
    }


def sim_disagreements(a: dict, b: dict) -> tuple[int, list]:
    keys = [k for k in a if k != "placements" and a[k] != b[k]]
    pa, pb = a["placements"], b["placements"]
    return len(keys) + sum(x != y for x, y in zip(pa, pb)) + abs(len(pa) - len(pb)), keys


def sim_job(kind: str, seed: int):
    """A simulator run on the port's numpy oracles in a worker: ``scale``
    is sim_at_scale, ``fig12`` the paper's Fig. 12 run."""
    from repro_torch.storage import Simulator, make_trace

    if kind == "scale":
        nodes = scale_nodes(SCALE_NODES, seed)
        items, cfg = make_trace("meva", seed=seed, n_items=SIM_ITEMS), sim_config(seed, SCALE_NODES)
    else:
        nodes, items, cfg = fig12_setup()
    sim = Simulator(nodes, oracle_scheduler("drex_sc"), cfg)
    t0 = time.perf_counter()
    res = sim.run(items)
    return sim_fingerprint(sim, res), time.perf_counter() - t0, res.sched_overhead_s


def serve_cluster(lane: str):
    """serve_lane: benchmarks/table2_overhead.py's 100-node cluster;
    serve_at_scale: the scale lane's cluster, seed 0."""
    from repro_torch.core import ClusterView, StorageNode

    if lane == "scale":
        return scale_cluster(SCALE_NODES, 0)
    rng = np.random.default_rng(SERVE_NODES)
    return ClusterView.from_nodes([
        StorageNode(node_id=i, capacity_mb=float(rng.uniform(5e6, 2e7)),
                    write_bw=float(rng.uniform(100, 250)),
                    read_bw=float(rng.uniform(100, 400)),
                    annual_failure_rate=float(rng.uniform(0.003, 0.05)))
        for i in range(SERVE_NODES)
    ])


def poisson_trace(n_items: int, rate: float, seed: int = SERVE_SEED) -> list:
    """benchmarks/serve_load.py ``_poisson_trace``: the MEVA trace with
    exponential inter-arrivals at ``rate`` items/s."""
    from repro_torch.storage import make_trace

    base = make_trace("meva", seed=seed, n_items=n_items)
    rng = np.random.default_rng((seed, int(rate * 1000)))
    at = np.cumsum(rng.exponential(1.0 / rate, size=n_items))
    return [dataclasses.replace(it, arrival_time=float(at[i])) for i, it in enumerate(base)]


def serve_events(lane: str, rate: float, churn: bool) -> list:
    """Arrivals, plus serve_load's churn shape when asked: fail at 0.30 and
    0.55 of the horizon, a join at 0.70 and a heal of the first victim at
    0.85.  serve_lane fails nodes 3 and 7; serve_at_scale two nodes drawn
    (seed 11) from the 64 freest, where D-Rex SC's windows start."""
    from repro_torch.core.algorithms import Scheduler
    from repro_torch.serve.placement import arrival_events, churn_events

    n_items = SERVE_SCALE_ITEMS if lane == "scale" else SERVE_ITEMS
    events = arrival_events(poisson_trace(n_items, rate))
    if not churn:
        return events
    if lane == "scale":
        c = scale_cluster(SCALE_NODES, 0)
        freest = Scheduler._live_sorted(c, c.free_mb)[:64]
        a, b = (int(x) for x in np.random.default_rng(SERVE_SEED).choice(freest, 2, replace=False))
        joiner = joining_node(SCALE_NODES, 5e4)
    else:
        a, b, joiner = 3, 7, joining_node(SERVE_NODES, 1.2e7)
    horizon = n_items / rate
    return events + churn_events(
        failure_schedule=((0.30 * horizon, a), (0.55 * horizon, b)),
        node_join_schedule=((0.70 * horizon, joiner),),
        node_heal_schedule=((0.85 * horizon, a),),
        unit="seconds",
    )


def serve_fields(report) -> dict:
    s = report.summary
    return {"digest": report.digest(), "reject_count": s["reject_count"],
            "n_rejected_admission": s["n_rejected_admission"],
            "n_repairs": s["n_repairs"], "n_items_lost": s["n_items_lost"],
            "n_placed": s["n_placed"]}


def serve_job(lane: str, name: str, rate: float, churn: bool):
    """One service run on the port's numpy oracles in a worker."""
    from repro_torch.core import PlacementEngine
    from repro_torch.serve.placement import FrontierConfig, PlacementFrontier

    frontier = PlacementFrontier(PlacementEngine(serve_cluster(lane), oracle_scheduler(name)),
                                 FrontierConfig(**SERVE_CFG))
    t0 = time.perf_counter()
    report = frontier.run(serve_events(lane, rate, churn))
    return serve_fields(report), time.perf_counter() - t0


def serve_runs() -> list[tuple]:
    """(lane, scheduler, rate, churn) of every service run."""
    runs = [("scale", "drex_sc", SERVE_SCALE_RATE, churn) for churn in (False, True)]
    for name in ADAPTIVE:
        runs += [("lane", name, rate, False) for rate in SERVE_RATES]
        runs.append(("lane", name, SERVE_RATES[0], True))
    return runs


def start_new_oracles(pool) -> dict:
    """Submit the CPU oracles of the simulator and service phases (before
    phase 4's; the longest first)."""
    jobs = {("sim", seed): pool.submit(sim_job, "scale", seed) for seed in (0, 1)}
    jobs[("sim", "fig12")] = pool.submit(sim_job, "fig12", 0)
    for run in serve_runs():
        jobs[("serve",) + run] = pool.submit(serve_job, *run)
    return jobs


def phase_sim(jobs: dict) -> dict:
    """sim_at_scale: the simulator on the 10,000-node cluster through
    ``Simulator(nodes, "drex_sc", cfg)`` on the card (every decision takes
    the device path), seeds 0 and 1, against the numpy oracle's run; then
    Fig. 12's 10-node run, the scheduler again built at the default
    device (at ten nodes it decides on the host), against the CPU's."""
    from repro_torch.core import shapes
    from repro_torch.kernels import pb_frontier
    from repro_torch.storage import Simulator, make_trace

    report = {}
    for seed in (0, 1):
        nodes = scale_nodes(SCALE_NODES, seed)
        items = make_trace("meva", seed=seed, n_items=SIM_ITEMS)
        sim = Simulator(nodes, "drex_sc", sim_config(seed, SCALE_NODES), device=entry_device())
        shapes.reset()
        pb_frontier.reset_launches()
        t0 = time.perf_counter()
        res = sim.run(items)
        card_s = time.perf_counter() - t0
        launches = pb_frontier.launches
        PATH_SHAPES["sim_at_scale"] |= shapes.issued_shapes("pb_frontier")
        got = sim_fingerprint(sim, res)
        want, oracle_s, oracle_ovh = jobs[("sim", seed)].result()
        bad, keys = sim_disagreements(got, want)
        ovh = np.array(res.sched_overhead_s) * 1e3
        oovh = np.array(oracle_ovh) * 1e3
        row = {
            "run": "sim_at_scale", "seed": seed, "nodes": SCALE_NODES, "items": SIM_ITEMS,
            "disagree": bad, "fields_differing": keys,
            "stored": res.n_stored, "failed_writes": res.n_failed_writes,
            "node_failures": res.n_node_failures, "repairs_planned": res.n_repairs_planned,
            "repairs_completed": res.n_repairs_completed,
            "repairs_aborted": res.n_repairs_aborted, "dropped_mb": res.dropped_mb,
            "ms_per_item_card": card_s / SIM_ITEMS * 1e3,
            "ms_per_item_oracle": oracle_s / SIM_ITEMS * 1e3,
            "decision_ms_card_p50": float(np.percentile(ovh, 50)),
            "decision_ms_card_p99": float(np.percentile(ovh, 99)),
            "decision_ms_oracle_p50": float(np.percentile(oovh, 50)),
            "decision_ms_oracle_p99": float(np.percentile(oovh, 99)),
            "pb_frontier_launches": launches,
        }
        log("[sim] " + json.dumps(row))
        if bad:
            raise AssertionError(f"sim_at_scale seed {seed}: card != oracle ({keys})")
        if launches == 0 and DEV == "cuda":
            raise AssertionError(f"sim_at_scale seed {seed}: no pb_frontier launch")
        report[f"sim_at_scale/{seed}"] = row

    nodes, items, cfg = fig12_setup()
    sim = Simulator(nodes, "drex_sc", cfg, device=entry_device())
    shapes.reset()
    pb_frontier.reset_launches()
    t0 = time.perf_counter()
    res = sim.run(items)
    card_s = time.perf_counter() - t0
    PATH_SHAPES["fig12"] |= shapes.issued_shapes("pb_frontier")
    want, oracle_s, _ = jobs[("sim", "fig12")].result()
    bad, keys = sim_disagreements(sim_fingerprint(sim, res), want)
    row = {"run": "fig12", "scheduler": "drex_sc", "nodes": len(nodes), "items": len(items),
           "disagree": bad, "fields_differing": keys,
           "retained_fraction": res.retained_fraction, "stored_mb": res.stored_mb,
           "repairs_planned": res.n_repairs_planned, "ms_per_item_card": card_s / len(items) * 1e3,
           "ms_per_item_oracle": oracle_s / len(items) * 1e3,
           "pb_frontier_launches": pb_frontier.launches}
    log("[sim] " + json.dumps(row))
    if bad:
        raise AssertionError(f"fig12 run: card != CPU ({keys})")
    report["fig12"] = row
    return report


def phase_serve(jobs: dict) -> dict:
    """serve_lane and serve_at_scale: ``PlacementFrontier`` over an engine
    built by name at its default device, against the numpy oracle's run
    of the same events; at the reject-free rates also against a per-item
    ``engine.place`` loop on the card."""
    from repro_torch.core import PlacementEngine, shapes
    from repro_torch.kernels import pb_frontier
    from repro_torch.serve.placement import FrontierConfig, PlacementFrontier

    report, sequential = {}, {}
    for lane, name, rate, churn in serve_runs():
        engine = PlacementEngine(serve_cluster(lane), name, device=entry_device())
        windows = {"n": 0, "pending": 0}
        place_many = engine.place_many

        def checked_place_many(items, **kw):
            out = place_many(items, **kw)
            windows["n"] += 1
            windows["pending"] += not stream_idle()
            return out

        engine.place_many = checked_place_many
        frontier = PlacementFrontier(engine, FrontierConfig(**SERVE_CFG))
        events = serve_events(lane, rate, churn)
        shapes.reset()
        pb_frontier.reset_launches()
        t0 = time.perf_counter()
        rep = frontier.run(events)
        card_s = time.perf_counter() - t0
        launches = pb_frontier.launches
        path = "serve_lane" if lane == "lane" else "serve_at_scale"
        PATH_SHAPES[path] |= shapes.issued_shapes("pb_frontier")
        got = serve_fields(rep)
        want, oracle_s = jobs[("serve", lane, name, rate, churn)].result()
        s = rep.summary
        row = {"run": path,
               "scheduler": name, "nodes": engine.cluster.n_nodes, "rate": rate,
               "churn": churn, "equal": got == want, "card": got, "oracle": want,
               "decision_ms_p50": s["decision_wall"]["p50_ms"],
               "decision_ms_p99": s["decision_wall"]["p99_ms"],
               "mean_window": s["mean_window"], "windows": s["n_flushes"],
               "windows_with_card_work_pending_on_return": windows["pending"],
               "card_wall_s": card_s, "oracle_wall_s": oracle_s,
               "pb_frontier_launches": launches}
        if not churn and got["reject_count"] == 0:
            key = (lane, name)
            if key not in sequential:
                seq_engine = PlacementEngine(serve_cluster(lane), name, device=entry_device())
                sequential[key] = [seq_engine.place(ev.payload) for ev in events]
            by_id = {o.item_id: o.placement for o in rep.outcomes}
            row["matches_sequential"] = all(by_id.get(r.item_id) == r.placement
                                            for r in sequential[key])
        log("[serve] " + json.dumps(row))
        if not row["equal"] or row.get("matches_sequential") is False:
            raise AssertionError(f"serve {lane} {name} rate {rate} churn {churn}: {row}")
        if windows["pending"] or windows["n"] != s["n_flushes"]:
            raise AssertionError(f"serve {lane} {name}: a window returned before the card "
                                 f"finished ({windows})")
        if name == "drex_sc" and launches == 0 and DEV == "cuda":
            raise AssertionError(f"serve {lane} drex_sc rate {rate}: no pb_frontier launch")
        report[f"{lane}/{name}/{rate:g}{'/churn' if churn else ''}"] = row
    return report


def phase_path_shapes(variants: set) -> dict:
    """pb_frontier against its plain version at every shape the [sim] and
    [serve] paths issued: per (S, L, L_live, W) one plain call on B rows
    of the path's cluster (its fail probabilities at 365 days, the MEVA
    retention, in free-descending order, rolled by the row index; targets
    0.9 to 0.99999 and on row 0 an ulp-tight one), and the kernel at every
    B the paths launched, each int64-equal to those rows.  Every
    launch-plan variant a path took must be one the grid or this check
    exercised."""
    from repro_torch.core.algorithms import Scheduler
    from repro_torch.kernels import pb_frontier, ref

    def variant(n_rows: int, width: int) -> str:
        return frontier_variant(n_rows, width) if DEV == "cuda" else "plain"

    lanes = {"sim_at_scale": "scale", "serve_at_scale": "scale", "serve_lane": "lane"}
    groups = collections.defaultdict(set)
    for path, issued in PATH_SHAPES.items():
        for B, S, L, L_live, W, dev in issued:
            if dev == DEV and path in lanes:
                groups[(lanes[path], S, L, L_live, W)].add(B)
    t0 = time.perf_counter()
    clusters = {lane: serve_cluster(lane) for lane in {g[0] for g in groups}}
    for (lane, S, L, L_live, W), Bs in sorted(groups.items()):
        c = clusters[lane]
        fp = c.fail_probs(365.0)[Scheduler._live_sorted(c, c.free_mb)]
        row = np.resize(fp, L_live)
        n = max(Bs)
        probs = np.zeros((n, L), dtype=np.float64)
        for b in range(n):
            probs[b, :L_live] = np.roll(row, b)
        tg = [(0.9, 0.99, 0.999, 0.9999, 0.99999)[b % 5] for b in range(n)]
        tight, _ = tight_target(row, W, 0.999)
        if tight == tight:
            tg[0] = tight
        probs_t = torch.from_numpy(probs).to(DEV)
        t = torch.tensor(tg, dtype=torch.float64, device=DEV)
        want = ref.pb_frontier_ref(probs_t, t, S, L_live, W)
        for B in sorted(Bs):
            got = pb_frontier.frontier(probs_t[:B], t[:B], S, L_live, W)
            if not torch.equal(got, want[:B]):
                raise AssertionError(f"pb_frontier != plain version at the {lane} path's "
                                     f"shape B={B} S={S} L={L} L_live={L_live} W={W}")
            variants.add(variant(B * S, W))
    taken = {path: sorted({variant(B * S, W) for B, S, _, _, W, dev in issued if dev == DEV})
             for path, issued in PATH_SHAPES.items()}
    missing = {v for vs in taken.values() for v in vs} - variants
    report = {"shapes": sum(len(b) for b in groups.values()), "plain_calls": len(groups),
              "checked": [[*g, sorted(b)] for g, b in sorted(groups.items())],
              "variants_by_path": taken, "s": time.perf_counter() - t0}
    log("[kernel] pb_frontier int64-equal to the plain version at the [sim] and [serve] "
        "paths' shapes: " + json.dumps(report))
    if missing:
        raise AssertionError(f"paths took launch-plan variants never checked: {sorted(missing)}")
    return report


# -- 7. the main path ---------------------------------------------------------


def phase_main(seed: int) -> dict:
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.core import ClusterView, DataItem, PlacementEngine, shapes
    from repro_torch.kernels import ops, pb_frontier, rs_bitmatmul
    from repro_torch.storage import make_node_set

    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = {
        name: torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        for name, shape in RWKV6_1_6B
    }
    n_params = sum(t.numel() for t in state.values())
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    torch.cuda.synchronize()
    fabric = StorageFabric(make_node_set("most_used"))
    ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(), device="cuda")
    placed_items: list = []
    place_many = ck.engine.place_many

    def recording_place_many(items, **kw):
        placed_items.extend(items)
        return place_many(items, **kw)

    ck.engine.place_many = recording_place_many

    # The main path's run: every count set to 0 just before, read after.
    shapes.reset()
    ops.reset_launch_stats()
    rs_bitmatmul.reset_launches()
    pb_frontier.reset_launches()

    t0 = time.perf_counter()
    manifest = ck.save(state, 1)
    save_s = time.perf_counter() - t0
    frontier_launches = pb_frontier.launches
    groups = [g for m in manifest["leaves"] for g in m["groups"]]
    save_shapes = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    frontier_shapes = sorted(shapes.issued_shapes("pb_frontier"))
    hist = collections.Counter(f"({g['k']},{g['p']})" for g in groups)
    nodes = collections.Counter(tuple(g["node_ids"]) for g in groups)
    after_save = ops.launch_stats()
    if frontier_launches == 0:
        raise AssertionError("the save did not score its groups through pb_frontier")

    # The same group sizes through the CPU oracle on a fresh node set.
    oracle = oracle_scheduler("drex_sc")
    want = PlacementEngine(ClusterView.from_nodes(make_node_set("most_used")), oracle,
                           auto_commit=False).place_many([
        DataItem(it.item_id, it.size_mb, it.arrival_time, it.delta_t_days,
                 it.reliability_target) for it in placed_items])
    got = [(g["k"], g["p"], tuple(g["node_ids"])) for g in groups]
    if got != [(r.placement.k, r.placement.p, tuple(r.placement.node_ids)) for r in want]:
        raise AssertionError("the save's placements differ from the CPU oracle's")

    victim = groups[0]["node_ids"][0]
    fabric.fail_node(victim)
    t0 = time.perf_counter()
    restored, step = ck.restore_latest(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for name, t in state.items():
        if not torch.equal(restored[name], t):
            raise AssertionError(f"restore after node {victim} failed differs at {name}")
    del restored
    after_restore = ops.launch_stats()

    t0 = time.perf_counter()
    rebuilt = ck.repair()
    repair_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, _ = ck.restore_latest(state)
    torch.cuda.synchronize()
    restore2_s = time.perf_counter() - t0
    for name, t in state.items():
        if not torch.equal(restored[name], t):
            raise AssertionError(f"restore after repair differs at {name}")
    del restored

    launches = rs_bitmatmul.launches
    per_kind = ops.launch_stats()
    issued = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    frontier_launches = pb_frontier.launches
    ck.close()
    if after_save["encode"] == 0 or after_restore["decode"] == 0:
        raise AssertionError(f"main path skipped the kernel: {after_save}, {after_restore}")
    if launches != per_kind["encode"] + per_kind["decode"] or launches == 0:
        raise AssertionError(f"launch counts disagree: {launches} vs {per_kind}")
    if rebuilt != len(groups):
        raise AssertionError(f"repair rebuilt {rebuilt} chunks for {len(groups)} groups")

    gb = n_bytes / 1e9
    report = {
        "state": {"model": "rwkv6_1_6b", "leaves": len(state), "params": n_params,
                  "bytes": n_bytes, "dtype": "bfloat16"},
        "groups": len(groups),
        "kp_histogram": dict(hist),
        "node_sets_used": {",".join(map(str, k)): v for k, v in nodes.items()},
        "placements_equal_cpu_oracle": True,
        "failed_node": victim,
        "save_s": save_s, "save_GBps": gb / save_s,
        "place_s": ck.stats["place_s"], "encode_s": ck.stats["encode_s"],
        "restore_s": restore_s, "restore_GBps": gb / restore_s,
        "repair_s": repair_s, "repaired_chunks": rebuilt,
        "restore_after_repair_s": restore2_s,
        "bytes_stored": ck.stats["bytes_stored"],
        "launches": {"rs_bitmatmul": launches, "save_encode": after_save["encode"],
                     "restore_decode": after_restore["decode"] - after_save["decode"],
                     "repair": {k: per_kind[k] - after_restore[k] for k in per_kind},
                     "pb_frontier": frontier_launches},
        "pb_frontier_shapes": [list(s) for s in frontier_shapes],
        "host_peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "device_peak_GB": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("[main] " + json.dumps(report))
    return {"report": report, "issued": issued, "save_shapes": save_shapes,
            "launches": launches, "frontier_launches": frontier_launches,
            "frontier_shapes": frontier_shapes}


# -- 8. timing ----------------------------------------------------------------


def phase_timing(issued: list, seed: int) -> list[dict]:
    """rs_bitmatmul against its plain version at every (R, K, B) the main
    path launched: byte-equal, then timed (median of CUDA-event runs)."""
    from repro_torch.ec import gf256
    from repro_torch.kernels import ref, rs_bitmatmul

    rng = np.random.default_rng(seed)
    rows = []
    for r8, k8, blocks, block_bytes, dev in issued:
        if dev != "cuda":
            continue
        r, k, b = r8 // 8, k8 // 8, blocks * block_bytes
        m = rng.integers(0, 256, size=(r, k), dtype=np.uint8)
        bm = torch.from_numpy(gf256.gf_to_bitmatrix(m)).cuda()
        d = torch.randint(0, 256, (k, b), dtype=torch.uint8, device="cuda")
        got = rs_bitmatmul.gf_bitmatmul(bm, d)
        want = ref.bitmatmul_ref(bm, d)
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        if err:
            raise AssertionError(f"kernel != plain version at R={r} K={k} B={b}")
        del got, want
        ms = cuda_time_ms(lambda: rs_bitmatmul.gf_bitmatmul(bm, d), reps=7)
        plain_ms = cuda_time_ms(lambda: ref.bitmatmul_ref(bm, d), reps=3)
        bound, by = bound_ms(r, k, b)
        moved = (k + r) * b
        rows.append({"R": r, "K": k, "B": b, "bytes": moved, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                     "GBps": moved / ms / 1e6, "max_abs_err": err})
        log("[timing] " + json.dumps(rows[-1]))
        del d
        torch.cuda.empty_cache()
    return rows


def _frontier_inputs(cluster, by_free, delta_t_days: float, target: float, B: int, L: int):
    probs = np.zeros((B, L), dtype=np.float64)
    fp = cluster.fail_probs(delta_t_days)[by_free][:L]
    probs[:, : fp.shape[0]] = fp
    return (torch.from_numpy(probs).cuda(),
            torch.full((B,), target, dtype=torch.float64, device="cuda"))


def cuda_time_once(fn) -> tuple:
    """``(fn(), ms)`` of one run on the current stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


#: retention of the wide timing row: a week keeps its parities small (~15
#: over 10,000 nodes), since the plain version it is timed against runs one
#: torch op per CDF term and a host sync per step.
WIDE_DAYS = 7.0


def phase_frontier_timing(main_shapes: list) -> list[dict]:
    """pb_frontier against its plain version at the shapes the main path
    launched (the save's own fail probabilities and target), at the
    decisions-at-scale shape (64 items, the freest rung(1025) nodes of the
    10,000-node cluster), at the committed stream's shape (one item) and on
    a wide row (all 10,000 nodes, the shared-memory variant): equal, then
    timed, with the variant and ns per DP step."""
    from repro_torch.core import ClusterView, prefilter, shapes
    from repro_torch.core.algorithms import Scheduler
    from repro_torch.core.sc_kernel import _shape_plan
    from repro_torch.kernels import pb_frontier, ref
    from repro_torch.storage import make_node_set

    most_used = ClusterView.from_nodes(make_node_set("most_used"))
    big = scale_cluster(SCALE_NODES, 0)
    cases = [("main", most_used, 30.0, 0.999, s) for s in main_shapes]
    M = prefilter.sc_cap(1024)
    S_pad, L_pad = _shape_plan(M, 1024)
    cases.append(("scale", big, 365.0, 0.99, (SCALE_BATCH, S_pad, L_pad, M, L_pad + 1, "cuda")))
    cases.append(("committed", big, 365.0, 0.99, (1, S_pad, L_pad, M, L_pad + 1, "cuda")))
    Lw = shapes.node_pad(SCALE_NODES)
    cases.append(("wide", big, WIDE_DAYS, 0.99, (4, 1, Lw, SCALE_NODES, Lw + 1, "cuda")))
    rows = []
    for label, cluster, days, target, (B, S, L, L_live, W, dev) in cases:
        if dev != "cuda":
            continue
        by_free = Scheduler._live_sorted(cluster, cluster.free_mb)
        probs, t = _frontier_inputs(cluster, by_free, days, target, B, L)
        got = pb_frontier.frontier(probs, t, S, L_live, W)
        want, plain_ms = cuda_time_once(lambda: ref.pb_frontier_ref(probs, t, S, L_live, W))
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"pb_frontier != plain version at {(B, S, L, W)}")
        ms = cuda_time_ms(lambda: pb_frontier.frontier(probs, t, S, L_live, W), reps=7)
        bound, by = frontier_bound_ms(got.cpu().numpy(), S, L_live, W)
        rows.append({"at": label, "B": B, "S": S, "L": L, "L_live": L_live, "W": W,
                     "variant": frontier_variant(B * S, W), "max_parity": int(got.max()),
                     "ms": ms, "ns_per_step": ms * 1e6 / L_live, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "max_abs_err": err})
        log("[timing] pb_frontier " + json.dumps(rows[-1]))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_s = {}

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[label] = time.perf_counter() - t0
        return out

    smi = timed("build", phase_build)
    spawn = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(max_workers=7, mp_context=spawn) as pool:
        new_jobs = start_new_oracles(pool)
        jobs = start_oracles(pool)
        timed("kernel_grid", phase_kernel_grid, args.seed)
        variants = timed("frontier_grid", phase_frontier_grid, args.seed)
        timed("small_checkpoint", phase_small_checkpoint, args.seed)
        # The simulator and the service before phase 6: their oracles were
        # submitted first.  The host-bound phases that hold no oracle (the
        # LB carry, the crossovers, the main path, the timings) run after
        # the workers are gone, so their numbers are taken on an idle host.
        sim = timed("sim", phase_sim, new_jobs)
        serve = timed("serve", phase_serve, new_jobs)
        path_shapes = timed("path_shapes", phase_path_shapes, variants)
        scale = timed("scale", phase_scale, jobs)
    timed("lb_carry", phase_lb_carry)
    timed("crossovers", phase_crossovers)
    main_run = timed("main", phase_main, args.seed)
    rows = timed("timing", phase_timing, main_run["issued"], args.seed)
    frows = timed("frontier_timing", phase_frontier_timing, main_run["frontier_shapes"])
    # The headline shape is the save's widest encode wave.
    save = {(r8 // 8, k8 // 8, n * bb) for r8, k8, n, bb, _ in main_run["save_shapes"]}
    head = max((x for x in rows if (x["R"], x["K"], x["B"]) in save),
               key=lambda x: x["B"])
    fhead = max((x for x in frows if x["at"] == "main"), key=lambda x: x["B"] * x["S"] * x["L"])
    kernels = [
        {
            "name": "rs_bitmatmul",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rs_bitmatmul.cu",
            "replaces": "src/repro/kernels/rs_bitmatmul.py:56",
            "launches": main_run["launches"],
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "matches_plain": True,
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": {"R": head["R"], "K": head["K"], "B": head["B"]},
            "shapes": rows,
        },
        {
            "name": "pb_frontier",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/pb_frontier.cu",
            "replaces": "src/repro/core/sc_kernel.py:133 (in-jit DP of the XLA "
                        "program _score_windows, not Pallas); "
                        "src/repro/core/greedy_kernel.py:125",
            "launches": main_run["frontier_launches"],
            "launches_by_path": {
                "checkpoint_main": main_run["frontier_launches"],
                "sim_at_scale": sum(sim[f"sim_at_scale/{s}"]["pb_frontier_launches"]
                                    for s in (0, 1)),
                "serve_lane": sum(r["pb_frontier_launches"] for r in serve.values()
                                  if r["run"] == "serve_lane"),
                "serve_at_scale": sum(r["pb_frontier_launches"] for r in serve.values()
                                      if r["run"] == "serve_at_scale"),
            },
            "variants_by_path": path_shapes["variants_by_path"],
            "max_abs_err": max(x["max_abs_err"] for x in frows),
            "matches_plain": True,
            "ms": fhead["ms"],
            "plain_ms": fhead["plain_ms"],
            "bound_ms": fhead["bound_ms"],
            "bound_by": fhead["bound_by"],
            "library_ms": None,
            "shape": {k: fhead[k] for k in ("B", "S", "L", "L_live", "W")},
            "shapes": frows,
        },
    ]
    log("[summary] " + json.dumps({"cuts": CUTS, "phase_s": phase_s, "scale": {
        k: {f: v[f] for f in ("batch_disagree", "committed_disagree",
                              "batch_ms_per_decision_card",
                              "scalar_ms_per_decision_oracle") if f in v}
        for k, v in scale.items()}, "sim": {
        k: {f: v[f] for f in ("disagree", "ms_per_item_card", "ms_per_item_oracle")}
        for k, v in sim.items()}, "serve": {
        k: {f: v[f] for f in ("equal", "decision_ms_p50", "decision_ms_p99",
                              "pb_frontier_launches")}
        for k, v in serve.items()}}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
