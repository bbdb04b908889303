"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.

1. **Build** both CUDA kernels (``nvcc`` for ``sm_90a``, one process per
   source, started together) and print the card's name and power limit.
2. **Kernels against their plain versions** on the card.
   ``rs_bitmatmul``: byte-equal over a grid of unaligned widths and (K, R)
   up to 16.  ``pb_frontier``: int64-equal over L in {2, 3, 17, 64, 65,
   rung(1025), node_pad(10 000)}, S in {1, 8, L-1} and targets {0.5, 0.99,
   0.999, 0.9999999} plus one set exactly to a CDF value the plain
   version computes; equal also to the port's numpy
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
4. **Decisions at scale**: the 10,000-node heterogeneous cluster and the
   1-400 MB item generator of the repo's scale lane, seeds 0 and 1.  For
   ``drex_sc``, ``drex_lb`` and ``greedy_least_used`` with the device path
   forced, ``place_batch`` of 64 items on the card must equal
   ``place_scalar`` item by item on the same snapshot; then, on seed 0, a
   committed ``PlacementEngine.place_many`` under the reference's dispatch
   rule must equal the port's CPU oracle path.  ``greedy_min_storage`` is held the
   same way on a 1,000-node cluster from the same generator.  The CPU
   oracles run in worker processes while the card works.
5. **The main path at real size**: the 24 bf16 parameter leaves of
   RWKV6-1.6B (3.20 GB, filled from ``--seed`` on the card) are saved
   through D-Rex SC on the ``most_used`` node set with the default
   checkpoint policy, D-Rex SC scoring the save's groups on the card; the
   72 groups' (K, P, nodes) must equal the CPU oracle's on the same group
   sizes; the node holding row 0 of the first group fails; the state is
   restored and checked bit-exact; ``repair`` runs and the state is
   restored and checked again.  Every launch count is set to 0 just
   before and read just after.
6. **Timing** of each kernel and its plain version, with CUDA events, at
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
]

#: the card every phase runs on (a CPU rehearsal of phases 3-4 at a tiny
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


def phase_frontier_grid(seed: int) -> int:
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
    return n_cases


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


# -- 4. decisions at scale ----------------------------------------------------


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


def oracle_job(kind: str, name: str, n_nodes: int, seed: int, lo: int, hi: int):
    """CPU oracle decisions in a worker process: ``scalar`` runs
    ``place_scalar`` on items ``lo..hi`` of one snapshot (the running
    smallest-size anchor of items ``0..lo`` observed first); ``committed``
    runs a committed ``place_many`` of the first ``hi`` items through the
    numpy oracle."""
    from repro_torch.core import BatchContext, PlacementEngine, create_scheduler

    cluster = scale_cluster(n_nodes, seed)
    items = scale_items(hi, seed + 1)
    sched = create_scheduler(name, device="cpu")
    sched.use_kernel = False
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
            oracle = create_scheduler(name, device="cpu")
            oracle.use_kernel = False
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


# -- 5. the main path ---------------------------------------------------------


def phase_main(seed: int) -> dict:
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.core import ClusterView, DataItem, PlacementEngine, create_scheduler, shapes
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
    oracle = create_scheduler("drex_sc", device="cpu")
    oracle.use_kernel = False
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


# -- 6. timing ----------------------------------------------------------------


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
        jobs = start_oracles(pool)
        timed("kernel_grid", phase_kernel_grid, args.seed)
        timed("frontier_grid", phase_frontier_grid, args.seed)
        timed("small_checkpoint", phase_small_checkpoint, args.seed)
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
        for k, v in scale.items()}}))
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
