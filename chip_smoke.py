"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py [--seed N]``.

1. **Build** the three CUDA sources (``nvcc`` for ``sm_90a``, one process
   per source, started together: ``rs_bitmatmul.cu``, ``pb_frontier.cu``,
   ``threefry.cu``) and print the card's name and power limit.
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
7. **The LM serving path** (``[lm]``): RWKV6-1.6B and Qwen3-8B at full
   width, bf16, params from ``init_params`` on the card from ``--seed``
   (RWKV6-1.6B's leaf names and shapes must equal ``RWKV6_1_6B``, the
   JAX package's layout).  ``ServingEngine`` serves 4 prompts of 128
   tokens (numpy, ``--seed``) with 32 greedy new tokens twice: tokens
   and logits bit-equal.  With the params upcast to f32 on the card
   (TF32 off), teacher-forced decode over the served 160 tokens equals
   the full forward, and the f32 params (Qwen3-8B cut to 2 layers) give
   the port's CPU logits (B = 1, 16-token prompt, 8 teacher-forced
   steps), both within the model's f32 rounding band (``LM_BAND``); the
   served bf16 logits lie within ``LM_BAND`` times the bf16 forward's
   own distance of the f32 forward.  Seeded sampling at T = 0.8 twice
   gives the same 8 new tokens.  One ``[lm]`` line per model: prefill
   ms, decode ms per step (p50), tokens/s, a decode step's kernels and
   the card's busy share (``torch.profiler``), every check's error and
   tolerance, device peak, and for RWKV6 the WKV loop's share of a
   prefill.  Qwen3-8B is then freed.
8. **The main path at real size**: the [lm] phase's RWKV6-1.6B params
   (24 bf16 leaves, 3.20 GB, under their JAX tree paths) are saved
   through D-Rex SC on the ``most_used`` node set with the default
   checkpoint policy, D-Rex SC scoring the save's groups on the card; the
   72 groups' (K, P, nodes) must equal the CPU oracle's on the same group
   sizes; the node holding row 0 of the first group fails; the state is
   restored and checked bit-exact, and the restored params serve the
   [lm] prompts again with equal tokens and bit-equal logits; ``repair``
   runs and the state is restored and checked again.  Every launch count
   is set to 0 just before and read just after.
9. **The training path** (``[train]``), under
   ``torch.use_deterministic_algorithms(True)``: RWKV6-1.6B at full width
   (bf16 params, f32 AdamW moments and master copy: a 22.4 GB
   ``TrainState``) from ``init_train_state`` on the card, trained by the
   port's ``Trainer`` for 6 steps at B = 8, T = 128 with the launcher's
   AdamW (lr 3e-3, 5 warmup steps) and data pipeline; at step 4 the whole
   state is saved asynchronously through D-Rex SC on the ``most_used``
   node set (policy defaults): the call returns after the snapshot, and
   step 5 begins while the save encodes on its worker (checked).  Then a
   node holding chunks fails, a second
   ``Trainer`` restores the state (bit-equal, leaf by leaf, to a host copy
   taken at the save) and runs steps 5-6 again: losses and the final
   state bit-equal to the uninterrupted run.  Step ms (those begun with
   the save pending apart), tokens/s, loss and grad norm per step, the
   save's stall and length, save/restore GB/s, device and host peaks, and
   the WKV loop's share of a step.  Then one step's f32 loss and gradients,
   on the card and on the CPU, for RWKV6-1.6B and Qwen3-8B cut to 2
   layers at full width, leaf by leaf within max(floor, ``LM_BAND`` x the
   band the run measures, as ``[lm]`` does).
   Every launch count is set to 0 just before the run and read after the
   resumed steps.
   **The mesh** (``[mesh]``), still deterministic: ``[train]``'s run
   again with ``Trainer(mesh=make_local_mesh(1, 1))`` on a one-rank NCCL
   group, every state leaf a DTensor laid out by
   ``train_state_shardings``; its losses and final state (a digest of
   every leaf's words) equal ``[train]``'s mesh-less run's; the save at
   step 4 gathers each leaf, a node holding chunks fails, the restore is
   bit-equal, ``reshard_state`` lays it onto a freshly built mesh, and
   steps 5-6 are bit-equal to the uninterrupted mesh run.  Then
   Qwen1.5-MoE-A2.7B at full width with DTensor params under
   ``activate_mesh``, so ``moe_dispatch="shard_map"`` runs per shard:
   forward and prefill logits bit-equal to the mesh-less scatter path
   and no routing choice flipped at capacity factor 8, the first MoE
   layer routing alike at the config's 1.25.  Then Qwen3-8B at full
   width with ``attn_impl="blockwise"``: a 4,096-token prefill and 8
   greedy tokens against the dense path (logits within ``MESH_BF16_BAND``
   of their max; tokens equal up to a first flip, where the two chosen
   tokens' dense logits must lie within twice the paths' difference on
   that step's logits; the blockwise path fed the dense tokens gives
   every step's logits within ``MESH_BF16_BAND``; each path's ms and
   device peak), and in f32 at 2 layers the logits and ``loss_fn``'s gradients within
   ``MESH_F32_TOL`` of max.  Every launch count is set to 0 just before
   the training run and read after the resumed steps.
10. **The other model families** (``[families]``): Qwen3-30B-A3B and
   Qwen1.5-MoE-A2.7B (MoE), RecurrentGemma-9B (Griffin) and whisper-tiny
   (encoder-decoder, with (4, 1500, 384) frame embeddings from ``--seed``)
   at full width in bf16, one at a time, params from ``init_params`` on
   the card (leaf names, shapes and dtypes equal to ``FAMILY_LAYOUTS``,
   the JAX package's layout): 4 x 128 prompt tokens, 32 greedy new tokens
   twice, tokens and logits bit-equal; prefill ms, decode ms per step
   (p50), tokens/s, a profiled decode step's kernels and busy share, the
   device peak.  Then the f32 model on the card and on the CPU (the MoE
   configs at 2 layers, RecurrentGemma-9B at 5, whisper-tiny whole, full
   width, B = 2, T = 16): the logits of ``forward``, ``prefill`` and 8
   teacher-forced decode steps, ``loss_fn``'s loss, aux and gradients
   within the CPU tests' tolerances, and no MoE routing choice that
   differs.  Then RecurrentGemma-9B's 20.89 GB params (51 leaves, its
   ``groups.rec`` list among them) and whisper-tiny's are each saved
   through D-Rex SC on the ``most_used`` node set (policy defaults), a
   node holding chunks fails, ``restore_latest`` gives every leaf
   bit-equal, and the restored params serve the same tokens and
   bit-equal logits.  Every launch count is set to 0 just before the
   phase and read just after.
11. **The examples** (``[examples]``): the four programs of
   ``examples_torch/`` on the card through their own entry points, one at
   a time.  ``placement_explorer`` with its defaults: its §5 table and
   batched rows (wall time aside) equal to the same example run with
   ``--device cpu`` (placements too) and to the reference's values
   (``EXPLORER_TABLE``, ``EXPLORER_PLACED``), and its ``pb_frontier``
   launches (none: at its 10 nodes the dispatch rule sends every
   decision to the oracle).  ``serve_batch`` with its defaults, twice:
   the same tokens.  ``quickstart --full`` (124,649,472 params, a 1.75 GB ``TrainState``)
   for its default 200 steps on a one-rank mesh with D-Rex SC checkpoints
   every 50 steps: every logged metric finite, the restore after nodes 0
   and 3 fail bit-exact, every save's (K, P, nodes) equal to the CPU
   oracle's on a copy of the cluster as it stood, and the storage
   overhead equal to what those placements store for the same leaf sizes;
   step ms p50, tokens/s, save and restore GB/s, the device peak.
   ``elastic_failover``: the reference's health and repair numbers
   (``FAILOVER``), the restore at step 30 with the pipeline at batch 0,
   training to step 45.  Every launch count is set to 0 just before the
   phase and read just after; the explorer's CPU run comes after.
12. **jax.random on the card** (``[prng]``, after the crossovers).
   ``threefry_normal`` and ``gumbel_argmax`` against jax 0.9's draws in
   ``tests/data/jax_prng_golden.npz`` (keys, splits and fold_ins equal;
   bits and threefry hashes, the plain version on the card, equal; f32
   normals at 0 ulp; categorical tokens equal) and against their plain
   versions bit for bit (counts 1, 7, 4,099 and 2^20 + 3, one key and a
   36-key stack, f32 and bf16 with and without ``std``, a 2^26-draw
   window of Qwen3-8B's 622 M-draw embed leaf; Gumbel-max at (4, 65,536),
   (4, 151,936) and (64, 151,936) and on the edge cases of
   ``tests/gumbel_cases.py`` (widths about the kernel's vocabulary slice,
   ties, NaNs and ``-inf`` across slices), temperatures 0.7 and 1.0).
   Then the path, launch
   counts set to 0 just before it and read just after: Qwen3-8B and
   RWKV6-1.6B initialised at full width from ``PRNGKey(--seed)`` (init
   ms, launches, the largest leaf), RWKV6-1.6B served at temperature 1.0
   (4 x 128 prompt tokens, 32 new), its tokens equal to the plain
   Gumbel-max on the logits it returned under the engine's key
   schedule, and its decode ms a sampled step.  Kernel, plain and bound ms
   at the window, kernel ms over the whole embed leaf; Gumbel-max's kernel
   ms (20 launches queued, and one at a time), plain and bound ms at the
   three shapes above, beside ``torch.argmax`` of the same logits as a
   yardstick.  Every phase's
   launches of the two kernels (each path's inits and sampling) are
   counted from 0 and held to the plain versions after the phase: the
   last 2^16 draws of every row of each ``threefry_normal`` launch, the
   tokens of each ``gumbel_argmax`` launch (``DrawLaunches``).
13. **Timing** of each kernel and its plain version, with CUDA events, at
   the shapes the main, training, mesh, families and examples paths
   launched (and, for
   ``pb_frontier``, at the decisions-at-scale shape, the committed
   stream's shape and a wide row on the shared-memory variant), with the
   variant and ns per DP step.

Every phase raises on failure.  The last line is the device record; the
line before it lists the kernels.  Without a CUDA device the script
exits non-zero and prints no result.  ``--lm-seeds S [S ...]`` runs only
``[lm]`` at those seeds and prints each one's f32 bands and errors.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import json
import math
import multiprocessing
import os
import pathlib
import re
import resource
import statistics
import subprocess
import sys
import time

import numpy as np

# [train] runs under torch.use_deterministic_algorithms(True), whose
# cuBLAS needs a fixed workspace set before CUDA initializes.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import prng  # noqa: E402

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
    "qwen3_8b's f32 card-against-CPU check runs 2 of its 36 layers at full width "
    "(~6.6 GB of f32 params on the host); its bf16 serving runs all 36",
    "qwen3_8b is served, not checkpointed: a 16.4 GB save and restore would add "
    "~45 s at the main path's ~0.8 GB/s",
    "[lm]'s seeded-sampling check serves 8 new tokens twice, not 32",
    "[train] trains 6 steps (one checkpoint at step 4, steps 5-6 run again after the "
    "restore), not to convergence",
    "[train]'s f32 card-against-CPU check runs 2 layers at full width (of RWKV6-1.6B's "
    "24 and Qwen3-8B's 36), B = 2, T = 16, one step's loss and gradients",
    "qwen3_8b is trained only in that check: its TrainState (8.19 B params x 14 bytes, "
    "115 GB) does not fit on one 80 GB card",
    "[families] serves qwen3_moe_30b_a3b, qwen2_moe_a2_7b, recurrentgemma_9b and "
    "whisper_tiny and trains none of them: their TrainStates (14 bytes a param: 427, 212, "
    "146 GB) do not fit on one 80 GB card but whisper_tiny's, which waits with the bench "
    "lanes",
    "[families]' f32 card-against-CPU check runs the MoE configs at 2 of their 48 and 24 "
    "layers and recurrentgemma_9b at 5 of 38 (one (R, R, A) group and a 2-layer tail), "
    "full width, B = 2, T = 16, 8 decode steps, one step's loss and gradients",
    "the MoE configs are served, not checkpointed: saves of 61.1 and 30.3 GB would add "
    "~75-120 s at the main path's ~0.7-0.8 GB/s",
    "[prng] holds threefry_normal to its plain version over a 2^26-draw window of "
    "Qwen3-8B's 622 M-draw embed leaf (and at every grid shape), and every launch of "
    "every path over the last 2^16 draws of each row, not over whole leaves: the plain "
    "version takes ~0.18 s a 2^26-draw window on the card",
    "[examples] runs serve_batch at its default arch (yi-6b smoke) only, and holds "
    "quickstart --full to the CPU through its placements and storage overhead, not "
    "through a CPU training run of the 124.6M-param model",
]

#: the card every phase runs on (a CPU rehearsal of phases 3-7 and 9 at a tiny
#: size sets this to "cpu"; the script itself always runs on "cuda").
DEV = "cuda"
SCALE_NODES = 10_000
SCALE_BATCH = 64
SCALE_COMMITTED = {"drex_sc": 256, "drex_lb": 24, "greedy_least_used": 256}
MS_NODES, MS_ITEMS = 1_000, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def queued_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the device milliseconds a call of ``fn``
    takes in a run of ``reps`` calls, all queued behind a ~10 ms sleep
    kernel, so that the host's time to issue them does not show: what
    the card spends, launch gaps included."""
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


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
    from repro_torch.kernels import nvcc, pb_frontier, rs_bitmatmul, threefry

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(lambda b: b(verbose=True),
                             (rs_bitmatmul.build, pb_frontier.build, threefry.build)))
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

    k_w, k_b = prng.split(prng.PRNGKey(seed))
    state = {
        "w": prng.normal(k_w, (512, 700), torch.bfloat16, device=DEV),
        "b": prng.normal(k_b, (3001,), device=DEV),
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


# -- 3b. jax.random on the card ([prng]) ------------------------------------------

PRNG_GOLDEN = ROOT / "tests" / "data" / "jax_prng_golden.npz"
#: models initialised at full width on the path, and the one served sampling.
PRNG_ARCHS = ("qwen3_8b", "rwkv6_1_6b")
PRNG_SERVE_ARCH = "rwkv6_1_6b"
PRNG_TEMPERATURE = 1.0
#: the draws of the window the plain version is held to and timed at.
PRNG_WINDOW = 1 << 26
#: the kernel-against-plain grid: draw counts, a stack of keys, and the
#: Gumbel-max shapes (the paths' decode batch of 4 at RWKV6-1.6B's and
#: Qwen3-8B's vocabularies, and a wide batch), checked and timed.
PRNG_COUNTS = (1, 7, 4099, (1 << 20) + 3)
PRNG_STACK = 36
PRNG_GUMBEL_SHAPES = ((4, 65_536), (4, 151_936), (64, 151_936))
#: the Gumbel-max shape the kernels line heads with (Qwen3-8B's decode).
PRNG_GUMBEL_HEAD = (4, 151_936)
#: a CPU rehearsal runs the path at smoke size.
PRNG_SMOKE = False
#: after a phase, each threefry_normal launch's last draws of each row are
#: held to the plain version: this many (the whole row when shorter).
DRAW_CHECK_WINDOW = 1 << 16


class DrawLaunches:
    """Every launch of the two threefry kernels in this process, phase by
    phase: ``main``'s ``timed`` resets it before a phase and checks it
    after (``phase_prng`` resets it again just before its path).  The
    kernels' wrappers are wrapped: a CUDA launch of ``threefry_normal``
    records its key table, count, offset, dtype and std and a copy of the
    last DRAW_CHECK_WINDOW draws of each row it wrote; one of
    ``gumbel_argmax`` its key, a copy of its logits and its tokens.
    ``check`` holds every record to the plain version on the card, bit
    for bit, and returns the phase's launch counts (the wrappers' own
    counters, which must equal the records) and shapes."""

    def __init__(self):
        from repro_torch.kernels import threefry

        self.mod = threefry
        self.normal, self.gumbel = threefry.threefry_normal, threefry.gumbel_argmax
        threefry.threefry_normal, threefry.gumbel_argmax = self._normal, self._gumbel
        self.reset()

    def reset(self) -> None:
        self.mod.reset_launches()
        self.records = []

    def _normal(self, keys, count, dtype, device, *, std=None, offset=0):
        out = self.normal(keys, count, dtype, device, std=std, offset=offset)
        if out.is_cuda and count > 0:
            w = min(count, DRAW_CHECK_WINDOW)
            self.records.append(("threefry_normal", np.array(keys, np.uint32).reshape(-1, 2),
                                 count, offset, dtype, std, out[:, count - w:].clone()))
        return out

    def _gumbel(self, key, logits):
        out = self.gumbel(key, logits)
        if out.is_cuda:
            self.records.append(("gumbel_argmax", np.array(key, np.uint32),
                                 logits.detach().contiguous().clone(), out.clone()))
        return out

    def check(self, phase: str) -> dict:
        from repro_torch.kernels import ref

        counts = dict(self.mod.launches)
        got = {name: sum(r[0] == name for r in self.records) for name in counts}
        if got != counts:
            raise AssertionError(f"[draws] {phase}: {counts} launches, {got} recorded")
        shapes: dict = {}
        for rec in self.records:
            if rec[0] == "threefry_normal":
                _, keys, count, offset, dtype, std, tail = rec
                w = tail.shape[1]
                want = ref.threefry_normal_ref(keys, offset + count - w, w, std, dtype, DEV)
                shape = (keys.shape[0], count, offset, str(dtype).split(".")[-1], std)
            else:
                _, key, logits, tail = rec
                want = ref.gumbel_argmax_ref(key, logits)
                shape = tuple(logits.shape)
            if not torch.equal(tail, want):
                raise AssertionError(f"[draws] {phase}: {rec[0]} at {shape} differs from "
                                     f"the plain version: {int((tail != want).sum())}")
            shapes[(rec[0], shape)] = shapes.get((rec[0], shape), 0) + 1
        self.records = []
        out = {"launches": counts, "shapes": {name: [] for name in counts}}
        for (name, shape), n in sorted(shapes.items(), key=str):
            keys = (("n_keys", "count", "offset", "dtype", "std") if name == "threefry_normal"
                    else ("rows", "vocab"))
            out["shapes"][name].append({**dict(zip(keys, shape)), "launches": n})
        return out


#: set by ``main``: the phases' threefry launches (``DrawLaunches``).
DRAWS = None


def golden_logits(rows: int, vocab: int) -> np.ndarray:
    """The golden file's categorical logits (``tests/jax_prng_golden.py``'s
    ``categorical_logits``): exact f32 in [0, 16) from integer hashing."""
    idx = np.arange(rows * vocab, dtype=np.uint64).reshape(rows, vocab)
    return (((idx * np.uint64(2654435761)) % np.uint64(65536)).astype(np.float32)
            / np.float32(4096.0))


def _normal_small_share(z: torch.Tensor) -> float:
    """The share of f32 normal draws ``z`` (no std) that took ``log1p``'s
    small-argument branch: |u| < sqrt(sqrt(2) - 1) is |z| below that
    bound's image under sqrt(2) * erfinv."""
    edge = float(np.float32(float.fromhex("0x1.a8279ap-2")))
    zt = float(torch.erfinv(torch.tensor(edge ** 0.5, dtype=torch.float64)) * 2 ** 0.5)
    return float((z.abs() < zt).double().mean())


def prng_golden_checks() -> dict:
    """The card against jax 0.9's draws in the golden file: keys, splits
    and fold_ins (host numpy), bits and hashes (the plain version on the
    card), f32 normals through ``threefry_normal`` (0 ulp), categorical
    tokens through ``gumbel_argmax``."""
    from repro_torch.kernels import ref, threefry

    with np.load(PRNG_GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    k7 = prng.PRNGKey(7)
    host = {
        "keys": np.stack([prng.PRNGKey(int(s)) for s in g["seeds"]]),
        "split_2": prng.split(k7), "split_5": prng.split(k7, 5),
        "split_3x4": prng.split(k7, (3, 4)),
        "fold_in": np.stack([prng.fold_in(k7, int(d)) for d in g["fold_data"]]),
        "stack_keys": prng.split(prng.PRNGKey(0), g["stack_keys"].shape[0]),
    }
    for name, got in host.items():
        if not np.array_equal(got, g[name]):
            raise AssertionError(f"[prng] {name} differs from jax's")
    bits = ref.threefry_bits_ref(k7, 0, g["bits"].size, DEV).cpu().numpy().astype(np.uint32)
    hi, lo = (torch.from_numpy(g["hash_counters"][:, i].astype(np.int64)).to(DEV)
              for i in (0, 1))
    h0, h1 = ref.threefry2x32_ref(int(k7[0]), int(k7[1]), hi, lo)
    hashes = torch.stack([h0, h1], 1).cpu().numpy().astype(np.uint32)
    if not (np.array_equal(bits, g["bits"]) and np.array_equal(hashes, g["hash"])):
        raise AssertionError("[prng] bits or threefry hashes on the card differ from jax's")
    shapes, normals = [], 0
    for name in sorted(k for k in g if k.startswith("normal_")):
        want = g[name]
        keys = g["stack_keys"] if name == "normal_stack" else k7[None]
        got = threefry.threefry_normal(keys, want.shape[-1], torch.float32, DEV)
        got = got.reshape(want.shape).cpu().numpy()
        if not np.array_equal(got.view(np.int32), want.view(np.int32)):
            bad = int((got.view(np.int32) != want.view(np.int32)).sum())
            raise AssertionError(f"[prng] {name}: {bad} kernel draws differ from jax's")
        shapes.append({"n_keys": keys.shape[0], "count": want.shape[-1], "dtype": "float32"})
        normals += want.size
    tokens = 0
    for name in sorted(k for k in g if k.startswith("categorical_")):
        rows, vocab = map(int, name.split("_")[1].split("x"))
        logits = torch.from_numpy(golden_logits(rows, vocab)).to(DEV)
        for seed, want in zip((0, 3), g[name]):
            got = threefry.gumbel_argmax(prng.PRNGKey(seed), logits).cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"[prng] {name} seed {seed}: tokens {got} != jax's {want}")
            tokens += rows
    return {"keys_splits_fold_ins": "equal", "bits": int(g["bits"].size), "hashes": "equal",
            "normals_bit_equal": normals, "max_ulp": 0, "tokens_equal": tokens,
            "normal_shapes": shapes}


def gumbel_cases():
    """``tests/gumbel_cases.py``: Gumbel-max's edge cases, one list with
    the CPU and card tests."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("gumbel_cases",
                                                  ROOT / "tests" / "gumbel_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def prng_plain_checks(seed: int) -> dict:
    """Both kernels against their plain versions on the card, bit for bit,
    at a grid of shapes: single draws, odd counts, 2^20 + 3, a 36-key
    stack, f32 and bf16 with and without ``std``, an offset window of
    Qwen3-8B's embed leaf; Gumbel-max at ``PRNG_GUMBEL_SHAPES`` and on
    the edge cases of ``tests/gumbel_cases.py`` (each holding its
    expected token where it has one)."""
    from repro_torch.kernels import ref, threefry

    key = prng.PRNGKey(seed)
    cases = []
    for count in PRNG_COUNTS:
        for n_keys in (1, PRNG_STACK):
            for dtype, std in ((torch.float32, None), (torch.bfloat16, 0.02),
                               (torch.float32, 1 / 4096 ** 0.5)):
                cases.append((prng.split(key, n_keys) if n_keys > 1 else key[None], count,
                              dtype, std, 0))
    # a window of the full-width embed leaf, from its own key
    emb_key = prng.split(key, 5)[0][None]
    emb_count, emb_std = 151_936 * 4_096, 1 / 4096 ** 0.5
    offset = emb_count - PRNG_WINDOW - 12_345
    cases.append((emb_key, PRNG_WINDOW, torch.bfloat16, emb_std, offset))
    checked, errs = [], {"threefry_normal": 0.0, "gumbel_argmax": 0.0}
    for keys, count, dtype, std, off in cases:
        got = threefry.threefry_normal(keys, count, dtype, DEV, std=std, offset=off)
        want = ref.threefry_normal_ref(keys, off, count, std, dtype, DEV)
        errs["threefry_normal"] = max(errs["threefry_normal"], max_err(got, want))
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"[prng] threefry_normal != plain at {keys.shape[0]} keys, "
                                 f"count {count}, {dtype}, std {std}, offset {off}: {bad}")
        checked.append({"n_keys": keys.shape[0], "count": count, "offset": off,
                        "dtype": str(dtype).split(".")[-1], "std": std})
    cases = gumbel_cases()
    gumbels = [(f"{rows}x{vocab}", prng.normal(prng.split(key, 2)[1], (rows, vocab),
                                               device=DEV, std=4.0), key, None)
               for rows, vocab in PRNG_GUMBEL_SHAPES]
    for name in cases.NAMES:
        logits, token = cases.case(name)
        gumbels.append((name, torch.from_numpy(logits).to(DEV),
                        prng.PRNGKey(cases.SEED), token))
    for name, logits, k, token in gumbels:
        rows, vocab = logits.shape
        for t in cases.TEMPERATURES:
            scaled = logits / torch.tensor(t, device=DEV)
            got = threefry.gumbel_argmax(k, scaled)
            want = ref.gumbel_argmax_ref(k, scaled)
            errs["gumbel_argmax"] = max(errs["gumbel_argmax"],
                                        float((got - want).abs().max()))
            if not torch.equal(got, want) or (
                    token is not None and got.tolist() != [token] * rows):
                raise AssertionError(f"[prng] gumbel_argmax at {name} ({rows}, {vocab}), "
                                     f"T = {t}: {got.tolist()}, plain {want.tolist()}, "
                                     f"expected {token}")
        checked.append({"case": name, "rows": rows, "vocab": vocab,
                        "temperatures": list(cases.TEMPERATURES)})
    return {"shapes": checked, "max_abs_err": errs, "gumbel_edge_cases": len(cases.NAMES),
            "embed_window": {"offset": offset, "count": PRNG_WINDOW}}


def prng_timing(seed: int) -> dict:
    """``threefry_normal`` at the embed leaf's 2^26-draw window (kernel,
    plain version, bound on the same inputs) and over the whole 622 M-draw
    leaf (kernel and bound); ``gumbel_argmax`` at ``PRNG_GUMBEL_SHAPES``:
    the kernel's device ms a call in 20 queued calls (``ms``) and one call
    at a time between its own events (``ms_single``, the host's issue time
    included), the plain version's, the bound, and
    ``torch.argmax`` of the same logits (``argmax_ms``): a one-pass
    reduction of the same bytes on this card, as a yardstick; it is not a
    call that computes the same function (``library_ms`` stays null).

    It times the kernels' own wrappers, not ``DrawLaunches``' recording
    ones (whose copies of each launch's logits and draws would be timed
    too), and clears the launch counts and records: these launches are
    no path's."""
    from repro_torch.kernels import ref, threefry

    normal = DRAWS.normal if DRAWS is not None else threefry.threefry_normal
    gumbel = DRAWS.gumbel if DRAWS is not None else threefry.gumbel_argmax

    emb_key = prng.split(prng.PRNGKey(seed), 5)[0][None]
    emb_count, std = 151_936 * 4_096, 1 / 4096 ** 0.5
    z = normal(emb_key, PRNG_WINDOW, torch.float32, DEV)
    share = _normal_small_share(z)
    del z
    win = {"count": PRNG_WINDOW, "dtype": "bfloat16", "small_branch_share": share}
    win["ms"] = cuda_time_ms(lambda: normal(
        emb_key, PRNG_WINDOW, torch.bfloat16, DEV, std=std))
    win["plain_ms"] = cuda_time_ms(lambda: ref.threefry_normal_ref(
        emb_key, 0, PRNG_WINDOW, std, torch.bfloat16, DEV), warmup=1, reps=3)
    b, by = threefry.normal_bound_s(PRNG_WINDOW, share, 2)
    win["bound_ms"], win["bound_by"] = b * 1e3, by
    leaf = {"count": emb_count, "dtype": "bfloat16"}
    leaf["ms"] = cuda_time_ms(lambda: normal(
        emb_key, emb_count, torch.bfloat16, DEV, std=std), warmup=1, reps=3)
    b, by = threefry.normal_bound_s(emb_count, share, 2)
    leaf["bound_ms"], leaf["bound_by"] = b * 1e3, by
    leaf["draws_per_s"] = emb_count / leaf["ms"] * 1e3
    key, gums = prng.PRNGKey(seed), []
    for rows, vocab in PRNG_GUMBEL_SHAPES:
        logits = prng.normal(prng.split(key, 2)[1], (rows, vocab), device=DEV)
        gum = {"rows": rows, "vocab": vocab, "slices": -(-vocab // threefry.GUMBEL_SLICE)}
        gum["pass1_blocks"] = rows * gum["slices"]
        gum["ms"] = queued_ms(lambda: gumbel(key, logits))
        gum["ms_single"] = cuda_time_ms(lambda: gumbel(key, logits),
                                        warmup=2, reps=20)
        gum["plain_ms"] = cuda_time_ms(lambda: ref.gumbel_argmax_ref(key, logits), reps=5)
        gum["argmax_ms"] = queued_ms(lambda: torch.argmax(logits, -1))
        b, by = threefry.gumbel_bound_s(rows, vocab)
        gum["bound_ms"], gum["bound_by"] = b * 1e3, by
        gum["x_bound"] = gum["ms"] / gum["bound_ms"]
        gums.append(gum)
        del logits
    head = next(g for g in gums if (g["rows"], g["vocab"]) == PRNG_GUMBEL_HEAD)
    out = {"normal_window": win, "normal_embed_leaf": leaf, "gumbel": head,
           "gumbel_shapes": gums}
    log("[prng] timing " + json.dumps(out))
    if DRAWS is not None:
        DRAWS.reset()     # the logits' draws and the timed calls are no path's
    else:
        threefry.reset_launches()
    torch.cuda.empty_cache()
    return out


def phase_prng(seed: int) -> dict:
    """[prng]: the kernels against jax's golden draws and their plain
    versions, then the path with the launch counts reset: Qwen3-8B and
    RWKV6-1.6B initialised at full width from ``PRNGKey(seed)``, and
    RWKV6-1.6B served at temperature 1.0 (4 x 128 prompt tokens, 32 new),
    its tokens held to the plain Gumbel-max on the logits it returned
    under the engine's key schedule (and every launch of the path to the
    plain version by ``DRAWS``).  The timings are ``prng_timing``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref, threefry
    from repro_torch.models import flatten_params, init_params
    from repro_torch.serve import ServeConfig, ServingEngine

    t_phase = time.perf_counter()
    report = {"golden": prng_golden_checks() if DEV == "cuda" else None}
    report["plain"] = prng_plain_checks(seed) if DEV == "cuda" else None
    marks = {"checks_s": time.perf_counter() - t_phase}
    if DRAWS is not None:
        DRAWS.reset()     # the comparisons above are not the path's
    else:
        threefry.reset_launches()
    inits = {}
    for arch in PRNG_ARCHS:
        cfg = get_config(arch, smoke=PRNG_SMOKE)
        before = threefry.launches["threefry_normal"]
        params, ms = host_ms(lambda: init_params(cfg, prng.PRNGKey(seed), device=DEV))
        flat = flatten_params(params)
        largest = max(flat, key=lambda n: flat[n].numel())
        inits[arch] = {"init_ms": ms, "launches": threefry.launches["threefry_normal"] - before,
                       "params": sum(t.numel() for t in flat.values()), "largest_leaf": largest,
                       "largest_numel": flat[largest].numel()}
        if arch == PRNG_SERVE_ARCH:
            served_params, served_cfg = params, cfg
        del params, flat
    eng = ServingEngine(served_cfg, served_params,
                        ServeConfig(max_new_tokens=LM_NEW, temperature=PRNG_TEMPERATURE,
                                    seed=seed), device=entry_device())
    prompts = np.random.default_rng(seed).integers(
        0, served_cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)
    ids, logits = eng.generate(prompts, return_logits=True)
    sync()
    # decode_s spans the steps after the first token: a step and a sample each
    decode_ms = eng.metrics["decode_s"] * 1e3 / max(ids.shape[1] - LM_PROMPT - 1, 1)
    launches = dict(threefry.launches)
    for name, n in launches.items():
        if n == 0 and DEV == "cuda":
            raise AssertionError(f"[prng] the path launched no {name}")
    # the engine's key schedule, then the plain Gumbel-max on the logits
    key, want = prng.PRNGKey(seed), []
    t = torch.tensor(PRNG_TEMPERATURE, dtype=logits.dtype, device=logits.device)
    for i in range(logits.shape[1]):
        key, sub = prng.split(key)
        want.append(ref.gumbel_argmax_ref(sub, logits[:, i] / t))
    want = torch.stack(want, 1).cpu().numpy()
    if not np.array_equal(ids[:, LM_PROMPT:], want):
        raise AssertionError("[prng] sampled tokens differ from the plain Gumbel-max on the "
                             "served logits")
    del served_params, eng, logits
    marks["path_s"] = time.perf_counter() - t_phase - marks["checks_s"]
    report.update({"inits": inits, "serve": {
        "arch": served_cfg.name, "temperature": PRNG_TEMPERATURE, "batch": LM_BATCH,
        "prompt_len": LM_PROMPT, "new_tokens": int(ids.shape[1] - LM_PROMPT),
        "decode_ms_per_sampled_step": decode_ms,
        "tokens_equal_plain": True}, "launches": launches})
    report["phase_parts_s"] = marks
    report["phase_s"] = time.perf_counter() - t_phase
    log("[prng] " + json.dumps(report))
    return report


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


# -- 7. the LM serving path ----------------------------------------------------


#: [lm]: the models served at full width, the request shape, and the
#: f32 card-against-CPU check's shape and depth (None = every layer).
LM_ARCHS = ("rwkv6_1_6b", "qwen3_8b")
LM_BATCH, LM_PROMPT, LM_NEW = 4, 128, 32
LM_CPU_PROMPT, LM_CPU_STEPS = 16, 8
LM_CPU_LAYERS = {"rwkv6_1_6b": None, "qwen3_8b": 2}
LM_TEMPERATURE, LM_SAMPLE_NEW = 0.8, 8
#: a CPU rehearsal sets this to serve the smoke configs.
LM_SMOKE = False
#: How far two computations of the same logits may differ when only
#: their rounding differs.  A model's sensitivity to rounding is measured
#: in the run: the band is how far its f32 forward moves when the batch is
#: split into single rows (only the matmul shapes, so the summation
#: orders, change).  On an H100 that is ~2.4e-5 for Qwen3-8B but ~0.32 for
#: random-init RWKV6-1.6B (max abs over 4 x 159 x 65,536 logits; mean
#: ~1.6e-3): its per-head group norm divides by the head's own scale, and
#: a head whose scale rounds near zero turns rounding into an O(1) change.
#: f32 checks (teacher-forced decode against the full forward, the card
#: against the port on the CPU) hold max and mean abs error to
#: max(LM_F32_FLOOR, LM_BAND x band), the CPU check's band measured on the
#: logits it holds (row 0, its positions); the served bf16 logits are held to
#: the f32 forward within LM_BAND x the bf16 forward's own distance from
#: it.  A wrong position, mask or state moves every logit by ~1.
LM_F32_FLOOR = {"max_abs_err": 1e-3, "mean_abs_err": 1e-4}
LM_BAND = 2.0


def sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def host_ms(fn) -> tuple:
    """``(fn(), ms)`` on the host clock, the device drained on both sides."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def teacher_forced(params, cfg, ids: np.ndarray, n_prompt: int, device,
                   frames=None) -> tuple:
    """Prefill ``ids[:, :n_prompt]`` (and an encoder-decoder's ``frames``)
    as the serving engine does (a cache sized for all of ``ids``) and
    decode the rest of ``ids`` one token at a time.  Returns (logits at
    positions n_prompt-1 .. T-2, stacked (B, T-n_prompt, V), prefill ms,
    per-step decode ms)."""
    from repro_torch.models import decode_step
    from repro_torch.serve.engine import prime

    t = ids.shape[1]
    (logits, state), prefill_ms = host_ms(lambda: prime(params, ids[:, :n_prompt], cfg, t,
                                                        device, frames=frames))
    out, step_ms = [logits], []
    for pos in range(n_prompt, t - 1):
        (logits, state), ms = host_ms(lambda: decode_step(params, ids[:, pos:pos + 1], pos,
                                                          state, cfg, device=device))
        out.append(logits)
        step_ms.append(ms)
    return torch.stack(out, dim=1), prefill_ms, step_ms


def abs_errors(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a.float() - b.float().to(a.device)).abs()
    return {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean())}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return abs_errors(a, b)["max_abs_err"]


def f32_errors(a: torch.Tensor, b: torch.Tensor, tol: dict, what: str) -> dict:
    """Max and mean abs error of f32 logits, held to ``tol``."""
    out = {**abs_errors(a, b), "tol": tol}
    if not all(out[k] <= v for k, v in tol.items()):
        raise AssertionError(f"{what}: {out}")
    return out


def lm_cpu_check(arch: str, p32, c32, ids: np.ndarray, tol: dict) -> dict:
    """The f32 params (cut to ``LM_CPU_LAYERS`` layers) on the card and
    on the host: B = 1, an LM_CPU_PROMPT-token prompt and LM_CPU_STEPS
    teacher-forced steps; the logits must agree within ``tol``."""
    from repro_torch.models import model

    depth = LM_CPU_LAYERS[arch]
    depth = c32.n_layers if depth is None or LM_SMOKE else depth
    cut = c32.with_(n_layers=depth)
    card = {**{k: v for k, v in p32.items() if k != "layers"},
            "layers": model.tree_map(lambda x: x[:depth], p32["layers"])}
    seq = ids[:1, :LM_CPU_PROMPT + LM_CPU_STEPS + 1]
    card_tf, _, _ = teacher_forced(card, cut, seq, LM_CPU_PROMPT, entry_device())
    host = model.tree_map(lambda x: x.cpu(), card)
    host_tf, _, _ = teacher_forced(host, cut, seq, LM_CPU_PROMPT, "cpu")
    return {"layers": depth, "batch": 1, "prompt_len": LM_CPU_PROMPT,
            "steps": LM_CPU_STEPS,
            **f32_errors(card_tf, host_tf, tol, f"{arch}: f32 logits, card against CPU"),
            "host_params_GB": sum(x.numel() * 4 for x in model.tree_leaves(host)) / 1e9}


def device_time(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the kernels it
    launched and their summed device ms."""
    from torch.profiler import ProfilerActivity, profile

    if DEV != "cuda":
        return {"kernels": None, "device_ms": None}
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if not kernels:
        raise AssertionError("the profiler saw no kernel on the card")
    return {"kernels": len(kernels), "device_ms": sum(e.device_time for e in kernels) / 1e3}


def wkv_share(params, cfg, prompts: np.ndarray, reps: int = 3) -> dict:
    """The WKV loop (``_rwkv_core_scan``, once per layer at the prefill's
    shapes) against the whole prefill, timed in turns on the host clock
    (both are bound by launches)."""
    from repro_torch.models import model
    from repro_torch.models.recurrent import _rwkv_core_scan

    ks = prng.split(prng.PRNGKey(0), 5)
    h, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    shape = (LM_BATCH, LM_PROMPT, h, hd)
    r, k, v = (prng.normal(ks[i], shape, device=DEV) for i in range(3))
    w = torch.sigmoid(prng.normal(ks[3], shape, device=DEV))    # decays in (0, 1)
    u = prng.normal(ks[4], (h, hd), device=DEV)
    s0 = torch.zeros((LM_BATCH, h, hd, hd), device=DEV)

    def loop():
        for _ in range(cfg.n_layers):
            _rwkv_core_scan(r, k, v, w, u, s0, cfg.rwkv_chunk)

    def prefill():
        model.prefill(params, prompts, cfg, device=entry_device())

    loop()
    wkv, whole = [], []
    for _ in range(reps):
        wkv.append(host_ms(loop)[1])
        whole.append(host_ms(prefill)[1])
    out = {"ms": statistics.median(wkv), "prefill_ms": statistics.median(whole)}
    out["share_of_prefill"] = out["ms"] / out["prefill_ms"]
    return out


def phase_lm(arch: str, seed: int) -> dict:
    """One model served on the card at full width (smoke size in a CPU
    rehearsal): init from ``--seed``, 4 greedy requests twice (tokens and
    logits bit-equal), teacher-forced decode against the full forward,
    seeded sampling twice, the f32 card-against-CPU check, timings."""
    from repro_torch.configs import get_config
    from repro_torch.models import flatten_params, forward, init_params, model
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve.engine import prime

    cfg = get_config(arch, smoke=LM_SMOKE)
    resident = 0.0
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9
    t_phase = time.perf_counter()
    params, init_ms = host_ms(lambda: init_params(cfg, prng.PRNGKey(seed), device=DEV))
    marks = [("init", time.perf_counter())]
    flat = flatten_params(params)
    off = [n for n, t in flat.items() if t.device.type != DEV]
    if off:
        raise AssertionError(f"{arch}: params off the card: {off}")
    if arch == "rwkv6_1_6b" and not LM_SMOKE:
        got = [(n, tuple(t.shape)) for n, t in flat.items()]
        if got != RWKV6_1_6B or any(t.dtype != torch.bfloat16 for t in flat.values()):
            raise AssertionError("rwkv6_1_6b's params differ from the JAX layout RWKV6_1_6B")
    n_params = sum(t.numel() for t in flat.values())
    n_bytes = sum(t.numel() * t.element_size() for t in flat.values())
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)

    def serve(new=LM_NEW, **kw):
        eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=new, **kw),
                            device=entry_device())
        ids, logits = eng.generate(prompts, return_logits=True)
        return eng, ids, logits

    _, ids, logits = serve()
    eng, ids2, logits2 = serve()
    if not (np.array_equal(ids, ids2) and torch.equal(logits, logits2)):
        raise AssertionError(f"{arch}: a second greedy run served other tokens or logits")
    marks.append(("greedy_twice", time.perf_counter()))
    # Teacher-forced decode against the full forward over the served
    # 128 + 32 tokens, in f32 (the same params upcast) on the card.
    if DEV == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                          or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on: the f32 checks need full f32 matmuls")
    c32 = cfg.with_(dtype="float32")
    p32 = model.tree_map(lambda x: x.float(), params)
    full32 = forward(p32, ids[:, :-1], c32, device=entry_device())[0]
    rows32 = torch.cat([forward(p32, ids[i:i + 1, :-1], c32, device=entry_device())[0]
                        for i in range(LM_BATCH)])
    band32 = abs_errors(full32, rows32)
    # The CPU check holds row 0's logits at positions LM_CPU_PROMPT - 1 ..
    # LM_CPU_PROMPT + LM_CPU_STEPS - 1; its band is the same split measured
    # on those logits (random-init RWKV6's sensitivity varies ~10x by row
    # and position, so a band averaged over the batch does not bound them).
    near = slice(LM_CPU_PROMPT - 1, LM_CPU_PROMPT + LM_CPU_STEPS)
    band_cpu = abs_errors(full32[:1, near], rows32[:1, near])
    del rows32
    full32 = full32[:, LM_PROMPT - 1:]
    tol32 = {k: max(v, LM_BAND * band32[k]) for k, v in LM_F32_FLOOR.items()}
    tol_cpu = {k: max(v, LM_BAND * band_cpu[k]) for k, v in LM_F32_FLOOR.items()}
    tf32, _, _ = teacher_forced(p32, c32, ids, LM_PROMPT, entry_device())
    tf_err = f32_errors(tf32, full32, tol32, f"{arch}: f32 decode against the full forward")
    del tf32
    full16 = forward(params, ids[:, :-1], cfg, device=entry_device())[0][:, LM_PROMPT - 1:]
    band16 = max_err(full16, full32)
    served_err = max_err(logits, full32)
    served_vs_bf16 = max_err(logits, full16)
    agree = float((logits.argmax(-1) == full32.argmax(-1)).float().mean())
    del full16, full32
    if not served_err <= LM_BAND * band16:
        raise AssertionError(f"{arch}: served bf16 logits are {served_err} from the f32 "
                             f"forward, the bf16 forward {band16}")
    marks.append(("f32_and_bf16_checks", time.perf_counter()))
    cpu = {**lm_cpu_check(arch, p32, c32, ids, tol_cpu), "band": band_cpu}
    del p32
    marks.append(("card_vs_cpu", time.perf_counter()))
    _, ids_s, _ = serve(LM_SAMPLE_NEW, temperature=LM_TEMPERATURE, seed=seed)
    _, ids_s2, _ = serve(LM_SAMPLE_NEW, temperature=LM_TEMPERATURE, seed=seed)
    if not np.array_equal(ids_s, ids_s2):
        raise AssertionError(f"{arch}: seeded sampling served other tokens the second time")
    marks.append(("sampling_twice", time.perf_counter()))
    _, prefill_ms, step_ms = teacher_forced(params, cfg, ids, LM_PROMPT, entry_device())
    prefill_runs = [host_ms(lambda: model.prefill(params, prompts, cfg,
                                                  device=entry_device()))[1]
                    for _ in range(3)]
    # The card's busy share of a decode step: summed kernel time
    # (profiled) over the unprofiled wall time.  (A prefill is not
    # profiled: RWKV6's ~24,000 kernels take the profiler ~20 s.)
    _, state = prime(params, ids[:, :LM_PROMPT], cfg, LM_PROMPT + LM_NEW, entry_device())
    prof = device_time(lambda: model.decode_step(
        params, ids[:, LM_PROMPT:LM_PROMPT + 1], LM_PROMPT, state, cfg,
        device=entry_device()))
    del state
    marks.append(("timing_and_profile", time.perf_counter()))
    if prof["device_ms"] is not None:
        prof["busy_share"] = prof["device_ms"] / statistics.median(step_ms)
    report = {
        "model": cfg.name, "params": n_params, "bytes": n_bytes, "dtype": cfg.dtype,
        "layers": cfg.n_layers, "batch": LM_BATCH, "prompt_len": LM_PROMPT,
        "new_tokens": LM_NEW, "init_ms": init_ms,
        "prefill_ms": statistics.median(prefill_runs), "prefill_ms_runs": prefill_runs,
        "engine_prefill_ms": eng.metrics["prefill_s"] * 1e3,
        "decode_ms_per_step_p50": statistics.median(step_ms),
        "decode_ms_per_step_max": max(step_ms),
        "decode_tokens_per_s": eng.decode_tokens_per_s,
        "tokens_out": eng.metrics["tokens_out"],
        "decode_step_profile": prof,
        "checks": {
            "greedy_twice": {"tokens_equal": True, "logits_bit_equal": True},
            "f32_band_rows_vs_batch": band32,
            "decode_vs_forward_f32": {**tf_err, "batch": LM_BATCH,
                                      "tokens": LM_PROMPT + LM_NEW},
            "served_bf16_vs_forward_f32": {"max_abs_err": served_err,
                                           "tol": LM_BAND * band16,
                                           "bf16_forward_vs_f32": band16,
                                           "vs_forward_bf16": served_vs_bf16,
                                           "argmax_agreement": agree},
            "card_vs_cpu_f32": cpu,
            "sampling_twice": {"temperature": LM_TEMPERATURE, "new_tokens": LM_SAMPLE_NEW,
                               "tokens_equal": True, "differs_from_greedy":
                               not np.array_equal(ids_s, ids[:, :LM_PROMPT + LM_SAMPLE_NEW])},
        },
        "greedy_tokens_head": ids[0, LM_PROMPT:LM_PROMPT + 8].tolist(),
    }
    if cfg.block_pattern == "rwkv6":
        report["wkv_loop"] = wkv_share(params, cfg, prompts)
        marks.append(("wkv_loop", time.perf_counter()))
    report["phase_parts_s"] = {name: t - prev for (_, prev), (name, t)
                               in zip([("start", t_phase)] + marks, marks)}
    if DEV == "cuda":
        report["device_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        report["device_resident_before_GB"] = resident
    report["phase_s"] = time.perf_counter() - t_phase
    log("[lm] " + json.dumps(report))
    return {"report": report, "cfg": cfg, "params": params, "prompts": prompts,
            "ids": ids, "logits": logits}


def serve_restored(lm: dict, restored: dict) -> dict:
    """The restored state dict, back into params, serves the same prompts:
    tokens equal and every logit bit-equal to the pre-save run."""
    from repro_torch.models import unflatten_params
    from repro_torch.serve import ServeConfig, ServingEngine

    params = unflatten_params(restored)
    eng = ServingEngine(lm["cfg"], params, ServeConfig(max_new_tokens=LM_NEW),
                        device=entry_device())
    ids, logits = eng.generate(lm["prompts"], frames=lm.get("frames"), return_logits=True)
    if not np.array_equal(ids, lm["ids"]):
        raise AssertionError("the restored params served other tokens")
    if not torch.equal(logits, lm["logits"]):
        raise AssertionError("the restored params served other logits: max abs "
                             f"difference {max_err(logits, lm['logits'])}")
    return {"tokens_equal": True, "logits_bit_equal": True,
            "tokens": int(ids.size), "logits": int(logits.numel())}


# -- 8. the main path ---------------------------------------------------------


def phase_main(lm: dict) -> dict:
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.core import ClusterView, DataItem, PlacementEngine, shapes
    from repro_torch.kernels import ops, pb_frontier, rs_bitmatmul
    from repro_torch.models import flatten_params
    from repro_torch.storage import make_node_set

    # The [lm] phase's RWKV6-1.6B params, under their JAX tree paths.
    state = flatten_params(lm["params"])
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
    after_restore = ops.launch_stats()
    # The restored weights serve the [lm] phase's prompts again.
    t0 = time.perf_counter()
    served = serve_restored(lm, restored)
    served["s"] = time.perf_counter() - t0
    del restored

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
        "served_after_restore": served,
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


# -- 9. the training path ----------------------------------------------------

#: [train]: the model trained at full width, the launcher's step batch,
#: optimizer and data, and the run: one async checkpoint at step 4 of 6.
TRAIN_ARCH = "rwkv6_1_6b"
TRAIN_BATCH, TRAIN_SEQ = 8, 128
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 4
TRAIN_LR, TRAIN_WARMUP = 3e-3, 5
#: the f32 card-against-CPU check: models, depth, batch and length.
TRAIN_CHECK_ARCHS = ("rwkv6_1_6b", "qwen3_8b")
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 16
#: a CPU rehearsal sets this to train the smoke configs.
TRAIN_SMOKE = False
#: Floors of that check, as fractions of the card's value: |loss| for the
#: loss, the leaf's max |g| for a gradient leaf.  The tolerance is
#: max(floor, LM_BAND x band), the band measured as [lm] measures it: how
#: far the f32 loss and gradients move on the card when the batch is split
#: into rows (the mean of the rows' losses and gradients is the batch's).
#: The card's row and batch runs share their reduction kernels, so the
#: band can miss the CPU's other summation orders: RWKV6-1.6B's
#: ``layers.tmix.bonus_u`` (an f32 sum of B x T x 64 products that
#: cancels) lay 2.6e-4 of its max |g| from the CPU's on an H100, against a
#: 1e-4 floor.  A wrong gradient moves a leaf by O(1) of its max.
TRAIN_LOSS_FLOOR = {"max_abs_err": 1e-5, "mean_abs_err": 1e-5}
TRAIN_GRAD_FLOOR = {"max_abs_err": 1e-3, "mean_abs_err": 1e-4}


def after(fut: concurrent.futures.Future, on_done) -> concurrent.futures.Future:
    """A future that resolves as ``fut`` does once ``on_done(fut)`` has
    run: what ``on_done`` records is there when ``result()`` returns (a
    done callback may run after the waiter wakes)."""
    out: concurrent.futures.Future = concurrent.futures.Future()

    def relay(f):
        try:
            on_done(f)
        finally:
            if f.exception() is not None:
                out.set_exception(f.exception())
            else:
                out.set_result(f.result())

    fut.add_done_callback(relay)
    return out


class SnapshotCheckpointer:
    """The Trainer's checkpointer (``TrainStateCheckpointer``) that also
    keeps a host copy of the state it is asked to save, and times the
    save: ``stall_s`` (the call, which takes the snapshot and returns)
    and ``save_s`` (until the last chunk is on the fabric)."""

    def __init__(self, inner):
        self.inner = inner
        self.snapshot: dict = {}
        self.times: dict = {}

    def save_async(self, state, step):
        from repro_torch.train import train_state_dict

        self.snapshot = {n: t.to("cpu", copy=True) for n, t in train_state_dict(state).items()}
        sync()
        t0 = time.perf_counter()
        fut = self.inner.save_async(state, step)
        self.times["stall_s"] = time.perf_counter() - t0
        return after(fut, lambda f: self.times.setdefault("save_s", time.perf_counter() - t0))

    def restore_latest(self, cfg):
        return self.inner.restore_latest(cfg)


def timed_steps(trainer, out: list, overlapped: list | None = None) -> None:
    """Time each of ``trainer``'s steps on the host clock, the device
    drained on both sides (the save's stream too); with ``overlapped``,
    note for each step whether an async save was pending as it began."""
    inner = trainer.step_fn

    def step(state, batch):
        if overlapped is not None:
            fut = trainer._pending_ckpt
            overlapped.append(fut is not None and not fut.done())
        result, ms = host_ms(lambda: inner(state, batch))
        out.append(ms)
        return result

    trainer.step_fn = step


def wkv_train_share(step_fn, state, batch, cfg, reps: int = 2) -> dict:
    """The WKV loop of one train step against the step, timed in turns on
    the host clock (both are bound by launches).  Under ``remat="full"`` a
    step runs each layer's loop forward twice (the block's first pass and
    its recomputation in the backward) and backward once: the loop here
    does that ``n_layers`` times at the step's shapes.  ``step_fn``
    consumes ``state``."""
    from repro_torch.models.recurrent import _rwkv_core_scan

    ks = prng.split(prng.PRNGKey(0), 6)
    h, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    shape = (TRAIN_BATCH, TRAIN_SEQ, h, hd)
    r, k, v = (prng.normal(ks[i], shape, device=DEV).requires_grad_() for i in range(3))
    w = torch.sigmoid(prng.normal(ks[3], shape, device=DEV)).requires_grad_()
    u = prng.normal(ks[4], (h, hd), device=DEV).requires_grad_()
    s0 = torch.zeros((TRAIN_BATCH, h, hd, hd), device=DEV)
    gy = prng.normal(ks[5], shape, device=DEV)

    def loop():
        for _ in range(cfg.n_layers):
            _rwkv_core_scan(r, k, v, w, u, s0)
            y, _ = _rwkv_core_scan(r, k, v, w, u, s0)
            torch.autograd.grad(y, (r, k, v, w, u), gy)

    loop()
    wkv, whole = [], []
    for _ in range(reps):
        wkv.append(host_ms(loop)[1])
        (state, _), ms = host_ms(lambda: step_fn(state, batch))
        whole.append(ms)
    out = {"ms": statistics.median(wkv), "step_ms": statistics.median(whole),
           "loop_ms_runs": wkv, "step_ms_runs": whole}
    out["share_of_step"] = out["ms"] / out["step_ms"]
    return out


def value_and_grads(params, batch, cfg, device) -> tuple:
    """(loss, grads in tree order) of ``loss_fn`` through autograd."""
    from repro_torch.models import loss_fn
    from repro_torch.models.model import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, leaves), batch, cfg, device=device)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def train_cpu_check(arch: str, seed: int) -> dict:
    """One step's f32 loss and gradients on the card and on the CPU, with
    the model cut to TRAIN_CHECK_LAYERS layers at full width, held to
    max(floor, LM_BAND x band) leaf by leaf (TRAIN_LOSS_FLOOR,
    TRAIN_GRAD_FLOOR)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, LMDataPipeline
    from repro_torch.models import flatten_params, init_params, model

    cfg = get_config(arch, smoke=TRAIN_SMOKE).with_(dtype="float32",
                                                    n_layers=TRAIN_CHECK_LAYERS)
    params = init_params(cfg, prng.PRNGKey(seed), device=DEV)
    names = list(flatten_params(params))
    batch = LMDataPipeline(DataConfig(cfg.vocab_size, TRAIN_CHECK_SEQ, TRAIN_CHECK_BATCH,
                                      seed=seed), device=entry_device()).next_batch()
    loss, grads = value_and_grads(params, batch, cfg, entry_device())
    # the band: the mean of the rows' losses and gradients
    row_loss, row_grads = 0.0, [torch.zeros_like(g) for g in grads]
    for i in range(TRAIN_CHECK_BATCH):
        li, gi = value_and_grads(params, {k: v[i:i + 1] for k, v in batch.items()}, cfg,
                                 entry_device())
        row_loss = row_loss + li / TRAIN_CHECK_BATCH
        for acc, g in zip(row_grads, gi):
            acc.add_(g / TRAIN_CHECK_BATCH)
    host = model.tree_map(lambda x: x.cpu(), params)
    h_loss, h_grads = value_and_grads(host, {k: v.cpu() for k, v in batch.items()}, cfg, "cpu")
    del params
    rows = []

    def hold(what, card, row, cpu, scale, floor=TRAIN_GRAD_FLOOR):
        band = abs_errors(card, row)
        err = abs_errors(card, cpu)
        tol = {k: max(v * scale, LM_BAND * band[k]) for k, v in floor.items()}
        rows.append({"leaf": what, **err, "of_max": err["max_abs_err"] / max(scale, 1e-30),
                     "tol": tol, "band": band,
                     "of_tol": max((err[k] / tol[k] for k in tol if tol[k] > 0), default=0.0),
                     "ok": all(err[k] <= tol[k] for k in tol)})

    hold("loss", loss, row_loss, h_loss, abs(float(loss)), TRAIN_LOSS_FLOOR)
    for name, g, r, hg in zip(names, grads, row_grads, h_grads):
        hold(name, g, r, hg, float(g.abs().max()))
    rows.sort(key=lambda x: -x["of_tol"])
    if not all(x["ok"] for x in rows):
        raise AssertionError(f"{arch}: f32 loss and gradients, card against CPU, worst "
                             f"first: {json.dumps(rows[:6])}")
    return {"layers": TRAIN_CHECK_LAYERS, "batch": TRAIN_CHECK_BATCH,
            "seq_len": TRAIN_CHECK_SEQ, "loss_card": float(loss), "loss_cpu": float(h_loss),
            "leaves_checked": len(rows), "worst": rows[:3]}


def phase_train(seed: int) -> dict:
    """RWKV6-1.6B trained at full width on the card through the port's
    Trainer; its whole TrainState saved through D-Rex SC at step 4, a node
    holding chunks lost, the state restored bit-equal to step 4's, and
    steps 5-6 run again bit-equal to the uninterrupted run; the WKV loop's
    share of a step; the f32 card-against-CPU check.  Every launch count
    is set to 0 just before the run and read just after the resumed run."""
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.configs import get_config
    from repro_torch.core import shapes
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops, pb_frontier, rs_bitmatmul
    from repro_torch.optim import AdamWConfig
    from repro_torch.storage import make_node_set
    from repro_torch.train import (Trainer, TrainerConfig, TrainStateCheckpointer,
                                   init_train_state, make_train_step, train_state_dict)

    cfg = get_config(TRAIN_ARCH, smoke=TRAIN_SMOKE)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    if not torch.are_deterministic_algorithms_enabled():
        raise AssertionError("[train] runs under torch.use_deterministic_algorithms(True)")
    t_phase = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    fabric = StorageFabric(make_node_set("most_used"))
    ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(), device=DEV)
    like = init_train_state(cfg, prng.PRNGKey(0), device="meta")
    recorder = SnapshotCheckpointer(TrainStateCheckpointer(ck, like))

    def trainer(step_ms: list, overlapped: list | None = None):
        t = Trainer(cfg, opt_cfg,
                    TrainerConfig(steps=TRAIN_STEPS, log_every=1, ckpt_every=TRAIN_CKPT_EVERY,
                                  seed=seed, async_ckpt=True),
                    data_cfg=DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed),
                    checkpointer=recorder, log_fn=lambda s, m: None, device=entry_device())
        timed_steps(t, step_ms, overlapped)
        return t

    # The [train] path's run: every count set to 0 just before, read after
    # the resumed steps.
    shapes.reset()
    ops.reset_launch_stats()
    rs_bitmatmul.reset_launches()
    pb_frontier.reset_launches()

    step_ms: list = []
    overlapped: list = []
    straight = trainer(step_ms, overlapped)
    final = straight.run()
    marks = [("train_and_save", time.perf_counter())]
    # The save returns after its snapshot, so the steps after it run while
    # it encodes; they are held bit-equal to the resumed run's below.
    if DEV == "cuda" and not overlapped[TRAIN_CKPT_EVERY]:
        raise AssertionError(f"step {TRAIN_CKPT_EVERY + 1} began after the async save "
                             f"had ended: {overlapped}")
    device_peak_train = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None
    n_params = sum(t.numel() for n, t in train_state_dict(final).items()
                   if n.startswith("params."))
    state_bytes = sum(t.numel() * t.element_size() for t in train_state_dict(final).values())
    manifest = ck._manifests[TRAIN_CKPT_EVERY]
    groups = [g for m in manifest["leaves"] for g in m["groups"]]
    hist = collections.Counter(f"({g['k']},{g['p']})" for g in groups)
    after_save = ops.launch_stats()
    frontier_after_save = pb_frontier.launches
    if DEV == "cuda" and (after_save["encode"] == 0 or frontier_after_save == 0):
        raise AssertionError(f"the save skipped a kernel: {after_save}, "
                             f"{frontier_after_save} pb_frontier launches")
    history = list(straight.history)
    for h in history:
        if not all(np.isfinite(h[k]) for k in ("loss", "nll", "grad_norm", "lr")):
            raise AssertionError(f"[train] step {h['step']}: a metric is not finite: {h}")
    at_save = recorder.snapshot

    victim = groups[0]["node_ids"][0]
    fabric.fail_node(victim)
    resumed_ms: list = []
    resumed = trainer(resumed_ms)
    state, restore_ms = host_ms(resumed.init_or_restore)
    marks.append(("restore", time.perf_counter()))
    if resumed.start_step != TRAIN_CKPT_EVERY or resumed.data.step != 0:
        raise AssertionError(f"restored step {resumed.start_step} with the data at batch "
                             f"{resumed.data.step}, saved {TRAIN_CKPT_EVERY}")
    # As the reference's, the restored pipeline starts at batch 0; the
    # uninterrupted run's steps 5-6 trained on batches 4-5.
    resumed.data.step = resumed.start_step
    restored = train_state_dict(state)
    if list(restored) != list(at_save):
        raise AssertionError("the restored TrainState's leaves differ from the saved one's")
    for name, t in restored.items():
        if not (t.dtype == at_save[name].dtype and torch.equal(t, at_save[name].to(t.device))):
            raise AssertionError(f"restore after node {victim} failed differs at {name}")
    del at_save, restored
    recorder.snapshot = {}
    after_restore = ops.launch_stats()
    state = resumed.run(state)
    marks.append(("resume", time.perf_counter()))
    for a, b in zip(history[TRAIN_CKPT_EVERY:], resumed.history):
        if a != {**b, "steps_per_s": a["steps_per_s"]}:
            raise AssertionError(f"resumed step {b['step']} differs: {b} against {a}")
    if [h["step"] for h in resumed.history] != list(range(TRAIN_CKPT_EVERY + 1,
                                                          TRAIN_STEPS + 1)):
        raise AssertionError(f"the resumed run logged {resumed.history}")
    want = train_state_dict(final)
    for name, t in train_state_dict(state).items():
        if not torch.equal(t, want[name]):
            raise AssertionError(f"the resumed run's final state differs at {name}")
    final_digest = state_digest(want)
    del want
    launches = rs_bitmatmul.launches
    per_kind = ops.launch_stats()
    frontier_launches = pb_frontier.launches
    issued = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    frontier_shapes = sorted(shapes.issued_shapes("pb_frontier"))
    ck_stats = dict(ck.stats)
    ck.close()
    if DEV == "cuda" and (launches != per_kind["encode"] + per_kind["decode"]
                          or per_kind["decode"] == 0):
        raise AssertionError(f"launch counts disagree: {launches} vs {per_kind}")
    device_peak_phase = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None
    del final, fabric, ck
    share = wkv_train_share(make_train_step(cfg, opt_cfg), state, resumed.data.next_batch(),
                            cfg)
    del state
    marks.append(("wkv_loop", time.perf_counter()))

    gb = state_bytes / 1e9
    p50 = statistics.median(step_ms)
    report = {
        "model": cfg.name, "params": n_params, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "remat": cfg.remat, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "ckpt_at": TRAIN_CKPT_EVERY, "lr": TRAIN_LR,
        "train_state": {"leaves": len(manifest["leaves"]), "bytes": state_bytes,
                        "moments_and_master_included": True},
        "step_ms": step_ms, "step_ms_p50": p50,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (p50 / 1e3),
        "resumed_step_ms": resumed_ms,
        "history": [{k: h[k] for k in ("step", "loss", "nll", "grad_norm", "lr")}
                    for h in history],
        "wkv_loop": share,
        "steps_overlapping_save": [i + 1 for i, o in enumerate(overlapped) if o],
        "step_ms_overlapping_save": [ms for ms, o in zip(step_ms, overlapped) if o],
        "step_ms_without_save": [ms for ms, o in zip(step_ms, overlapped) if not o],
        "save": {"stall_s": recorder.times["stall_s"], "save_s": recorder.times["save_s"],
                 "save_GBps": gb / recorder.times["save_s"],
                 "place_s": ck_stats["place_s"], "encode_s": ck_stats["encode_s"],
                 "groups": len(groups), "kp_histogram": dict(hist),
                 "bytes_stored": ck_stats["bytes_stored"]},
        "failed_node": victim,
        "restore_s": restore_ms / 1e3, "restore_GBps": gb / (restore_ms / 1e3),
        "restored_bit_equal_to_step": TRAIN_CKPT_EVERY,
        "resumed_bit_equal": {"losses": True, "final_state": True,
                              "steps": [h["step"] for h in resumed.history]},
        "launches": {"rs_bitmatmul": launches, "save_encode": after_save["encode"],
                     "restore_decode": after_restore["decode"] - after_save["decode"],
                     "pb_frontier": frontier_launches},
        "pb_frontier_shapes": [list(s) for s in frontier_shapes],
        "host_peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
        "device_peak_GB": {"train_and_save": device_peak_train,
                           "with_restored_state": device_peak_phase},
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
    }
    report["phase_parts_s"] = {name: t - prev for (_, prev), (name, t)
                               in zip([("start", t_phase)] + marks, marks)}
    log("[train] " + json.dumps(report))
    if DEV == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["card_vs_cpu_f32"] = {arch: train_cpu_check(arch, seed)
                                 for arch in TRAIN_CHECK_ARCHS}
    report["card_vs_cpu_s"] = time.perf_counter() - t0
    report["phase_s"] = time.perf_counter() - t_phase
    log("[train] card against CPU, f32: " + json.dumps(
        {k: report[k] for k in ("card_vs_cpu_f32", "card_vs_cpu_s", "phase_s")}))
    return {"report": report, "issued": issued, "launches": launches,
            "frontier_launches": frontier_launches, "frontier_shapes": frontier_shapes,
            "history": history, "digest": final_digest}


def state_digest(named: dict) -> dict:
    """A fingerprint of every leaf's bytes, computed on its device: two
    position-weighted 64-bit sums of its 32-bit words (wrapping), so two
    states compare without a second copy of either."""
    out = {}
    for name, t in named.items():
        words = t.detach().contiguous().reshape(-1).view(torch.uint8)
        words = words.view(torch.int32 if words.numel() % 4 == 0 else torch.uint8).reshape(-1)
        a = b = 0
        for lo in range(0, words.numel(), 1 << 26):
            w = words[lo:lo + (1 << 26)].to(torch.int64)
            pos = torch.arange(lo, lo + w.numel(), device=w.device, dtype=torch.int64)
            a += int((w * (pos * 2654435761 + 97)).sum())
            b += int((w * (pos % 65521 + 1)).sum())
        out[name] = (str(t.dtype), tuple(t.shape), a, b)
    return out


# -- 9b. the mesh -------------------------------------------------------------

#: [mesh]: the MoE model whose shard_map dispatch runs on a one-rank mesh,
#: its capacity factors (the reference's own equivalence tests use 8.0,
#: where the per-shard queues over the 64 padded experts and the scatter
#: path's over the 60 real ones drop nothing: logits bit-equal and no
#: routing choice flipped; at the config's 1.25 they hold 40 and 43
#: slots, so the two drop different tokens by design, and only each
#: pass's first MoE layer, which sees the same inputs, must route alike);
#: the blockwise attention model, its prompt and its f32 check.
MESH_MOE_ARCH = "qwen2_moe_a2_7b"
MESH_MOE_CF = 8.0
MESH_ATTN_ARCH = "qwen3_8b"
MESH_ATTN_SEQ = 4096
MESH_ATTN_NEW = 8
MESH_F32_LAYERS, MESH_F32_SEQ = 2, 2048
#: blockwise against dense in f32: max abs error within this share of the
#: dense values' max |x| (forward logits, and each gradient leaf).
MESH_F32_TOL = 1e-5
#: blockwise against dense in bf16: the dense path rounds its scores to
#: bf16 before the softmax, the blockwise one keeps them f32, so served
#: logits move by that rounding: max abs difference within this share of
#: the dense logits' max |x|.
MESH_BF16_BAND = 0.05
#: a CPU rehearsal sets this to run the smoke configs.
MESH_SMOKE = False


def on_mesh(tree, axes, mesh):
    """Every tensor of ``tree`` as a DTensor on ``mesh`` laid out as its
    logical ``axes`` say (on a one-rank mesh: the tensors themselves)."""
    from repro_torch.models.sharding import NamedSharding, logical_to_spec
    from repro_torch.train.step import lay_out

    from repro_torch.models.model import tree_map

    return tree_map(lambda x, ax: lay_out(x, NamedSharding(mesh, logical_to_spec(
        ax, x.shape, mesh))), tree, axes)


def mesh_train(seed: int, reference: dict) -> dict:
    """[train]'s run with the Trainer on a one-rank mesh: DTensor state,
    saved through D-Rex SC at step 4, node 3's chunks lost, restored,
    resharded onto a freshly built mesh, resumed; held to the
    uninterrupted mesh run and to [train]'s mesh-less run."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.configs import get_config
    from repro_torch.core import shapes
    from repro_torch.data import DataConfig
    from repro_torch.kernels import ops, pb_frontier, rs_bitmatmul
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.storage import make_node_set
    from repro_torch.train import (Trainer, TrainerConfig, TrainStateCheckpointer,
                                   init_train_state, reshard_state, train_state_dict)
    from repro_torch.train.interop import _named

    cfg = get_config(TRAIN_ARCH, smoke=MESH_SMOKE)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP)
    fabric = StorageFabric(make_node_set("most_used"))
    ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(), device=DEV)
    like = init_train_state(cfg, prng.PRNGKey(0), device="meta")
    recorder = SnapshotCheckpointer(TrainStateCheckpointer(ck, like))

    def trainer(step_ms: list, mesh):
        t = Trainer(cfg, opt_cfg,
                    TrainerConfig(steps=TRAIN_STEPS, log_every=1, ckpt_every=TRAIN_CKPT_EVERY,
                                  seed=seed, async_ckpt=True),
                    data_cfg=DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed),
                    mesh=mesh, checkpointer=recorder, log_fn=lambda s, m: None,
                    device=entry_device())
        timed_steps(t, step_ms)
        return t

    def all_dtensors(state, mesh) -> int:
        named = _named(state)
        bad = [n for n, t in named if not (isinstance(t, DTensor) and t.device_mesh == mesh)]
        if bad:
            raise AssertionError(f"[mesh] leaves not on the mesh: {bad[:4]}")
        return len(named)

    mesh = make_local_mesh(1, 1, device=entry_device())
    shapes.reset()
    ops.reset_launch_stats()
    rs_bitmatmul.reset_launches()
    pb_frontier.reset_launches()
    step_ms: list = []
    straight = trainer(step_ms, mesh)
    final = straight.run()
    n_leaves = all_dtensors(final, mesh)
    state_bytes = sum(t.numel() * t.element_size() for t in train_state_dict(final).values())
    history = list(straight.history)
    strip = lambda h: {k: h[k] for k in ("step", "loss", "nll", "grad_norm", "lr")}
    if [strip(h) for h in history] != [strip(h) for h in reference["history"]]:
        raise AssertionError(f"[mesh] losses differ from the mesh-less run: "
                             f"{[strip(h) for h in history]} against "
                             f"{[strip(h) for h in reference['history']]}")
    if state_digest(train_state_dict(final)) != reference["digest"]:
        raise AssertionError("[mesh] final state differs from the mesh-less run's")
    at_save = recorder.snapshot
    after_save = ops.launch_stats()
    manifest = ck._manifests[TRAIN_CKPT_EVERY]
    groups = [g for m in manifest["leaves"] for g in m["groups"]]
    victim = groups[0]["node_ids"][0]
    fabric.fail_node(victim)
    resumed_ms: list = []
    resumed = trainer(resumed_ms, make_local_mesh(1, 1, device=entry_device()))
    state, restore_ms = host_ms(resumed.init_or_restore)
    if resumed.start_step != TRAIN_CKPT_EVERY or resumed.data.step != 0:
        raise AssertionError(f"restored step {resumed.start_step} with the data at batch "
                             f"{resumed.data.step}, saved {TRAIN_CKPT_EVERY}")
    # As the reference's, the restored pipeline starts at batch 0; the
    # uninterrupted run's steps 5-6 trained on batches 4-5.
    resumed.data.step = resumed.start_step
    restored = train_state_dict(state)
    if list(restored) != list(at_save):
        raise AssertionError("the restored TrainState's leaves differ from the saved one's")
    for name, t in restored.items():
        if not (t.dtype == at_save[name].dtype and torch.equal(t, at_save[name].to(t.device))):
            raise AssertionError(f"[mesh] restore after node {victim} failed differs at {name}")
    del at_save, restored
    recorder.snapshot = {}
    fresh = make_local_mesh(1, 1, device=entry_device())
    state, reshard_ms = host_ms(lambda: reshard_state(state, cfg, fresh))
    all_dtensors(state, fresh)
    after_restore = ops.launch_stats()
    state = resumed.run(state)
    for a, b in zip(history[TRAIN_CKPT_EVERY:], resumed.history):
        if strip(a) != strip(b):
            raise AssertionError(f"[mesh] resumed step {b['step']} differs: {b} against {a}")
    want = train_state_dict(final)
    for name, t in train_state_dict(state).items():
        if not torch.equal(t, want[name]):
            raise AssertionError(f"[mesh] the resumed run's final state differs at {name}")
    del want, final, state
    launches = rs_bitmatmul.launches
    per_kind = ops.launch_stats()
    out = {
        "leaves_on_mesh": n_leaves, "mesh": {"shape": list(mesh.shape),
                                             "axes": list(mesh.mesh_dim_names)},
        "step_ms": step_ms, "step_ms_p50": statistics.median(step_ms),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (statistics.median(step_ms) / 1e3),
        "resumed_step_ms": resumed_ms,
        "history": [strip(h) for h in history],
        "bit_equal_to_meshless": {"losses": True, "final_state_digest": True},
        "save": {k: recorder.times[k] for k in ("stall_s", "save_s")},
        "failed_node": victim, "restore_s": restore_ms / 1e3, "reshard_s": reshard_ms / 1e3,
        "restored_bit_equal_to_step": TRAIN_CKPT_EVERY,
        "resumed_bit_equal": {"losses": True, "final_state": True},
        "launches": {"rs_bitmatmul": launches, "save_encode": after_save["encode"],
                     "restore_decode": after_restore["decode"] - after_save["decode"],
                     "pb_frontier": pb_frontier.launches},
    }
    out["save"]["save_GBps"] = state_bytes / 1e9 / recorder.times["save_s"]
    out["restore_GBps"] = state_bytes / 1e9 / (restore_ms / 1e3)
    out["_issued"] = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    out["_frontier_shapes"] = sorted(shapes.issued_shapes("pb_frontier"))
    ck.close()
    if DEV == "cuda" and (launches != per_kind["encode"] + per_kind["decode"]
                          or per_kind["decode"] == 0 or per_kind["encode"] == 0
                          or pb_frontier.launches == 0):
        raise AssertionError(f"[mesh] a kernel was skipped: {per_kind}, "
                             f"{pb_frontier.launches} pb_frontier launches")
    return out


def mesh_moe(seed: int) -> dict:
    """The shard_map MoE dispatch at full width on a one-rank mesh, its
    params DTensors: forward and prefill logits bit-equal to the
    mesh-less scatter path at MESH_MOE_CF, the routing choices equal;
    at the config's own capacity factor, how the two differ."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import forward, init_params, layers, prefill
    from repro_torch.models.model import param_axes
    from repro_torch.models.sharding import activate_mesh

    base = get_config(MESH_MOE_ARCH, smoke=MESH_SMOKE)
    if base.moe_dispatch != "shard_map":
        raise AssertionError(f"{base.name} does not dispatch through shard_map")
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = init_params(base, prng.PRNGKey(seed), device=DEV)
    ids, _ = family_inputs(base, LM_BATCH, LM_PROMPT, seed)
    mesh = make_local_mesh(1, 1, device=entry_device())
    dparams = on_mesh(params, param_axes(base), mesh)
    routes: list = []
    real_probs = layers.router_probs

    def spy(router, xt, cfg):
        probs, w, top = real_probs(router, xt, cfg)
        plain = top.to_local() if hasattr(top, "to_local") else top
        routes[-1].append(plain.clone())
        return probs, w, top

    def run(cfg, on):
        routes.append([])
        layers.router_probs = spy
        try:
            if on:
                with activate_mesh(mesh):
                    logits = forward(dparams, ids, cfg, device=entry_device())[0]
                    last = prefill(dparams, ids, cfg, device=entry_device())[0]
                logits, last = logits.to_local(), last.to_local()
            else:
                logits = forward(params, ids, cfg, device=entry_device())[0]
                last = prefill(params, ids, cfg, device=entry_device())[0]
        finally:
            layers.router_probs = real_probs
        sync()
        return logits, last, routes[-1]

    out = {"model": base.name, "experts": base.moe.n_experts,
           "experts_padded": base.moe.n_experts_padded, "tokens": int(ids.size)}
    first = (0, base.n_layers)     # each pass's first MoE layer: the same inputs
    for cf in (MESH_MOE_CF, base.moe.capacity_factor):
        cfg = base.with_(moe=dataclasses.replace(base.moe, capacity_factor=cf))
        sm_ms, sc_ms = [], []
        for _ in range(2):     # the first call warms DTensor's sharding caches
            (sm, sm_last, sm_routes), ms = host_ms(lambda: run(cfg, True))
            sm_ms.append(ms)
            (sc, sc_last, sc_routes), ms = host_ms(
                lambda: run(cfg.with_(moe_dispatch="scatter"), False))
            sc_ms.append(ms)
        flips = [int((a != b).sum()) for a, b in zip(sm_routes, sc_routes)]
        equal = torch.equal(sm, sc) and torch.equal(sm_last, sc_last)
        out[f"cf_{cf}"] = {
            "capacity_shard_map": math.ceil(ids.size * base.moe.experts_per_token
                                            / base.moe.n_experts_padded * cf),
            "capacity_scatter": math.ceil(ids.size * base.moe.experts_per_token
                                          / base.moe.n_experts * cf),
            "routing_calls": len(sm_routes), "routing_flips": sum(flips),
            "routing_flips_first_layer": sum(flips[i] for i in first),
            "logits_bit_equal": equal, "max_abs_diff": max_err(sm, sc),
            "forward_and_prefill_ms": {"shard_map_on_mesh": sm_ms, "scatter": sc_ms}}
        if len(sm_routes) != len(sc_routes) or any(flips[i] for i in first):
            raise AssertionError(f"[mesh] routing differs at capacity factor {cf}: {out}")
        if cf == MESH_MOE_CF and (sum(flips) or not equal):
            raise AssertionError(f"[mesh] shard_map logits differ from scatter's: {out}")
    out["device_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None
    del params, dparams
    return out


def mesh_blockwise(seed: int) -> dict:
    """Blockwise attention at full width: Qwen3-8B's prefill of one
    MESH_ATTN_SEQ-token prompt and MESH_ATTN_NEW greedy tokens, blockwise
    against dense (logits within MESH_BF16_BAND of their max, tokens equal
    up to a flip that rounding explains), timed with each path's device
    peak; then in f32 at
    MESH_F32_LAYERS layers the forward and loss_fn's gradients within
    MESH_F32_TOL of max."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    from repro_torch.models.model import tree_leaves
    from repro_torch.serve import ServeConfig, ServingEngine

    base = get_config(MESH_ATTN_ARCH, smoke=MESH_SMOKE)
    seq = min(MESH_ATTN_SEQ, 64) if MESH_SMOKE else MESH_ATTN_SEQ
    if DEV == "cuda":
        torch.cuda.empty_cache()
    params = init_params(base, prng.PRNGKey(seed), device=DEV)
    ids, _ = family_inputs(base, 1, seq, seed)
    out = {"model": base.name, "seq_len": seq,
           "blocks": {"q": base.attn_block_q, "kv": base.attn_block_kv,
                      "nq": seq // min(base.attn_block_q, seq),
                      "nk": seq // min(base.attn_block_kv, seq)}}
    runs = {}
    for impl in ("dense", "blockwise"):
        cfg = base.with_(attn_impl=impl)
        prefill(params, ids, cfg, device=entry_device())      # warm
        sync()
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated() / 1e9 if DEV == "cuda" else 0.0
        times = []
        for _ in range(3):
            (logits, _), ms = host_ms(lambda: prefill(params, ids, cfg, device=entry_device()))
            times.append(ms)
        peak = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None
        eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=MESH_ATTN_NEW),
                            device=entry_device())
        toks, step_logits = eng.generate(ids, return_logits=True)
        runs[impl] = (logits, toks, step_logits)
        out[impl] = {"prefill_ms": times, "prefill_ms_p50": statistics.median(times),
                     "device_peak_GB": peak,
                     "peak_above_params_GB": None if peak is None else peak - base_mem,
                     "greedy": np.asarray(toks)[0, seq:].tolist()}
    (d_logits, d_toks, d_steps), (b_logits, b_toks, b_steps) = (runs["dense"],
                                                                runs["blockwise"])
    scale = float(d_logits.abs().max())
    diff = max_err(b_logits, d_logits)
    out["bf16"] = {"max_abs_diff": diff, "of_max": diff / scale, "band": MESH_BF16_BAND,
                   "greedy_equal": bool(np.array_equal(np.asarray(d_toks),
                                                       np.asarray(b_toks)))}
    # The two paths round at different points, so a greedy choice may flip
    # where two logits lie closer than the paths' own difference there:
    # tokens must be equal up to the first step where they are not, and
    # there the dense logits of the two chosen tokens must lie within
    # twice the two paths' max difference on that step's logits (no
    # logit moved further), which must itself lie within the band.
    new_d, new_b = np.asarray(d_toks)[0, seq:], np.asarray(b_toks)[0, seq:]
    flip = next((i for i in range(len(new_d)) if new_d[i] != new_b[i]), None)
    ok = diff <= MESH_BF16_BAND * scale
    if flip is not None:
        row_d, row_b = d_steps[0, flip].float(), b_steps[0, flip].float()
        step_diff = max_err(row_b, row_d)
        gap = float(row_d[int(new_d[flip])] - row_d[int(new_b[flip])])
        out["bf16"]["first_flip"] = {"step": flip, "dense_gap": gap,
                                     "step_max_abs_diff": step_diff}
        ok = ok and gap <= 2 * step_diff and step_diff <= MESH_BF16_BAND * scale
    # Every step, after a flip too: the blockwise path fed the dense
    # path's tokens gives each step's logits within the band of the dense
    # engine's.
    forced, _, _ = teacher_forced(params, base.with_(attn_impl="blockwise"),
                                  np.asarray(d_toks), seq, entry_device())
    forced_diff = max_err(forced, d_steps)
    out["bf16"]["teacher_forced"] = {"steps": int(forced.shape[1]),
                                     "max_abs_diff": forced_diff,
                                     "of_max": forced_diff / scale}
    ok = ok and forced.shape == d_steps.shape and forced_diff <= MESH_BF16_BAND * scale
    del forced
    if not ok:
        raise AssertionError(f"[mesh] blockwise prefill against dense: {out}")
    del params, runs, d_logits, b_logits, d_steps, b_steps
    if DEV == "cuda":
        torch.cuda.empty_cache()

    cfg = base.with_(dtype="float32", n_layers=MESH_F32_LAYERS)
    seq = min(MESH_F32_SEQ, 64) if MESH_SMOKE else MESH_F32_SEQ
    params = init_params(cfg, prng.PRNGKey(seed), device=DEV)
    ids, _ = family_inputs(cfg, 1, seq, seed + 1)
    batch = {"tokens": ids, "labels": np.roll(ids, -1, axis=1)}
    f32 = {}
    for impl in ("dense", "blockwise"):
        c = cfg.with_(attn_impl=impl)
        from repro_torch.models import forward
        with torch.no_grad():
            logits = forward(params, ids, c, device=entry_device())[0]
        loss, grads = value_and_grads(params, batch, c, entry_device())
        f32[impl] = (logits, loss, grads)
    (dl, dloss, dg), (bl, bloss, bg) = f32["dense"], f32["blockwise"]
    worst = max(max_err(b, d) / max(float(d.abs().max()), 1e-30) for b, d in zip(bg, dg))
    out["f32"] = {"layers": MESH_F32_LAYERS, "seq_len": seq,
                  "logits_of_max": max_err(bl, dl) / float(dl.abs().max()),
                  "loss_abs_diff": abs(float(bloss) - float(dloss)),
                  "grad_worst_of_max": worst, "tol": MESH_F32_TOL,
                  "leaves": len(tree_leaves(params))}
    if out["f32"]["logits_of_max"] > MESH_F32_TOL or worst > MESH_F32_TOL \
            or out["f32"]["loss_abs_diff"] > MESH_F32_TOL * abs(float(dloss)):
        raise AssertionError(f"[mesh] f32 blockwise against dense: {out['f32']}")
    del params, f32
    return out


def phase_mesh(seed: int, train_run: dict) -> dict:
    """[mesh]: sharded training and elastic restart on a one-rank mesh
    (RWKV6-1.6B), the shard_map MoE dispatch (Qwen1.5-MoE-A2.7B) and
    blockwise attention (Qwen3-8B), all at full width."""
    if not torch.are_deterministic_algorithms_enabled():
        raise AssertionError("[mesh] trains under torch.use_deterministic_algorithms(True)")
    t_phase = time.perf_counter()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    train = mesh_train(seed, train_run)
    marks = [("train", time.perf_counter())]
    train["device_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None
    issued, fshapes = train.pop("_issued"), train.pop("_frontier_shapes")
    log("[mesh] train " + json.dumps(train))
    torch.use_deterministic_algorithms(False)
    try:
        moe = mesh_moe(seed)
        marks.append(("moe", time.perf_counter()))
        log("[mesh] moe " + json.dumps(moe))
        attn = mesh_blockwise(seed)
        marks.append(("blockwise", time.perf_counter()))
        log("[mesh] blockwise " + json.dumps(attn))
    finally:
        torch.use_deterministic_algorithms(True)
    report = {"train": train, "moe": moe, "blockwise": attn,
              "phase_parts_s": {name: t - prev for (_, prev), (name, t)
                                in zip([("start", t_phase)] + marks, marks)},
              "phase_s": time.perf_counter() - t_phase}
    log("[mesh] " + json.dumps({k: report[k] for k in ("phase_parts_s", "phase_s")}))
    return {"report": report, "issued": issued, "frontier_shapes": fshapes,
            "launches": train["launches"]["rs_bitmatmul"],
            "frontier_launches": train["launches"]["pb_frontier"]}


# -- 10. the other model families ---------------------------------------------

#: [families]: the MoE, Griffin and encoder-decoder configs, served at full
#: width in bf16 one at a time (the largest first, so nothing else is on
#: the card beside it); the two whose params go through the checkpoint.
FAMILY_ARCHS = ("qwen3_moe_30b_a3b", "qwen2_moe_a2_7b", "recurrentgemma_9b", "whisper_tiny")
FAMILY_CKPT = ("recurrentgemma_9b", "whisper_tiny")
#: the f32 card-against-CPU check: depth (None = every layer), batch,
#: prompt, decode steps.
FAMILY_CHECK_LAYERS = {"qwen3_moe_30b_a3b": 2, "qwen2_moe_a2_7b": 2, "recurrentgemma_9b": 5,
                       "whisper_tiny": None}
FAMILY_CHECK_BATCH, FAMILY_CHECK_PROMPT, FAMILY_CHECK_STEPS = 2, 16, 8
#: The CPU tests' tolerances (tests/test_torch_models.py, test_torch_loss.py):
#: f32 logits within 1e-4, the loss and the MoE aux within 1e-5 relative,
#: each gradient leaf within 1e-4 of its max |g|.
FAMILY_LOGIT_TOL, FAMILY_LOSS_REL, FAMILY_GRAD_REL = 1e-4, 1e-5, 1e-4
#: a CPU rehearsal sets this to run the smoke configs.
FAMILIES_SMOKE = False

#: Parameter leaves of the four configs in the JAX package's layout
#: (``repro.models.model.init_params(get_config(arch))`` under
#: ``jax.eval_shape``): (name, shape[, dtype]), bf16 unless named.
FAMILY_LAYOUTS = {
    'qwen2_moe_a2_7b': [
        ('embed', (151936, 2048)),
        ('final_norm', (2048,)),
        ('layers.attn.wk', (24, 2048, 16, 128)),
        ('layers.attn.wo', (24, 16, 128, 2048)),
        ('layers.attn.wq', (24, 2048, 16, 128)),
        ('layers.attn.wv', (24, 2048, 16, 128)),
        ('layers.moe.router', (24, 2048, 64), 'float32'),
        ('layers.moe.shared.wg', (24, 2048, 5632)),
        ('layers.moe.shared.wi', (24, 2048, 5632)),
        ('layers.moe.shared.wo', (24, 5632, 2048)),
        ('layers.moe.wg', (24, 64, 2048, 1408)),
        ('layers.moe.wi', (24, 64, 2048, 1408)),
        ('layers.moe.wo', (24, 64, 1408, 2048)),
        ('layers.norm1', (24, 2048)),
        ('layers.norm2', (24, 2048)),
        ('lm_head', (2048, 151936)),
    ],  # 16 leaves, 15,146,256,384 params, 30.30 GB
    'qwen3_moe_30b_a3b': [
        ('embed', (151936, 2048)),
        ('final_norm', (2048,)),
        ('layers.attn.k_norm', (48, 128)),
        ('layers.attn.q_norm', (48, 128)),
        ('layers.attn.wk', (48, 2048, 4, 128)),
        ('layers.attn.wo', (48, 32, 128, 2048)),
        ('layers.attn.wq', (48, 2048, 32, 128)),
        ('layers.attn.wv', (48, 2048, 4, 128)),
        ('layers.moe.router', (48, 2048, 128), 'float32'),
        ('layers.moe.wg', (48, 128, 2048, 768)),
        ('layers.moe.wi', (48, 128, 2048, 768)),
        ('layers.moe.wo', (48, 128, 768, 2048)),
        ('layers.norm1', (48, 2048)),
        ('layers.norm2', (48, 2048)),
        ('lm_head', (2048, 151936)),
    ],  # 15 leaves, 30,532,122,624 params, 61.09 GB
    'recurrentgemma_9b': [
        ('embed', (256000, 4096)),
        ('final_norm', (4096,)),
        ('groups.attn.attn.wk', (12, 4096, 1, 256)),
        ('groups.attn.attn.wo', (12, 16, 256, 4096)),
        ('groups.attn.attn.wq', (12, 4096, 16, 256)),
        ('groups.attn.attn.wv', (12, 4096, 1, 256)),
        ('groups.attn.mlp.wg', (12, 4096, 12288)),
        ('groups.attn.mlp.wi', (12, 4096, 12288)),
        ('groups.attn.mlp.wo', (12, 12288, 4096)),
        ('groups.attn.norm1', (12, 4096)),
        ('groups.attn.norm2', (12, 4096)),
        ('groups.rec.0.mlp.wg', (12, 4096, 12288)),
        ('groups.rec.0.mlp.wi', (12, 4096, 12288)),
        ('groups.rec.0.mlp.wo', (12, 12288, 4096)),
        ('groups.rec.0.norm1', (12, 4096)),
        ('groups.rec.0.norm2', (12, 4096)),
        ('groups.rec.0.rg.a_param', (12, 4096), 'float32'),
        ('groups.rec.0.rg.conv_b', (12, 4096)),
        ('groups.rec.0.rg.conv_w', (12, 4, 4096)),
        ('groups.rec.0.rg.wa', (12, 4096, 4096)),
        ('groups.rec.0.rg.wi', (12, 4096, 4096)),
        ('groups.rec.0.rg.wo', (12, 4096, 4096)),
        ('groups.rec.0.rg.wx', (12, 4096, 4096)),
        ('groups.rec.0.rg.wy', (12, 4096, 4096)),
        ('groups.rec.1.mlp.wg', (12, 4096, 12288)),
        ('groups.rec.1.mlp.wi', (12, 4096, 12288)),
        ('groups.rec.1.mlp.wo', (12, 12288, 4096)),
        ('groups.rec.1.norm1', (12, 4096)),
        ('groups.rec.1.norm2', (12, 4096)),
        ('groups.rec.1.rg.a_param', (12, 4096), 'float32'),
        ('groups.rec.1.rg.conv_b', (12, 4096)),
        ('groups.rec.1.rg.conv_w', (12, 4, 4096)),
        ('groups.rec.1.rg.wa', (12, 4096, 4096)),
        ('groups.rec.1.rg.wi', (12, 4096, 4096)),
        ('groups.rec.1.rg.wo', (12, 4096, 4096)),
        ('groups.rec.1.rg.wx', (12, 4096, 4096)),
        ('groups.rec.1.rg.wy', (12, 4096, 4096)),
        ('lm_head', (4096, 256000)),
        ('tail.mlp.wg', (2, 4096, 12288)),
        ('tail.mlp.wi', (2, 4096, 12288)),
        ('tail.mlp.wo', (2, 12288, 4096)),
        ('tail.norm1', (2, 4096)),
        ('tail.norm2', (2, 4096)),
        ('tail.rg.a_param', (2, 4096), 'float32'),
        ('tail.rg.conv_b', (2, 4096)),
        ('tail.rg.conv_w', (2, 4, 4096)),
        ('tail.rg.wa', (2, 4096, 4096)),
        ('tail.rg.wi', (2, 4096, 4096)),
        ('tail.rg.wo', (2, 4096, 4096)),
        ('tail.rg.wx', (2, 4096, 4096)),
        ('tail.rg.wy', (2, 4096, 4096)),
    ],  # 51 leaves, 10,444,771,328 params, 20.89 GB
    'whisper_tiny': [
        ('embed', (51865, 384)),
        ('enc_layers.attn.wk', (4, 384, 6, 64)),
        ('enc_layers.attn.wo', (4, 6, 64, 384)),
        ('enc_layers.attn.wq', (4, 384, 6, 64)),
        ('enc_layers.attn.wv', (4, 384, 6, 64)),
        ('enc_layers.mlp.wg', (4, 384, 1536)),
        ('enc_layers.mlp.wi', (4, 384, 1536)),
        ('enc_layers.mlp.wo', (4, 1536, 384)),
        ('enc_layers.norm1', (4, 384)),
        ('enc_layers.norm2', (4, 384)),
        ('enc_norm', (384,)),
        ('final_norm', (384,)),
        ('layers.attn.wk', (4, 384, 6, 64)),
        ('layers.attn.wo', (4, 6, 64, 384)),
        ('layers.attn.wq', (4, 384, 6, 64)),
        ('layers.attn.wv', (4, 384, 6, 64)),
        ('layers.mlp.wg', (4, 384, 1536)),
        ('layers.mlp.wi', (4, 384, 1536)),
        ('layers.mlp.wo', (4, 1536, 384)),
        ('layers.norm1', (4, 384)),
        ('layers.norm2', (4, 384)),
        ('layers.norm_x', (4, 384)),
        ('layers.xattn.wk', (4, 384, 6, 64)),
        ('layers.xattn.wo', (4, 6, 64, 384)),
        ('layers.xattn.wq', (4, 384, 6, 64)),
        ('layers.xattn.wv', (4, 384, 6, 64)),
        ('lm_head', (384, 51865)),
    ],  # 27 leaves, 61,074,432 params, 0.12 GB
}


def family_inputs(cfg, b: int, t: int, seed: int) -> tuple:
    """Token ids (B, T) and, for an encoder-decoder, frame embeddings
    (B, n_frames, d_model), from a numpy seed."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    frames = None
    if cfg.is_encdec:
        shape = (b, cfg.encoder.n_frames, cfg.d_model)
        frames = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return ids, frames


def family_serve(arch: str, seed: int) -> dict:
    """One config served on the card at full width in bf16: init from
    ``--seed``, the layout against ``FAMILY_LAYOUTS``, 4 greedy requests
    twice (tokens and logits bit-equal), prefill and decode timings, a
    profiled decode step, the device peak."""
    from repro_torch.configs import get_config
    from repro_torch.models import flatten_params, init_params, model
    from repro_torch.serve import ServeConfig, ServingEngine
    from repro_torch.serve.engine import prime

    cfg = get_config(arch, smoke=FAMILIES_SMOKE)
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params, init_ms = host_ms(lambda: init_params(cfg, prng.PRNGKey(seed), device=DEV))
    flat = flatten_params(params)
    if not FAMILIES_SMOKE:
        want = [(n, shape, dt[0] if dt else "bfloat16")
                for n, shape, *dt in FAMILY_LAYOUTS[arch]]
        got = [(n, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for n, t in flat.items()]
        if got != want:
            raise AssertionError(f"{arch}: the params differ from the JAX layout: "
                                 f"{[g for g, w in zip(got, want) if g != w][:3]}")
    if any(t.device.type != DEV for t in flat.values()):
        raise AssertionError(f"{arch}: params off the card")
    prompts, frames = family_inputs(cfg, LM_BATCH, LM_PROMPT, seed)

    def serve():
        eng = ServingEngine(cfg, params, ServeConfig(max_new_tokens=LM_NEW),
                            device=entry_device())
        ids, logits = eng.generate(prompts, frames=frames, return_logits=True)
        return eng, ids, logits

    _, ids, logits = serve()
    eng, ids2, logits2 = serve()
    if not (np.array_equal(ids, ids2) and torch.equal(logits, logits2)):
        raise AssertionError(f"{arch}: a second greedy run served other tokens or logits")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: served logits are not finite")
    _, prefill_ms, step_ms = teacher_forced(params, cfg, ids, LM_PROMPT, entry_device(), frames)
    prefill_runs = [host_ms(lambda: model.prefill(params, prompts, cfg, frames=frames,
                                                  device=entry_device()))[1]
                    for _ in range(3)]
    _, state = prime(params, ids[:, :LM_PROMPT], cfg, LM_PROMPT + LM_NEW, entry_device(),
                     frames=frames)
    prof = device_time(lambda: model.decode_step(
        params, ids[:, LM_PROMPT:LM_PROMPT + 1], LM_PROMPT, state, cfg,
        device=entry_device()))
    del state
    if prof["device_ms"] is not None:
        prof["busy_share"] = prof["device_ms"] / statistics.median(step_ms)
    report = {
        "model": cfg.name, "leaves": len(flat),
        "params": sum(t.numel() for t in flat.values()),
        "bytes": sum(t.numel() * t.element_size() for t in flat.values()),
        "dtype": cfg.dtype, "layers": cfg.n_layers, "layout_equal_jax": not FAMILIES_SMOKE,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "new_tokens": LM_NEW,
        "frames": None if frames is None else list(frames.shape), "init_ms": init_ms,
        "prefill_ms": statistics.median(prefill_runs), "prefill_ms_runs": prefill_runs,
        "decode_ms_per_step_p50": statistics.median(step_ms),
        "decode_ms_per_step_max": max(step_ms),
        "decode_tokens_per_s": eng.decode_tokens_per_s,
        "tokens_out": eng.metrics["tokens_out"],
        "decode_step_profile": prof,
        "greedy_twice": {"tokens_equal": True, "logits_bit_equal": True},
        "greedy_tokens_head": ids[0, LM_PROMPT:LM_PROMPT + 8].tolist(),
    }
    if cfg.moe is not None:
        from repro_torch.models.layers import moe_capacity
        report["moe_capacity"] = {"prefill": moe_capacity(cfg, LM_BATCH * LM_PROMPT),
                                  "decode": moe_capacity(cfg, LM_BATCH)}
    if DEV == "cuda":
        report["device_peak_GB"] = torch.cuda.max_memory_allocated() / 1e9
        report["device_resident_before_GB"] = resident
    report["s"] = time.perf_counter() - t0
    log("[families] serve " + json.dumps(report))
    return {"report": report, "cfg": cfg, "params": params, "prompts": prompts,
            "frames": frames, "ids": ids, "logits": logits}


class RouteRecorder:
    """Records every MoE routing decision (``moe_route``'s ids, kept slots
    and probabilities) while installed."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        from repro_torch.models import layers

        self._orig = layers.moe_route

        def record(p, xt, cfg):
            out = self._orig(p, xt, cfg)
            self.calls.append({k: out[k].detach().cpu() for k in ("ids", "keep", "probs")})
            return out

        layers.moe_route = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.moe_route = self._orig


def route_flips(card: list, cpu: list, k: int) -> dict:
    """(token, slot) routing choices that differ between two runs of the
    same calls, with each flipped token's top-k margin on the card."""
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} routing calls on the card, {len(cpu)} on the CPU")
    flips, kept, margins = 0, 0, []
    for a, b in zip(card, cpu):
        diff = a["ids"] != b["ids"]
        flips += int(diff.sum())
        kept += int((a["keep"] != b["keep"]).sum())
        for tok in diff.any(dim=1).nonzero().flatten().tolist():
            top = torch.sort(a["probs"][tok], descending=True).values
            margins.append(float(top[k - 1] - top[k]))
    return {"calls": len(card), "choices": sum(int(a["ids"].numel()) for a in card),
            "flipped": flips, "keep_flipped": kept, "flipped_margins": margins[:8]}


def family_cpu_check(arch: str, seed: int) -> dict:
    """The f32 model (cut to ``FAMILY_CHECK_LAYERS`` layers at full width)
    on the card and on the CPU, same params and inputs: the logits of
    ``forward``, of ``prefill`` and of FAMILY_CHECK_STEPS teacher-forced
    decode steps, ``loss_fn``'s loss, aux and gradients, held to the CPU
    tests' tolerances; for MoE every routing choice must agree."""
    from repro_torch.configs import get_config
    from repro_torch.models import flatten_params, forward, init_params, loss_fn, model

    if DEV == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                          or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on: the router and the f32 checks need full f32 matmuls")
    cfg = get_config(arch, smoke=FAMILIES_SMOKE).with_(dtype="float32")
    depth = FAMILY_CHECK_LAYERS[arch]
    if depth is not None and not FAMILIES_SMOKE:
        cfg = cfg.with_(n_layers=depth)
    b, t, n = FAMILY_CHECK_BATCH, FAMILY_CHECK_PROMPT, FAMILY_CHECK_STEPS
    ids, frames = family_inputs(cfg, b, t + n + 1, seed + 1)
    batch = {"tokens": ids[:, :t], "labels": ids[:, 1:t + 1], "frames": frames}
    card = init_params(cfg, prng.PRNGKey(seed), device=DEV)
    host = model.tree_map(lambda x: x.cpu(), card)
    names = list(flatten_params(card))

    def run(params, device):
        with RouteRecorder() as rec:
            fwd = forward(params, ids[:, :t + n], cfg, frames=frames, device=device)[0]
            tf, _, _ = teacher_forced(params, cfg, ids[:, :t + n + 1], t, device, frames)
            leaves = [p.detach().requires_grad_() for p in model.tree_leaves(params)]
            loss, m = loss_fn(model.tree_unflatten(params, leaves), batch, cfg, device=device)
            grads = torch.autograd.grad(loss, leaves)
        return {"forward": fwd, "decode": tf, "loss": loss.detach(), "aux": m["aux"].detach(),
                "grads": grads, "routes": rec.calls}

    a = run(card, entry_device())
    del card
    c = run(host, "cpu")
    report = {"layers": cfg.n_layers, "batch": b, "prompt_len": t, "steps": n}
    for what in ("forward", "decode"):
        err = abs_errors(a[what], c[what])
        report[what] = {**err, "tol": FAMILY_LOGIT_TOL}
        if not err["max_abs_err"] <= FAMILY_LOGIT_TOL:
            raise AssertionError(f"{arch}: f32 {what} logits, card against CPU: {err}")
    for what in ("loss", "aux"):
        want = float(c[what])
        err = abs(float(a[what]) - want)
        report[what] = {"card": float(a[what]), "cpu": want, "abs_err": err}
        if not err <= FAMILY_LOSS_REL * abs(want):
            raise AssertionError(f"{arch}: f32 {what}, card against CPU: {report[what]}")
    worst = []
    for name, g, h in zip(names, a["grads"], c["grads"]):
        scale = float(h.abs().max())
        of_max = max_err(g, h) / max(scale, 1e-30)
        worst.append((of_max, name))
        if not of_max <= FAMILY_GRAD_REL:
            raise AssertionError(f"{arch}: f32 gradient {name}, card against CPU: {of_max} "
                                 "of its max |g|")
    worst.sort(reverse=True)
    report["grads"] = {"leaves": len(names), "tol_of_max": FAMILY_GRAD_REL,
                       "worst": [{"leaf": n, "of_max": e} for e, n in worst[:3]]}
    if cfg.moe is not None:
        report["routing"] = route_flips(a["routes"], c["routes"], cfg.moe.experts_per_token)
        if report["routing"]["flipped"] or report["routing"]["keep_flipped"]:
            raise AssertionError(f"{arch}: routing choices differ between card and CPU: "
                                 f"{report['routing']}")
    report["host_params_GB"] = sum(x.numel() * 4 for x in model.tree_leaves(host)) / 1e9
    return report


def family_restore(run: dict) -> dict:
    """A served model's params saved through D-Rex SC on the ``most_used``
    node set (policy defaults), the node holding row 0 of the first group
    failed, ``restore_latest``: every leaf bit-equal, and the restored
    params serve the same tokens and bit-equal logits."""
    from repro_torch.checkpoint import CheckpointPolicy, DRexCheckpointer, StorageFabric
    from repro_torch.models import flatten_params
    from repro_torch.storage import make_node_set

    state = flatten_params(run["params"])
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    sync()
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fabric = StorageFabric(make_node_set("most_used"))
    ck = DRexCheckpointer(fabric, "drex_sc", CheckpointPolicy(), device=DEV)
    (manifest, save_ms) = host_ms(lambda: ck.save(state, 1))
    groups = [g for m in manifest["leaves"] for g in m["groups"]]
    victim = groups[0]["node_ids"][0]
    fabric.fail_node(victim)
    (restored, step), restore_ms = host_ms(lambda: ck.restore_latest(state))
    for name, t in state.items():
        if not (restored[name].dtype == t.dtype and torch.equal(restored[name], t)):
            raise AssertionError(f"{run['cfg'].name}: restore after node {victim} failed "
                                 f"differs at {name}")
    stats = dict(ck.stats)
    ck.close()
    served = serve_restored(run, restored)
    del restored
    gb = n_bytes / 1e9
    return {"model": run["cfg"].name, "leaves": len(state), "bytes": n_bytes,
            "list_leaves": sum(".rec." in n for n in state), "groups": len(groups),
            "kp_histogram": dict(collections.Counter(f"({g['k']},{g['p']})" for g in groups)),
            "failed_node": victim, "save_s": save_ms / 1e3, "save_GBps": gb / (save_ms / 1e3),
            "place_s": stats["place_s"], "encode_s": stats["encode_s"],
            "restore_s": restore_ms / 1e3, "restore_GBps": gb / (restore_ms / 1e3),
            "restored_bit_equal": True, "served_after_restore": served,
            "device_peak_GB": torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None,
            "host_peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}


def phase_families(seed: int) -> dict:
    """[families]: the four configs served at full width, the f32 card
    against CPU checks, RecurrentGemma-9B's and whisper-tiny's params
    restored bit-exactly after a node loss and served again.  Every launch
    count is set to 0 just before and read just after."""
    from repro_torch.core import shapes
    from repro_torch.kernels import ops, pb_frontier, rs_bitmatmul

    t_phase = time.perf_counter()
    shapes.reset()
    ops.reset_launch_stats()
    rs_bitmatmul.reset_launches()
    pb_frontier.reset_launches()

    served, kept = {}, {}
    for arch in FAMILY_ARCHS:
        run = family_serve(arch, seed)
        served[arch] = run["report"]
        if arch in FAMILY_CKPT:
            kept[arch] = run
        del run
    marks = [("serve", time.perf_counter())]
    checks = {}
    for arch in FAMILY_ARCHS:
        if DEV == "cuda":
            torch.cuda.empty_cache()
        checks[arch] = family_cpu_check(arch, seed)
        log(f"[families] card against CPU, f32, {arch}: " + json.dumps(checks[arch]))
    marks.append(("card_vs_cpu", time.perf_counter()))
    restores = {}
    for arch in FAMILY_CKPT:
        restores[arch] = family_restore(kept.pop(arch))
        log("[families] restore " + json.dumps(restores[arch]))
    marks.append(("restore", time.perf_counter()))
    launches = rs_bitmatmul.launches
    per_kind = ops.launch_stats()
    frontier_launches = pb_frontier.launches
    issued = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    frontier_shapes = sorted(shapes.issued_shapes("pb_frontier"))
    if DEV == "cuda" and (per_kind["encode"] == 0 or per_kind["decode"] == 0
                          or frontier_launches == 0
                          or launches != per_kind["encode"] + per_kind["decode"]):
        raise AssertionError(f"[families] skipped a kernel: {per_kind}, {launches} "
                             f"rs_bitmatmul and {frontier_launches} pb_frontier launches")
    report = {
        "served": {a: {f: r[f] for f in ("prefill_ms", "decode_ms_per_step_p50",
                                         "decode_tokens_per_s", "device_peak_GB",
                                         "decode_step_profile") if f in r}
                   for a, r in served.items()},
        "launches": {"rs_bitmatmul": launches, "encode": per_kind["encode"],
                     "decode": per_kind["decode"], "pb_frontier": frontier_launches},
        "pb_frontier_shapes": [list(x) for x in frontier_shapes],
        "host_peak_rss_GB": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }
    report["phase_parts_s"] = {name: t - prev for (_, prev), (name, t)
                               in zip([("start", t_phase)] + marks, marks)}
    report["phase_s"] = time.perf_counter() - t_phase
    log("[families] " + json.dumps(report))
    return {"report": report, "served": served, "checks": checks, "restores": restores,
            "issued": issued, "launches": launches, "frontier_launches": frontier_launches,
            "frontier_shapes": frontier_shapes}


# -- 11. the examples ---------------------------------------------------------

#: [examples]: the placement explorer's default table and batched rows as
#: examples/placement_explorer.py prints them (most_used, meva,
#: random_nines, fill 0.95): stored share, throughput, top (K, P) choices;
#: placed of 200 and the top reject reason.
EXPLORER_TABLE = {
    "drex_sc": ("69.2%", "94.74", "(4, 1)x137, (3, 3)x82, (3, 2)x70"),
    "drex_lb": ("64.5%", "92.12", "(2, 1)x116, (2, 2)x95, (2, 3)x80"),
    "greedy_min_storage": ("76.7%", "78.93", "(9, 1)x187, (7, 3)x97, (6, 4)x96"),
    "greedy_least_used": ("54.4%", "100.57", "(2, 1)x246, (2, 3)x166, (2, 2)x151"),
    "ec(3,2)": ("60.1%", "104.29", "(3, 2)x647"),
    "ec(4,2)": ("53.5%", "100.26", "(4, 2)x564"),
    "ec(6,3)": ("60.1%", "77.14", "(6, 3)x632"),
    "daos": ("43.5%", "95.62", "(1, 3)x173, (4, 2)x75, (8, 1)x75"),
}
EXPLORER_PLACED = {"drex_sc": 200, "drex_lb": 200, "greedy_min_storage": 200,
                   "greedy_least_used": 200, "ec(3,2)": 139, "ec(4,2)": 128,
                   "ec(6,3)": 163, "daos": 200}
#: examples/elastic_failover.py: min group reliability after nodes 0 and 2
#: fail, chunks rebuilt, repair plans, infeasible plans, min reliability
#: after the repair; the step restored and the step trained to.
FAILOVER = {"min_reliability": "0.991160", "repaired_chunks": 57, "repairs_planned": 57,
            "repairs_failed": 0, "min_reliability_after_repair": "0.999905",
            "restored_step": 30, "final_step": 45}
#: the quickstart's size on the card (its --full model, its default steps);
#: a CPU rehearsal sets EXAMPLES_SMOKE for the reduced model, 10 steps and
#: the explorer at fill 0.1 (where the reference values are not checked).
EXAMPLES_QUICKSTART_STEPS = 200
EXAMPLES_SMOKE = False


def load_example(name: str):
    """The module ``examples_torch/<name>.py``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quiet(fn, *a, **kw) -> tuple:
    """``(fn(*a, **kw), its stdout)``."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*a, **kw)
    return result, out.getvalue()


def explorer_rows(result: dict) -> dict:
    """The explorer's table and batched rows without the wall-time columns."""
    return {"table": [(r["algorithm"], f"{r['stored_fraction']:.1%}",
                       f"{r['throughput_mbps']:.2f}", r["top"]) for r in result["table"]],
            "batched": [(r["algorithm"], r["caps"], r["placed"], r["n"], r["top_reject"],
                         r["placements"]) for r in result["batched"]],
            "n_items": result["n_items"]}


def examples_explorer() -> dict:
    """placement_explorer with its defaults on the card: equal, wall time
    aside, to its run on the CPU and to the reference's values."""
    from repro_torch.kernels import pb_frontier

    ex = load_example("placement_explorer")
    fill = 0.1 if EXAMPLES_SMOKE else 0.95
    before = pb_frontier.launches
    t0 = time.perf_counter()
    card, printed = quiet(ex.explore, fill=fill, device=entry_device())
    card_s = time.perf_counter() - t0
    launches = pb_frontier.launches - before
    for line in printed.splitlines():
        log("[examples] explorer | " + line)
    got = explorer_rows(card)
    if not EXAMPLES_SMOKE:
        table = {name: (stored, thr, ", ".join(f"{tuple(kp)}x{c}" for kp, c in top))
                 for name, stored, thr, top in got["table"]}
        if table != EXPLORER_TABLE:
            raise AssertionError(f"[examples] explorer table {table} differs from the "
                                 f"reference's {EXPLORER_TABLE}")
        placed = {row[0]: row[2] for row in got["batched"]}
        if placed != EXPLORER_PLACED or got["n_items"] != 1055:
            raise AssertionError(f"[examples] explorer placed {placed} of "
                                 f"{got['n_items']} items, the reference {EXPLORER_PLACED}")
    return {"fill": fill, "n_items": got["n_items"], "card": card, "card_s": card_s,
            "pb_frontier_launches": launches,
            "equal_reference_values": not EXAMPLES_SMOKE}


def explorer_cpu_check(run: dict) -> dict:
    """The explorer again with ``--device cpu``: the same table, batched
    rows and placements."""
    ex = load_example("placement_explorer")
    t0 = time.perf_counter()
    cpu, _ = quiet(ex.explore, fill=run["fill"], device="cpu")
    cpu_s = time.perf_counter() - t0
    card = run.pop("card")
    if explorer_rows(card) != explorer_rows(cpu):
        raise AssertionError("[examples] the explorer on the card differs from the CPU's")
    return {"equal_cpu": True, "cpu_s": cpu_s,
            "ms_per_item_card": {r["algorithm"]: r["ms_per_item"] for r in card["batched"]},
            "ms_per_item_cpu": {r["algorithm"]: r["ms_per_item"] for r in cpu["batched"]}}


def examples_serve() -> dict:
    """serve_batch with its defaults, twice: the same tokens."""
    ex = load_example("serve_batch")
    argv = [] if DEV == "cuda" else ["--device", DEV]
    first, printed = quiet(ex.main, argv)
    second, _ = quiet(ex.main, argv)
    for line in printed.splitlines():
        log("[examples] serve | " + line)
    if not np.array_equal(first["tokens"], second["tokens"]):
        raise AssertionError("[examples] serve_batch gave other tokens the second time")
    return {"arch": first["arch"], "tokens_shape": list(first["tokens"].shape),
            "tokens_equal_twice": True, "new": first["new"], "wall_s": first["wall_s"],
            "decode_tokens_per_s": [first["decode_tokens_per_s"],
                                    second["decode_tokens_per_s"]]}


def examples_quickstart() -> dict:
    """quickstart --full with its default steps on the card: every logged
    metric finite, the drill bit-exact, every save's (K, P, nodes) equal
    to the CPU oracle's on a copy of the cluster as it stood, the
    overhead equal to what the oracle's placements give for the same
    leaf sizes; step ms, tokens/s, save and restore GB/s, device peak."""
    from repro_torch.core import DataItem, PlacementEngine, shapes
    from repro_torch.ec import ECCodec
    from repro_torch.kernels import ops

    ex = load_example("quickstart")
    full, steps = not EXAMPLES_SMOKE, 10 if EXAMPLES_SMOKE else EXAMPLES_QUICKSTART_STEPS
    step_ms: list = []
    calls: list = []
    saves: list = []
    save_shapes: set = set()

    class Trainer(ex.Trainer):
        """Each step timed (``timed_steps``)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            timed_steps(self, step_ms)

    class Checkpointer(ex.TrainStateCheckpointer):
        """Records every save's ``place_many`` with a copy of the cluster
        as it stood, and times each async save: ``stall_s`` (the call,
        which takes the snapshot and returns) and ``save_s`` (until the
        last chunk is on the fabric); once each save is done, the
        rs_bitmatmul shapes issued so far (its worker encodes, one save
        is pending at a time, and nothing before the saves in
        [examples] codes bytes)."""

        def __init__(self, checkpointer, like):
            super().__init__(checkpointer, like)
            engine = checkpointer.engine
            place_many = engine.place_many

            def recording(items, **kw):
                view = engine.cluster.copy()
                records = place_many(items, **kw)
                calls.append((view, list(items), records))
                return records

            engine.place_many = recording

        def save_async(self, state, step):
            sync()
            t0 = time.perf_counter()
            fut = super().save_async(state, step)
            rec = {"step": step, "stall_s": time.perf_counter() - t0}
            saves.append(rec)

            def done(f):
                rec.setdefault("save_s", time.perf_counter() - t0)
                save_shapes.update(shapes.issued_shapes(ops.CENSUS_KERNEL))

            return after(fut, done)

    ex.Trainer, ex.TrainStateCheckpointer = Trainer, Checkpointer
    if DEV == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result, printed = quiet(ex.quickstart, full, steps, device=entry_device())
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None
    for line in printed.splitlines():
        log("[examples] quickstart | " + line)
    for h in result["history"]:
        if not all(np.isfinite(h[k]) for k in ("loss", "nll", "grad_norm", "lr")):
            raise AssertionError(f"[examples] quickstart step {h['step']}: not finite: {h}")
    if not result["bit_exact"]:
        raise AssertionError("[examples] quickstart's drill did not restore bit-exactly")

    # Every save's placements against the CPU oracle on the cluster as it
    # stood, and the bytes those placements store.
    t1 = time.perf_counter()
    oracle_stored, kp = 0, collections.Counter()
    for view, items, records in calls:
        want = PlacementEngine(view, oracle_scheduler("drex_sc"), auto_commit=False).place_many(
            [DataItem(it.item_id, it.size_mb, it.arrival_time, it.delta_t_days,
                      it.reliability_target) for it in items])
        got = [(r.placement.k, r.placement.p, tuple(r.placement.node_ids)) for r in records]
        if got != [(r.placement.k, r.placement.p, tuple(r.placement.node_ids)) for r in want]:
            raise AssertionError("[examples] a quickstart save's placements differ from the "
                                 "CPU oracle's")
        for it, r in zip(items, want):
            bucket = round(it.size_mb * 1e6)
            oracle_stored += (r.placement.k + r.placement.p) * ECCodec(
                r.placement.k, r.placement.p, device="cpu").chunk_len(bucket)
        kp.update(f"({k},{p})" for k, p, _ in got)
    oracle_overhead = oracle_stored / result["stats"]["bytes_raw"]
    if f"{oracle_overhead:.6f}" != f"{result['overhead']:.6f}":
        raise AssertionError(f"[examples] quickstart overhead {result['overhead']} against "
                             f"the CPU oracle's placements' {oracle_overhead}")
    gb = result["state_bytes"] / 1e9
    p50 = statistics.median(step_ms)
    return {
        "model": result["model"], "params": result["params"], "steps": steps,
        "state_bytes": result["state_bytes"], "ckpt_every": result["ckpt_every"],
        "history": [{k: h[k] for k in ("step", "loss", "nll", "grad_norm", "lr")}
                    for h in result["history"]],
        "step_ms_p50": p50, "tokens_per_s": result["tokens_per_step"] / (p50 / 1e3),
        "step_ms_max": max(step_ms),
        "saves": [{**s, "GBps": gb / s["save_s"]} for s in saves],
        "save_GBps_p50": statistics.median(gb / s["save_s"] for s in saves),
        "groups_per_save": [len(items) for _, items, _ in calls],
        "kp_histogram": dict(kp), "min_parity": min(int(k.split(",")[1][:-1]) for k in kp),
        "placements_equal_cpu_oracle": True,
        "restored_step": result["restored_step"], "bit_exact": True,
        "restore_s": result["restore_s"], "restore_GBps": gb / result["restore_s"],
        "overhead": result["overhead"], "overhead_cpu_oracle": oracle_overhead,
        "encode_s": result["stats"]["encode_s"], "place_s": result["stats"]["place_s"],
        "device_peak_GB": peak, "run_s": run_s, "oracle_check_s": time.perf_counter() - t1,
        "_save_shapes": sorted(save_shapes),
    }


def examples_failover() -> dict:
    """elastic_failover on the card: the reference's repair numbers, the
    restore at step 30 with the pipeline at batch 0, training to 45."""
    ex = load_example("elastic_failover")
    result, printed = quiet(ex.failover, device=entry_device())
    for line in printed.splitlines():
        log("[examples] failover | " + line)
    got = {k: result[k] for k in FAILOVER}
    for k in ("min_reliability", "min_reliability_after_repair"):
        got[k] = f"{got[k]:.6f}"
    if got != FAILOVER or result["data_step_after_restore"] != 0:
        raise AssertionError(f"[examples] elastic_failover gave {got}, data step "
                             f"{result['data_step_after_restore']}; the reference {FAILOVER}")
    for h in result["history"] + result["resumed_history"]:
        if not all(np.isfinite(h[k]) for k in ("loss", "nll", "grad_norm", "lr")):
            raise AssertionError(f"[examples] failover step {h['step']}: not finite: {h}")
    return {**got, "data_step_after_restore": 0,
            "losses": [h["loss"] for h in result["history"] + result["resumed_history"]]}


def phase_examples() -> dict:
    """[examples]: the four examples of ``examples_torch/`` on the card,
    one at a time, through their own entry points.  Every launch count is
    set to 0 just before and read just after; the CPU run the explorer is
    held to comes after."""
    from repro_torch.core import shapes
    from repro_torch.kernels import ops, pb_frontier, rs_bitmatmul

    t_phase = time.perf_counter()
    shapes.reset()
    ops.reset_launch_stats()
    rs_bitmatmul.reset_launches()
    pb_frontier.reset_launches()
    explorer = examples_explorer()
    marks = [("explorer", time.perf_counter())]
    serve = examples_serve()
    marks.append(("serve", time.perf_counter()))
    quick = examples_quickstart()
    save_shapes = quick.pop("_save_shapes")
    marks.append(("quickstart", time.perf_counter()))
    failover = examples_failover()
    marks.append(("failover", time.perf_counter()))
    launches = rs_bitmatmul.launches
    per_kind = ops.launch_stats()
    frontier_launches = pb_frontier.launches
    issued = sorted(shapes.issued_shapes(ops.CENSUS_KERNEL))
    frontier_shapes = sorted(shapes.issued_shapes("pb_frontier"))
    # The explorer's 10 nodes are below D-Rex SC's and GreedyMinStorage's
    # KERNEL_MIN_NODES, and its engines commit each decision before the
    # next is scored (one item a place_batch call): the dispatch rule
    # sends every decision to the oracle there, so its count may be 0.
    if DEV == "cuda" and (per_kind["encode"] == 0 or per_kind["decode"] == 0
                          or frontier_launches == 0
                          or launches != per_kind["encode"] + per_kind["decode"]):
        raise AssertionError(f"[examples] skipped a kernel: {per_kind}, {launches} "
                             f"rs_bitmatmul and {frontier_launches} pb_frontier launches")
    explorer.update(explorer_cpu_check(explorer))
    marks.append(("explorer_cpu", time.perf_counter()))
    report = {
        "explorer": explorer, "serve": serve, "quickstart": quick, "failover": failover,
        "launches": {"rs_bitmatmul": launches, "encode": per_kind["encode"],
                     "decode": per_kind["decode"], "pb_frontier": frontier_launches,
                     "pb_frontier_explorer": explorer["pb_frontier_launches"]},
        "rs_bitmatmul_shapes": [[r8 // 8, k8 // 8, n * bb] for r8, k8, n, bb, _ in issued],
        "pb_frontier_shapes": [list(x) for x in frontier_shapes],
    }
    report["phase_parts_s"] = {name: t - prev for (_, prev), (name, t)
                               in zip([("start", t_phase)] + marks, marks)}
    report["phase_s"] = time.perf_counter() - t_phase
    log("[examples] " + json.dumps(report))
    return {"report": report, "issued": issued, "save_shapes": save_shapes,
            "launches": launches, "frontier_launches": frontier_launches,
            "frontier_shapes": frontier_shapes}


# -- 12. timing ---------------------------------------------------------------


def by_shape(issued_by_path: dict) -> dict:
    """{shape: the paths that launched it} over ``{path: shapes}``."""
    out = collections.defaultdict(list)
    for path, issued in issued_by_path.items():
        for shape in issued:
            out[shape].append(path)
    return dict(sorted(out.items()))


def phase_timing(issued_by_path: dict, seed: int) -> list[dict]:
    """rs_bitmatmul against its plain version at every (R, K, B) the paths
    in ``issued_by_path`` launched: byte-equal, then timed (median of
    CUDA-event runs)."""
    from repro_torch.ec import gf256
    from repro_torch.kernels import ref, rs_bitmatmul

    rng = np.random.default_rng(seed)
    rows = []
    for (r8, k8, blocks, block_bytes, dev), paths in by_shape(issued_by_path).items():
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
        rows.append({"paths": paths, "R": r, "K": k, "B": b, "bytes": moved, "ms": ms,
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


def phase_frontier_timing(shapes_by_path: dict) -> list[dict]:
    """pb_frontier against its plain version at the shapes the paths in
    ``shapes_by_path`` launched (on the most_used node set's fail
    probabilities over 30 days, target 0.999), at the
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
    cases = [("+".join(paths), most_used, 30.0, 0.999, s)
             for s, paths in by_shape(shapes_by_path).items()]
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


def lm_seed_bands(seeds) -> int:
    """``--lm-seeds``: [lm] at each seed, one ``[lm-seeds]`` line each with
    the bands its f32 checks were held to and the errors they measured."""
    phase_build()
    for seed in seeds:
        for arch in LM_ARCHS:
            checks = phase_lm(arch, seed)["report"]["checks"]
            log("[lm-seeds] " + json.dumps({
                "model": arch, "seed": seed,
                "f32_band_rows_vs_batch": checks["f32_band_rows_vs_batch"],
                "decode_vs_forward_f32": checks["decode_vs_forward_f32"],
                "card_vs_cpu_f32": checks["card_vs_cpu_f32"]}))
            torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lm-seeds", type=int, nargs="+", default=None,
                    help="run only [lm] at these seeds and print each one's f32 bands "
                         "and card-against-CPU errors (no other phase, no result line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.lm_seeds is not None:
        return lm_seed_bands(args.lm_seeds)
    t_start = time.perf_counter()
    phase_s, draws = {}, {}
    global DRAWS
    DRAWS = DrawLaunches()

    def timed(label, fn, *a):
        t0 = time.perf_counter()
        DRAWS.reset()
        out = fn(*a)
        draws[label] = DRAWS.check(label)
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
    prng_run = timed("prng", phase_prng, args.seed)
    prng_times = timed("prng_timing", prng_timing, args.seed)
    torch.cuda.empty_cache()
    lm = {arch: timed(f"lm_{arch}", phase_lm, arch, args.seed) for arch in LM_ARCHS}
    lm_reports = {arch: run["report"] for arch, run in lm.items()}
    rwkv = lm.pop("rwkv6_1_6b")
    lm.clear()  # qwen3_8b is not checkpointed: its 16.4 GB leave the card
    torch.cuda.empty_cache()
    main_run = timed("main", phase_main, rwkv)
    del rwkv
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    try:
        train_run = timed("train", phase_train, args.seed)
        torch.cuda.empty_cache()
        mesh_run = timed("mesh", phase_mesh, args.seed, train_run)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    families = timed("families", phase_families, args.seed)
    torch.cuda.empty_cache()
    examples = timed("examples", phase_examples)
    torch.cuda.empty_cache()
    rows = timed("timing", phase_timing,
                 {"main": main_run["issued"], "train": train_run["issued"],
                  "mesh": mesh_run["issued"], "families": families["issued"],
                  "examples": examples["issued"]}, args.seed)
    frows = timed("frontier_timing", phase_frontier_timing,
                  {"main": main_run["frontier_shapes"], "train": train_run["frontier_shapes"],
                   "mesh": mesh_run["frontier_shapes"],
                   "families": families["frontier_shapes"],
                   "examples": examples["frontier_shapes"]})
    # The headline shape is the main path's save's widest encode wave.
    save = {(r8 // 8, k8 // 8, n * bb) for r8, k8, n, bb, _ in main_run["save_shapes"]}
    head = max((x for x in rows if (x["R"], x["K"], x["B"]) in save and "main" in x["paths"]),
               key=lambda x: x["B"])
    fhead = max((x for x in frows if "main" in x["at"].split("+")),
                key=lambda x: x["B"] * x["S"] * x["L"])
    # The examples' headline: the quickstart's widest save wave (R >= 2).
    qsave = {(r8 // 8, k8 // 8, n * bb) for r8, k8, n, bb, _ in examples["save_shapes"]}
    ehead = max((x for x in rows if (x["R"], x["K"], x["B"]) in qsave
                 and "examples" in x["paths"]), key=lambda x: x["R"] * x["B"])
    # The threefry kernels' launches phase by phase (every one held to the
    # plain version by DRAWS); the timing phase is not a path.
    paths = {k: v for k, v in draws.items() if k != "prng_timing"}

    def path_draws(name):
        return {k: v["launches"][name] for k, v in paths.items() if v["launches"][name]}

    def path_shapes_of(name):
        return [{**x, "path": k} for k, v in paths.items() for x in v["shapes"][name]]

    kernels = [
        {
            "name": "rs_bitmatmul",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rs_bitmatmul.cu",
            "replaces": "src/repro/kernels/rs_bitmatmul.py:56",
            "launches": main_run["launches"],
            "launches_by_path": {
                "checkpoint_main": main_run["launches"],
                # the LM path: its checkpoint is [main]; serving codes no bytes
                "lm_path": main_run["launches"],
                "train": train_run["launches"],
                "mesh": mesh_run["launches"],
                "families": families["launches"],
                "examples": examples["launches"],
            },
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "matches_plain": True,
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": None,
            "shape": {"R": head["R"], "K": head["K"], "B": head["B"]},
            "examples_widest_save": {k: ehead[k] for k in (
                "R", "K", "B", "ms", "plain_ms", "bound_ms", "bound_by")},
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
                "lm_path": main_run["frontier_launches"],
                "train": train_run["frontier_launches"],
                "mesh": mesh_run["frontier_launches"],
                "families": families["frontier_launches"],
                "examples": examples["frontier_launches"],
                "sim_at_scale": sum(sim[f"sim_at_scale/{s}"]["pb_frontier_launches"]
                                    for s in (0, 1)),
                "serve_lane": sum(r["pb_frontier_launches"] for r in serve.values()
                                  if r["run"] == "serve_lane"),
                "serve_at_scale": sum(r["pb_frontier_launches"] for r in serve.values()
                                      if r["run"] == "serve_at_scale"),
            },
            "variants_by_path": {**path_shapes["variants_by_path"], **{
                path: sorted({frontier_variant(B * S, W) for B, S, _, _, W, _ in run_shapes})
                for path, run_shapes in (("train", train_run["frontier_shapes"]),
                                         ("mesh", mesh_run["frontier_shapes"]),
                                         ("families", families["frontier_shapes"]),
                                         ("examples", examples["frontier_shapes"]))}},
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
        {
            "name": "threefry_normal",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/threefry.cu",
            "replaces": "src/repro/models/layers.py:32 (jax.random.normal in dense_init, "
                        "XLA, not Pallas)",
            "launches": prng_run["launches"]["threefry_normal"],
            "launches_by_path": {
                "prng_inits": {a: r["launches"] for a, r in prng_run["inits"].items()},
                **path_draws("threefry_normal")},
            "max_abs_err": prng_run["plain"]["max_abs_err"]["threefry_normal"],
            "matches_plain": True,
            "matches_jax_golden": prng_run["golden"]["normals_bit_equal"],
            **{k: prng_times["normal_window"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "library": "none: torch.randn draws Philox, another function",
            "shape": {k: prng_times["normal_window"][k] for k in (
                "count", "dtype", "small_branch_share")},
            "embed_leaf": prng_times["normal_embed_leaf"],
            "shapes": prng_run["golden"]["normal_shapes"] + [
                x for x in prng_run["plain"]["shapes"] if "count" in x],
            "path_shapes": path_shapes_of("threefry_normal"),
        },
        {
            "name": "gumbel_argmax",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/threefry.cu",
            "replaces": "src/repro/serve/engine.py:51 (jax.random.categorical, XLA, "
                        "not Pallas)",
            "launches": prng_run["launches"]["gumbel_argmax"],
            "launches_by_path": path_draws("gumbel_argmax"),
            "max_abs_err": prng_run["plain"]["max_abs_err"]["gumbel_argmax"],
            "matches_plain": True,
            "matches_jax_golden": prng_run["golden"]["tokens_equal"],
            **{k: prng_times["gumbel"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
            "library": "none: torch.multinomial samples with another generator",
            "argmax_ms": prng_times["gumbel"]["argmax_ms"],
            "argmax": "yardstick, not the same function: torch.argmax of the same logits",
            "shape": {"rows": PRNG_GUMBEL_HEAD[0], "vocab": PRNG_GUMBEL_HEAD[1]},
            "timed": prng_times["gumbel_shapes"],
            "shapes": [x for x in prng_run["plain"]["shapes"] if "rows" in x],
            "path_shapes": path_shapes_of("gumbel_argmax"),
        },
    ]
    lm_fields = ("prefill_ms", "decode_ms_per_step_p50", "decode_tokens_per_s",
                 "device_peak_GB", "wkv_loop", "decode_step_profile")
    train_fields = ("step_ms_p50", "tokens_per_s", "wkv_loop", "save", "restore_GBps",
                    "device_peak_GB", "host_peak_rss_GB")
    log("[summary] " + json.dumps({"cuts": CUTS, "phase_s": phase_s, "prng": {
        "inits": prng_run["inits"], "serve": prng_run["serve"], "timing": prng_times,
        "phase_s": prng_run["phase_s"]}, "lm": {
        arch: {f: r[f] for f in lm_fields if f in r} for arch, r in lm_reports.items()},
        "train": {f: train_run["report"][f] for f in train_fields},
        "mesh": {"train": {f: mesh_run["report"]["train"][f] for f in (
            "step_ms_p50", "tokens_per_s", "save", "restore_GBps", "device_peak_GB")},
                 "moe": mesh_run["report"]["moe"], "blockwise": {
            k: mesh_run["report"]["blockwise"][k] for k in ("dense", "blockwise", "bf16", "f32")},
                 "phase_s": mesh_run["report"]["phase_s"]},
        "families": {**families["report"]["served"], "restore": {
            a: {f: r[f] for f in ("save_GBps", "restore_GBps", "groups")}
            for a, r in families["restores"].items()}},
        "examples": {"quickstart": {f: examples["report"]["quickstart"][f] for f in (
            "step_ms_p50", "tokens_per_s", "save_GBps_p50", "restore_GBps", "device_peak_GB",
            "overhead", "kp_histogram")}, "failover": examples["report"]["failover"],
            "launches": examples["report"]["launches"],
            "phase_parts_s": examples["report"]["phase_parts_s"],
            "phase_s": examples["report"]["phase_s"]},
        "scale": {
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
