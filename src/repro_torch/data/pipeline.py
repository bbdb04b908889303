"""Deterministic synthetic LM data pipeline.

The port of ``repro.data.pipeline``: (tokens, labels) batches from a
seeded Zipfian token source with a Markov bigram structure, drawn with
the reference's numpy generators (the bigram table from
``default_rng(seed)``, each step's block from ``default_rng((seed,
step))``), so the batches are bit-equal to the JAX package's.  A batch is
two int32 tensors on the pipeline's device (``None`` = CUDA).

Straggler accounting (a per-host EWMA of batch latency; stragglers get
their local batch thinned and the rest rebalanced) is the reference's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["DataConfig", "LMDataPipeline"]


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: EWMA factor for straggler detection
    ewma: float = 0.9
    #: a host is a straggler when its latency exceeds median * threshold
    straggler_threshold: float = 3.0


class LMDataPipeline:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        #: the step whose batch ``next_batch`` returns next.
        self.step = 0
        self._latency_ewma: dict[int, float] = {}
        # Markov bigram table: token t -> preferred successor band.
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size, dtype=np.int32)

    def _tokens_for(self, step: int, batch: int) -> np.ndarray:
        """Deterministic (batch, seq+1) token block for a step."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        # Zipfian unigram draws, then a bigram walk mixes in structure.
        z = rng.zipf(1.3, size=(batch, cfg.seq_len + 1)).astype(np.int64)
        toks = (z % cfg.vocab_size).astype(np.int32)
        follow = rng.random((batch, cfg.seq_len)) < 0.5
        nxt = self._succ[toks[:, :-1]]
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        return toks

    def next_batch(self) -> dict:
        """Global (tokens, labels) batch for the current step."""
        t0 = time.perf_counter()
        cfg = self.cfg
        toks = torch.from_numpy(self._tokens_for(self.step, cfg.global_batch))
        self.step += 1
        batch = {
            "tokens": toks[:, :-1].to(self.device),
            "labels": toks[:, 1:].to(self.device),
        }
        self.record_host_latency(0, time.perf_counter() - t0)
        return batch

    # -- straggler accounting -------------------------------------------------

    def record_host_latency(self, host: int, latency_s: float) -> None:
        prev = self._latency_ewma.get(host, latency_s)
        self._latency_ewma[host] = (
            self.cfg.ewma * prev + (1 - self.cfg.ewma) * latency_s
        )

    def straggler_hosts(self) -> list[int]:
        if len(self._latency_ewma) < 2:
            return []
        vals = sorted(self._latency_ewma.values())
        med = vals[len(vals) // 2]
        return [
            h
            for h, v in self._latency_ewma.items()
            if v > self.cfg.straggler_threshold * max(med, 1e-9)
        ]

    def plan_host_batches(self, hosts: list[int], per_host: int) -> dict[int, int]:
        """Thin straggler hosts' local batches; rebalance onto healthy hosts
        (total preserved when possible)."""
        stragglers = set(self.straggler_hosts())
        plan = {h: per_host for h in hosts}
        deficit = 0
        for h in hosts:
            if h in stragglers:
                cut = per_host // 2
                plan[h] = per_host - cut
                deficit += cut
        healthy = [h for h in hosts if h not in stragglers]
        for i in range(deficit):
            if not healthy:
                break
            plan[healthy[i % len(healthy)]] += 1
        return plan
