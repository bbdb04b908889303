"""Batched token-serving engine of the port: prefill a request batch,
then step the decode loop with greedy or temperature sampling.

The port of ``repro.serve.engine``: the same prefill (with an
encoder-decoder's ``frames``), the same replay of an attention model's
prompt K/V into a cache sized ``t + max_new_tokens`` (an
encoder-decoder's cross-attention K/V carried over as they are; the
sub-quadratic families keep prefill's state), the same decode positions,
eos handling and ``tokens_out`` accounting.  Greedy decoding equals the reference's for
the same logits.  Sampling at ``temperature > 0`` is the reference's:
``categorical(sub, logits / temperature)`` (:mod:`repro_torch.prng`,
the ``gumbel_argmax`` kernel on the card) under the key schedule
``key = PRNGKey(seed)``, then ``key, sub = split(key)`` before every
token, so the same logits give ``jax.random.categorical``'s tokens.

Namespace note: this module serves model *tokens*; the storage
*placement* service lives in :mod:`repro_torch.serve.placement`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch._device import resolve_device
from repro_torch.models import decode_step, init_serve_state, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import check_supported


def prime(params, prompts, cfg: ModelConfig, cache_len: int, device, frames=None) -> tuple:
    """Prefill ``prompts`` (B, T) (and an encoder-decoder's ``frames``)
    and return (last logits, decode state); an attention model's K/V go
    into a cache of ``cache_len`` positions (the reference's replay of the
    prompt into a cache sized for the output)."""
    logits, state = prefill(params, prompts, cfg, frames=frames, device=device)
    if not cfg.sub_quadratic:
        b, t = prompts.shape
        full = init_serve_state(cfg, b, cache_len, device=device)
        for name in ("k", "v"):
            full["layers"][name][:, :, :t] = state["layers"][name]
        if cfg.is_encdec:
            full["cross_kv"] = state["cross_kv"]
        state = full
    return logits, state


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0
    eos_id: Optional[int] = None


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig | None = None,
                 device=None):
        check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg or ServeConfig()
        self.device = resolve_device(device)
        self.metrics = {"prefill_s": 0.0, "decode_s": 0.0, "tokens_out": 0}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits, key):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        # A tensor divisor: CUDA divides by a host scalar as a multiply by
        # its reciprocal, which is not the reference's division.
        t = torch.tensor(self.scfg.temperature, dtype=logits.dtype, device=logits.device)
        return prng.categorical(key, logits / t)[:, None]

    def generate(self, prompts: np.ndarray, frames=None, return_logits: bool = False):
        """prompts: (B, T) int32 -> (B, T + max_new) generated ids; an
        encoder-decoder also takes ``frames`` (B, n_frames, d_model).

        With ``return_logits`` also the f32 logits each new token was
        sampled from, (B, n_new, V) on the engine's device."""
        cfg, scfg, dev = self.cfg, self.scfg, self.device
        b, t = prompts.shape
        key = prng.PRNGKey(scfg.seed)

        t0 = time.perf_counter()
        logits, state = prime(self.params, prompts, cfg, t + scfg.max_new_tokens, dev,
                              frames=frames)
        self._sync()
        self.metrics["prefill_s"] += time.perf_counter() - t0

        out = [torch.as_tensor(prompts, device=dev).long()]
        seen = [logits]
        key, sub = prng.split(key)
        tok = self._sample(logits, sub)
        out.append(tok)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        if scfg.eos_id is not None:
            done = done | (tok[:, 0] == scfg.eos_id)
        n_tok = b  # every row emits the first token (eos itself counts)
        t0 = time.perf_counter()
        for i in range(1, scfg.max_new_tokens):
            if bool(done.all()):
                break
            logits, state = decode_step(self.params, tok, t + i - 1, state, cfg,
                                        device=dev)
            key, sub = prng.split(key)
            tok = self._sample(logits, sub)
            # Rows past their eos emit uncounted padding; a row's own eos
            # token is real output and counts.
            n_tok += int(b - int(done.sum()))
            if scfg.eos_id is not None:
                done = done | (tok[:, 0] == scfg.eos_id)
            out.append(tok)
            seen.append(logits)
        self._sync()
        self.metrics["decode_s"] += time.perf_counter() - t0
        self.metrics["tokens_out"] += n_tok
        ids = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        if return_logits:
            return ids, torch.stack(seen, dim=1)
        return ids

    @property
    def decode_tokens_per_s(self) -> float:
        d = self.metrics["decode_s"]
        return self.metrics["tokens_out"] / d if d > 0 else 0.0
