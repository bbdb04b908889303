"""Trainer loop: metrics, periodic (async, EC-protected) checkpointing,
restart-on-failure, straggler accounting.

The port of ``repro.train.trainer`` (``device=``, ``None`` = CUDA).  A
fresh state is the reference's: ``init_train_state(cfg,
PRNGKey(TrainerConfig.seed))``, drawn value for value as it draws.  With a
``mesh`` the step runs sharded (``make_train_step(mesh=...)``): the state
is initialized or restored whole and laid out on the mesh by the first
step, and a save gathers each DTensor leaf under its usual name.
Its checkpointer has the reference's protocol (``save``, ``save_async``,
``restore_latest``); :class:`TrainStateCheckpointer` gives it over the
port's state-dict ``DRexCheckpointer``, through ``train_state_dict`` and
``train_state_from_dict``.

As in the reference, a restore at step ``s`` restores the state and the
step but not the data pipeline, which starts again at batch 0.  A caller
that wants the resumed run on the uninterrupted run's batches sets the
pipeline's counter after the restore:
``trainer.data.step = trainer.start_step``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch._device import resolve_device
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.prng import PRNGKey

from .interop import train_state_dict, train_state_from_dict
from .step import TrainState, init_train_state, make_train_step

__all__ = ["Trainer", "TrainerConfig", "TrainStateCheckpointer"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = disabled
    seed: int = 0
    compression: bool = False
    async_ckpt: bool = True


class TrainStateCheckpointer:
    """The Trainer's checkpointer protocol over the port's state-dict
    ``DRexCheckpointer``.  ``like`` gives the state's structure (a
    ``meta``-device state will do); restored leaves are on the
    checkpointer's device."""

    def __init__(self, checkpointer, like: TrainState):
        self.checkpointer = checkpointer
        self.like = like

    def save(self, state: TrainState, step: int) -> dict:
        return self.checkpointer.save(train_state_dict(state), step)

    def save_async(self, state: TrainState, step: int):
        """Returns once the state's snapshot is taken: device copies
        queued on the caller's current stream, so the next in-place step,
        queued behind them, cannot touch what is saved.  Placement,
        encode and puts run on the checkpointer's worker and its own
        CUDA stream, overlapping the next steps."""
        return self.checkpointer.save_async(train_state_dict(state), step)

    def restore_latest(self, _cfg=None) -> Optional[tuple[TrainState, int]]:
        restored = self.checkpointer.restore_latest()
        if restored is None:
            return None
        d, step = restored
        return train_state_from_dict(d, self.like), step


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        tcfg: TrainerConfig,
        data_cfg: Optional[DataConfig] = None,
        mesh=None,
        checkpointer=None,
        log_fn: Callable[[int, dict], None] | None = None,
        device=None,
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.checkpointer = checkpointer
        self.log_fn = log_fn or self._default_log
        self.data = LMDataPipeline(
            data_cfg
            or DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=8,
                          seed=tcfg.seed),
            device=self.device,
        )
        self.step_fn = make_train_step(cfg, opt_cfg, mesh, tcfg.compression)
        self.history: list[dict] = []
        self._pending_ckpt = None

    @staticmethod
    def _default_log(step: int, metrics: dict) -> None:
        ms = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"[train] step {step:5d} {ms}", flush=True)

    def init_or_restore(self) -> TrainState:
        if self.checkpointer is not None:
            restored = self.checkpointer.restore_latest(self.cfg)
            if restored is not None:
                state, step = restored
                self.start_step = step
                print(f"[train] restored checkpoint at step {step}", flush=True)
                return state
        self.start_step = 0
        return init_train_state(self.cfg, PRNGKey(self.tcfg.seed),
                                self.tcfg.compression, device=self.device)

    def run(self, state: Optional[TrainState] = None) -> TrainState:
        if state is None:
            state = self.init_or_restore()
        start = getattr(self, "start_step", 0)
        t_last = time.perf_counter()
        for step in range(start, self.tcfg.steps):
            batch = self.data.next_batch()
            state, metrics = self.step_fn(state, batch)
            if (step + 1) % self.tcfg.log_every == 0 or step == start:
                metrics = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                metrics["steps_per_s"] = self.tcfg.log_every / max(now - t_last, 1e-9)
                t_last = now
                self.history.append({"step": step + 1, **metrics})
                self.log_fn(step + 1, metrics)
            if (
                self.checkpointer is not None
                and self.tcfg.ckpt_every
                and (step + 1) % self.tcfg.ckpt_every == 0
            ):
                self._checkpoint(state, step + 1)
        self._drain_ckpt()
        return state

    # -- checkpoint plumbing --------------------------------------------------

    def _checkpoint(self, state: TrainState, step: int) -> None:
        if self.tcfg.async_ckpt:
            self._drain_ckpt()
            self._pending_ckpt = self.checkpointer.save_async(state, step)
        else:
            self.checkpointer.save(state, step)

    def _drain_ckpt(self) -> None:
        if self._pending_ckpt is not None:
            self._pending_ckpt.result()
            self._pending_ckpt = None
