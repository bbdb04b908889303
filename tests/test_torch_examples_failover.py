"""The port's ``examples_torch/elastic_failover.py`` held against
``examples/elastic_failover.py`` on the CPU.

The JAX example runs as its command line does (``runpy``, stdout
captured), the port's through ``main(argv)`` with ``--device cpu``.  The
checkpoint's health and repair depend only on placements and leaf sizes,
so they print the same numbers: min group reliability 0.991160 after
nodes 0 and 2 fail, 57 chunks rebuilt through 57 repair plans with 0
infeasible, 0.999905 after.  Phase 3 restores step 30 with the data
pipeline at batch 0 in both packages and trains on to step 45.  The
example starts a one-rank process group (its mesh); the run here ends
it.
"""

from __future__ import annotations

import functools
import re

import torch.distributed as dist

from repro.train import Trainer as JTrainer

from test_torch_examples import run_port, run_reference


@functools.lru_cache(maxsize=None)
def failover() -> tuple[str, list, dict, str]:
    """(the reference's stdout, its restarts' (step, data step), the
    port's result, the port's stdout)."""
    restarts = []
    original = JTrainer.init_or_restore

    def recording(self):
        state = original(self)
        restarts.append((self.start_step, self.data.step))
        return state

    JTrainer.init_or_restore = recording
    try:
        want = run_reference("elastic_failover")
    finally:
        JTrainer.init_or_restore = original
    started = not dist.is_initialized()
    try:
        got, printed = run_port("elastic_failover", "--device", "cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return want, restarts, got, printed


def lines_with(text: str, start: str) -> list[str]:
    return [line for line in text.splitlines() if line.lstrip().startswith(start)]


def test_failover_prints_the_reference_health():
    want, _, got, printed = failover()
    line = "  min group reliability: 0.991160 (target 0.9999)"
    assert lines_with(want, "min group") == lines_with(printed, "min group") == [line]
    assert f"{got['min_reliability']:.6f}" == "0.991160"


def test_failover_repair_equals_reference():
    want, _, got, printed = failover()
    line = ("  proactive repair rebuilt 57 chunks (57 repair plans, 0 infeasible); "
            "min reliability now 0.999905")
    assert lines_with(want, "proactive") == lines_with(printed, "proactive") == [line]
    assert (got["repaired_chunks"], got["repairs_planned"], got["repairs_failed"]) == (57, 57, 0)
    assert f"{got['min_reliability_after_repair']:.6f}" == "0.999905"


def test_failover_restarts_at_step_30_with_the_pipeline_at_batch_0():
    want, restarts, got, printed = failover()
    assert restarts == [(0, 0), (30, 0)]
    assert (got["restored_step"], got["data_step_after_restore"]) == (30, 0)
    line = "[train] restored checkpoint at step 30"
    assert line in want.splitlines() and line in printed.splitlines()


def test_failover_trains_on_to_step_45():
    want, _, got, printed = failover()
    steps = lambda text: [int(s) for s in re.findall(r"^\[train\] step +(\d+) ", text, re.M)]
    assert steps(printed) == steps(want) == [1, 10, 20, 30, 31, 35, 40, 45]
    assert [h["step"] for h in got["resumed_history"]] == [31, 35, 40, 45]
    assert got["final_step"] == 45
    assert printed.splitlines()[-1] == want.splitlines()[-1] == (
        "survived node failures + elastic restart; training continued.")


def test_failover_prints_the_reference_phases():
    want, _, _, printed = failover()
    assert lines_with(printed, "phase") == lines_with(want, "phase") == [
        "phase 1: train 30 steps with EC checkpoints every 10",
        "phase 2: storage nodes 0 and 2 fail; checkpoint health:",
        "phase 3: elastic restart on a fresh mesh, resume to step 45"]
