"""The port's ``examples_torch/quickstart.py`` held against
``examples/quickstart.py`` on the CPU.

The JAX example runs as its command line does (``runpy``, stdout
captured), the port's through ``main(argv)`` with ``--device cpu``.  At
``--steps 10`` both log the same steps, restore the step-10 checkpoint
bit-exactly after nodes 0 and 3 fail, and print the same storage
overhead (the two trainers start from different random params, so the
losses differ).  ``--steps 8``: ``test_torch_examples_no_checkpoint.py``.
The example starts a one-rank process group (its mesh);
each run here ends it.
"""

from __future__ import annotations

import functools
import re

import torch.distributed as dist

from test_torch_examples import run_port, run_reference


def port_run(*argv: str) -> tuple[dict, str]:
    """The port's example with ``--device cpu``; a process group it
    started is ended."""
    started = not dist.is_initialized()
    try:
        return run_port("quickstart", *argv, "--device", "cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def ten_steps() -> tuple[str, dict, str]:
    want = run_reference("quickstart", "--steps", "10")
    got, printed = port_run("--steps", "10")
    return want, got, printed


def logged_steps(text: str) -> list[int]:
    return [int(m.group(1)) for m in re.finditer(r"^\[train\] step +(\d+) ", text, re.M)]


def test_quickstart_logs_the_reference_steps():
    want, got, printed = ten_steps()
    assert logged_steps(printed) == logged_steps(want) == [1, 10]
    assert [h["step"] for h in got["history"]] == [1, 10]
    assert printed.splitlines()[0] == want.splitlines()[0] == (
        "model: quickstart-8m (6.0M params), devices: 1")


def test_quickstart_drill_restores_bit_exactly():
    want, got, printed = ten_steps()
    line = ("restored checkpoint from step 10 after 2/10 node failures: "
            "bit-exact=True")
    assert line in want.splitlines() and line in printed.splitlines()
    assert got["restored_step"] == 10 and got["bit_exact"] is True
    assert "failure drill: killing storage nodes 0 and 3 ..." in printed.splitlines()


def test_quickstart_overhead_equals_reference():
    want, got, printed = ten_steps()
    line = "checkpoint storage overhead: 1.67x (vs 3.0x for HDFS-style replication)"
    assert want.splitlines()[-1] == printed.splitlines()[-1] == line
    assert f"{got['overhead']:.2f}" == "1.67"
    assert got["stats"]["bytes_stored"] > got["stats"]["bytes_raw"] > 0

