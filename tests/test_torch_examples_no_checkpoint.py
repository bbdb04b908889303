"""``examples/quickstart.py`` and its port below ten steps, on the CPU:
``ckpt_every = min(50, max(10, steps // 4))``, so 8 steps write no
checkpoint and the drill has nothing to restore.  Both fail there; the
port names the cause.  (A finding in the reference, kept in the port.)
"""

from __future__ import annotations

import pytest
import torch.distributed as dist

from test_torch_examples import port_example, run_reference


def test_reference_quickstart_below_ten_steps_fails_at_the_drill():
    with pytest.raises(TypeError, match="cannot unpack non-iterable NoneType"):
        run_reference("quickstart", "--steps", "8")


def test_port_quickstart_below_ten_steps_fails_at_the_drill():
    """At a smaller batch and length than the CLI's (the checkpoint
    schedule depends on the step count alone)."""
    quickstart = port_example("quickstart").quickstart
    started = not dist.is_initialized()
    try:
        with pytest.raises(RuntimeError, match="no checkpoint to restore: 8 steps never "
                                               "reach ckpt_every=10"):
            quickstart(steps=8, global_batch=2, seq_len=32, device="cpu")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
