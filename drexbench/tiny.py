"""Cells of ``BENCHMARK.json`` and ``pending.json`` cut to a size a CPU test run can hold.

Only the tests use these: the widths of the leaves, the group size, the
number of drives, of items and of a service window shrink, and each tiny drive holds a
thousandth of its model's capacity, so that every commit reorders the
drives.  Every other setting, the drivers and the reference are the
cell's own.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

from drexbench import catalog

__all__ = ["tiny_cell", "one_thread", "TINY_LEAVES"]

#: a few leaves of RWKV6-like shapes, a few hundred KB in all
TINY_LEAVES = [
    ["embed", [256, 64]],
    ["final_norm", [64]],
    ["layers.cmix.wk", [2, 64, 224]],
    ["layers.tmix.bonus_u", [2, 2, 32]],
    ["lm_head", [64, 256]],
]


def tiny_cell(workload: str) -> catalog.Cell:
    cell = catalog.resolve(workload, catalog.with_pending(catalog.load_benchmark()))
    config, traffic = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    if config["kind"] == "checkpoint":
        config["payload"]["leaves"] = TINY_LEAVES
        config["policy"]["item_mb"] = 0.02
        config["policy"]["encode_wave_groups"] = 4
        traffic["touch_stride_bytes"] = 4096
    else:
        config["cluster"]["n_drives"] = 40
        # drives of a few GB, so that each decision moves the next
        for row in config["cluster"]["models"]:
            row[1] = row[1] / 1000.0
        config["frontier"]["max_batch"] = 8
        traffic["n_items"] = 600
        traffic["oracle_sample"] = 32
    return dataclasses.replace(cell, config=config, traffic=traffic)


@contextlib.contextmanager
def one_thread():
    """Torch's CPU ops on one thread for the block: tiny tensors, and the
    test workers share the machine's cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
