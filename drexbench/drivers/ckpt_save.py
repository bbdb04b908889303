"""Closed-loop synchronous checkpoint saves.

One client saves the whole state back to back with a rising step, as a
training job does at each checkpoint; ``keep_last`` collects the older
checkpoints.  Before each save, outside its span, the state changes as
training would change it: ``touch_stride_bytes`` apart in every leaf, two
bytes take the step's number, so every group of every save holds bytes
no other save held.  Set-up makes the state and runs ``warmup_saves``
saves, one more than ``keep_last``, so that the collection of old
checkpoints has run before the window; the window runs saves until
``--seconds`` have passed.  The reference then checks every save's
manifest and placements, the occupancy each save was placed against,
and every chunk of the last save, data and parity, read back from the
fabric against the state as it was saved.
"""

from __future__ import annotations

import itertools

import numpy as np

from drexbench.harness import Check, window
from drexbench.reference import ckpt as ref
from . import _ckpt


def run(rec, hooks: dict) -> None:
    conf, mix = rec.cell.config, rec.cell.traffic
    ck, fabric, arr, state = _ckpt.build(rec)
    if "checkpointer" in hooks:
        hooks["checkpointer"](ck)
    nbytes = _ckpt.state_bytes(state)
    touch = _ckpt.toucher(state, int(mix["touch_stride_bytes"]))
    saves = []  # (step, manifest, used_mb before it, place_s, encode_s)

    def one_save(step: int) -> None:
        touch(step)
        used = fabric.cluster.used_mb.copy()
        p0, e0 = ck.stats["place_s"], ck.stats["encode_s"]
        with rec.spans.span("save"):
            manifest = ck.save(state, step)
        saves.append((step, manifest, used, ck.stats["place_s"] - p0, ck.stats["encode_s"] - e0))

    try:
        for step in range(int(mix["warmup_saves"])):
            one_save(step)
        if rec.device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        first = len(saves)
        steps = itertools.count(first)
        n = window(rec, lambda: one_save(next(steps)))
        timed, traced = saves[first : first + n], saves[first + n :]
        rec.attempted = len(timed)
        rec.failed = 0
        rec.facts.update(
            state_bytes=nbytes,
            n_ops=len(timed),
            place_s=[s[3] for s in timed],
            encode_s=[s[4] for s in timed],
            traced_encode_bytes=sum(_yard_bytes(s[1]) for s in traced),
        )
        if "capture" in hooks:
            hooks["capture"](dict(fabric=fabric, arr=arr, state=state, saves=saves))
        _check(rec, fabric, arr, state, saves)
    finally:
        ck.close()


def _yard_bytes(manifest) -> float:
    from drexbench import yardstick

    return yardstick.encode_bytes(_ckpt.groups_of(manifest))


def _check(rec, fabric, arr, state, saves) -> None:
    conf, mix = rec.cell.config, rec.cell.traffic
    policy = conf["policy"]
    group_bytes = int(float(policy["item_mb"]) * 1e6)
    keep = int(policy["keep_last"])
    lim = mix["limits"]
    # 1. every manifest against the state's layout
    layout_bad = sum(_ckpt.manifest_error_bytes(m, conf, state) for _, m, *_ in saves)
    # 2. every group's (K, P, nodes) against the frozen oracle, placed
    #    against the occupancy the program held before that save
    groups = [_ckpt.groups_of(m) for _, m, *_ in saves]
    bad_place, n_place = ref.placement_mismatches(
        arr, policy, [(g, used) for g, (_, _, used, *_) in zip(groups, saves)])
    # 3. that occupancy against the chunks that should be on the fabric:
    #    the base occupancy plus the last ``keep_last`` saves before it
    gap = 0.0
    for j, (_, _, used, *_) in enumerate(saves):
        want = arr.used_mb + ref.occupancy(arr.n, groups[max(0, j - keep):j])
        gap = max(gap, float(np.max(np.abs(used - want))))
    # 4. every chunk of the last save read back, against the numpy
    #    Cauchy-RS of the state as it was saved (nothing changed it
    #    since); a leaf that step 1 found laid out wrong counts whole
    last = saves[-1][1]

    def read(node, g, row):
        blob = fabric.get(node, f"{g['key']}_r{row}")
        return None if blob is None else np.frombuffer(blob, dtype=np.uint8)

    leaves = _ckpt.leaf_bytes(state)
    bad_bytes, n_bytes = ref.chunk_mismatch_bytes(last, leaves, group_bytes, read)
    rec.facts.update(groups_compared=n_place, chunk_bytes_compared=n_bytes)
    rec.checks += [
        Check("placement_mismatches", float(bad_place), float(lim["placement_mismatches"])),
        Check("occupancy_gap_mb", gap, float(lim["occupancy_gap_mb"])),
        Check("chunk_mismatch_bytes", float(bad_bytes + layout_bad),
              float(lim["chunk_mismatch_bytes"])),
    ]
