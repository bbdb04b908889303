"""The controls of the comparison that decides ``correct``, and their readings.

A control is the plain reference put in the program's place, computed in
the nearest precision below the configuration's, and judged by the same
comparison as the program:

* checkpoint save: the state's bf16 bytes through fp8 (e4m3) and back,
  then the reference's Cauchy-RS code, in place of the stored chunks; the
  D-Rex SC oracle in float32 in place of the placements; the occupancy
  summed in float32;
* checkpoint restore: the state through fp8 and back, in place of the
  restored state;
* placement: the D-Rex SC oracle in float32 in place of each sampled
  decision, at the same positions of the same run.

Each control follows one sound run of the cell, on the card at the
cell's own size, and reads what its comparison gives.  Run it as

    python3 drexbench/control.py --workload <name> --seeds 11,12,13 --seconds 10

which prints one JSON line a seed: the sound run's numbers (the lower
readings) and the control's (the upper readings).  It is not part of
the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

if __name__ == "__main__":
    ROOT = pathlib.Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from drexbench import catalog, harness  # noqa: E402
from drexbench.reference import ckpt as ref_ckpt  # noqa: E402
from drexbench.reference import place as ref_place  # noqa: E402

__all__ = ["fp8_roundtrip", "control_readings"]


def fp8_roundtrip(state: dict) -> dict:
    """Each leaf through float8 e4m3 and back to its own dtype."""
    import torch

    return {k: t.to(torch.float8_e4m3fn).to(t.dtype) for k, t in state.items()}


def _save_control(rec, got) -> dict:
    from drexbench.drivers import _ckpt

    conf = rec.cell.config
    policy = conf["policy"]
    group_bytes = int(float(policy["item_mb"]) * 1e6)
    saves, arr = got["saves"], got["arr"]
    groups = [_ckpt.groups_of(m) for _, m, *_ in saves]
    bad_place, _ = ref_ckpt.placement_mismatches(
        arr, policy, [(g, used) for g, (_, _, used, *_) in zip(groups, saves)], control=np.float32)
    keep = int(policy["keep_last"])
    gap = 0.0
    for j in range(len(saves)):
        want = arr.used_mb + ref_ckpt.occupancy(arr.n, groups[max(0, j - keep):j])
        ctl = arr.used_mb + ref_ckpt.occupancy(arr.n, groups[max(0, j - keep):j], np.float32)
        gap = max(gap, float(np.max(np.abs(ctl.astype(np.float64) - want))))
    fp8 = _ckpt.leaf_bytes(fp8_roundtrip(got["state"]))
    last = saves[-1][1]
    where = {g["key"]: (m["name"], part) for m in last["leaves"]
             for part, g in enumerate(m["groups"])}
    cache: dict = {}

    def read(node, g, row):
        if g["key"] not in cache:
            leaf, part = where[g["key"]]
            cache[g["key"]] = ref_ckpt.group_rows(fp8[leaf], g, part * group_bytes)
        return cache[g["key"]][row]

    leaves = _ckpt.leaf_bytes(got["state"])
    bad_bytes, _ = ref_ckpt.chunk_mismatch_bytes(last, leaves, group_bytes, read)
    return {"placement_mismatches": bad_place, "occupancy_gap_mb": gap,
            "chunk_mismatch_bytes": bad_bytes}


def _restore_control(rec, got) -> dict:
    from drexbench.drivers.ckpt_restore import mismatch_bytes

    state = got["state"]
    return {"restore_mismatch_bytes": int(mismatch_bytes(fp8_roundtrip(state), state))}


def _place_control(rec, got) -> dict:
    out = ref_place.replay(got["cluster"], got["decided"], got["sample"], control=np.float32)
    return {"decision_errors": out["errors"], "of_which_invalid": out["invalid"]}


CONTROLS = {"ckpt_save": _save_control, "ckpt_restore": _restore_control,
            "place_replay": _place_control}


def control_readings(cell, seed: int, seconds: float, device) -> dict:
    """One sound run of ``cell`` and the control's readings after it."""
    got: dict = {}
    rec = harness.run_cell(cell, seed, seconds, False, device, hooks={"capture": got.update})
    return {"seed": seed, "correct": harness.result_line(rec)["correct"],
            "sound": {c.name: c.value for c in rec.checks},
            "control": CONTROLS[cell.traffic["driver"]](rec, got)}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("drexbench control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = catalog.resolve(args.workload, catalog.with_pending(catalog.load_benchmark()))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_readings(cell, seed, args.seconds, torch.device("cuda", 0))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
