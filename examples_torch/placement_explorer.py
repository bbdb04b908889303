"""Paper-in-a-box on the port: run all D-Rex algorithms and SOTA baselines
on a real workload trace against a heterogeneous node set and print the
paper's §5 comparison (proportion stored, throughput, placement
histogram), plus, through the placement-engine API, batched
``place_many`` telemetry (per-item scheduler overhead, reject reasons,
DP-cache amortization).

The PyTorch counterpart of ``examples/placement_explorer.py``, with the
same flags, defaults and printed lines.  The kernel-backed schedulers
score on ``--device`` (the default is the GPU) wherever the reference's
dispatch rule sends a decision to the device scorer.  On the paper's
10-node sets it sends none there: a single item below
``KERNEL_MIN_NODES`` live nodes takes the numpy oracle, and an engine
that commits scores one item at a time.

    python examples_torch/placement_explorer.py --nodes most_used \\
        --dataset meva --reliability 0.99 [--device cpu]
"""

import argparse
import sys
import time
from collections import Counter

sys.path.insert(0, "src")

from repro_torch._device import resolve_device
from repro_torch.core import (
    BatchContext,
    PlacementEngine,
    SCHEDULER_NAMES,
    batch_stats,
    get_spec,
)
from repro_torch.storage import make_node_set, make_trace, run_simulation


def explore(nodes_name: str = "most_used", dataset: str = "meva",
            reliability="random_nines", fill: float = 0.95, *, device=None,
            capacity_scale: float = 0.001, batch_items: int = 200) -> dict:
    """Print the §5 table and the batched rows; return what they show."""
    dev = resolve_device(device)
    nodes = make_node_set(nodes_name, capacity_scale=capacity_scale)
    cap = sum(n.capacity_mb for n in nodes)
    items = make_trace(dataset, seed=0, total_mb=cap * fill, reliability=reliability)
    print(f"nodes={nodes_name} (raw {cap/1e3:.0f} GB), dataset={dataset}, "
          f"{len(items)} items, RT={reliability}")
    algos = [n for n in SCHEDULER_NAMES if n != "random_spread"]
    out = {"nodes": nodes_name, "dataset": dataset, "n_items": len(items),
           "raw_gb": cap / 1e3, "table": [], "batched": []}

    # §5 comparison through the simulator (I/O + failure model included).
    print(f"\n{'algorithm':22s} {'stored':>7s} {'thr MB/s':>9s}  top (K,P) choices")
    for name in algos:
        res = run_simulation(nodes, name, items, device=dev)
        hist = Counter((s.placement.k, s.placement.p) for s in res.stored_items)
        top = ", ".join(f"{kp}x{c}" for kp, c in hist.most_common(3))
        print(f"{name:22s} {res.stored_fraction:7.1%} {res.throughput_mbps:9.2f}  {top}")
        out["table"].append({"algorithm": name, "stored_fraction": res.stored_fraction,
                             "throughput_mbps": res.throughput_mbps,
                             "top": [[list(kp), c] for kp, c in hist.most_common(3)]})

    # Engine view: batched placement telemetry (no I/O model, pure placement).
    print(f"\nbatched place_many over the first {batch_items} items "
          f"(capabilities: a=adaptive, g=parity-growth):")
    print(f"{'algorithm':22s} {'caps':>5s} {'placed':>7s} {'ms/item':>8s} "
          f"{'amort':>7s}  top reject reason")
    batch = items[:batch_items]
    for name in algos:
        spec = get_spec(name)
        caps = ("a" if spec.capabilities.adaptive else "-") + (
            "g" if spec.capabilities.supports_parity_growth else "-"
        )
        seq = PlacementEngine(make_node_set(nodes_name, capacity_scale=capacity_scale), name,
                              device=dev)
        t0 = time.perf_counter()
        for it in batch:
            seq.place(it)
        t_seq = time.perf_counter() - t0
        eng = PlacementEngine(make_node_set(nodes_name, capacity_scale=capacity_scale), name,
                              device=dev)
        ctx = BatchContext()
        t0 = time.perf_counter()
        records = eng.place_many(batch, ctx=ctx)
        t_bat = time.perf_counter() - t0
        stats = batch_stats(records)
        top_reject = max(stats["reject_reasons"], key=stats["reject_reasons"].get,
                         default="")
        amort = t_seq / max(t_bat, 1e-9)
        print(f"{name:22s} {caps:>5s} {stats['n_placed']:4d}/{len(batch)} "
              f"{stats['overhead_per_item_ms']:8.2f} {amort:6.2f}x"
              f"  {top_reject}")
        out["batched"].append({
            "algorithm": name, "caps": caps, "placed": stats["n_placed"], "n": len(batch),
            "top_reject": top_reject, "placements": [
                None if r.placement is None else
                [r.placement.k, r.placement.p, [int(n) for n in r.placement.node_ids]]
                for r in records],
            # wall time, not compared
            "ms_per_item": stats["overhead_per_item_ms"], "amort": amort})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", default="most_used",
                    choices=["most_used", "most_unreliable", "most_reliable", "homogeneous"])
    ap.add_argument("--dataset", default="meva",
                    choices=["meva", "sentinel2", "swim", "ibm_cos"])
    ap.add_argument("--reliability", default="random_nines",
                    help="'random_nines' or a float like 0.99")
    ap.add_argument("--fill", type=float, default=0.95,
                    help="workload volume as a fraction of raw capacity")
    ap.add_argument("--device", default=None,
                    help="torch device of the batch scorers (default: the GPU)")
    args = ap.parse_args(argv)
    rel = args.reliability if args.reliability == "random_nines" else float(args.reliability)
    return explore(args.nodes, args.dataset, rel, args.fill, device=args.device)


if __name__ == "__main__":
    main()
