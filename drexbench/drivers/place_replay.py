"""Open-loop replay of an item trace through the placement service.

The trace's items arrive on the service's virtual clock at the mix's
rate; the service (``PlacementFrontier``) gathers them into windows and
decides each window with one ``place_many`` call on its engine.  The
virtual clock runs as fast as host and card allow, so the window is a
backlog: the end-to-end rate is the items decided over the wall time.
Set-up builds the cluster and the trace, and warms up with one window
of the trace's first items on a throwaway copy of the service.  After
the window the queue is drained (untimed) and the reference replays
every decision in order, holding each to D-Rex's guarantees, and decides
again with the frozen oracle a sample of ``oracle_sample`` of them drawn
from the seed.
"""

from __future__ import annotations

import numpy as np

from drexbench import inputs
from drexbench.harness import Check, window
from drexbench.reference import drex_sc
from drexbench.reference import place as ref


def _service(conf, arr, device):
    from repro_torch.core import ClusterView, PlacementEngine
    from repro_torch.serve.placement import FrontierConfig, PlacementFrontier

    cluster = ClusterView(
        capacity_mb=arr.capacity_mb.copy(), used_mb=arr.used_mb.copy(),
        write_bw=arr.write_bw.copy(), read_bw=arr.read_bw.copy(), afr=arr.afr.copy(),
        alive=np.ones(arr.n, dtype=bool), rack=arr.rack.copy(),
        zone=np.zeros(arr.n, dtype=np.int64),
    )
    engine = PlacementEngine(cluster, conf["scheduler"], device=device)
    return engine, PlacementFrontier(engine, FrontierConfig(**conf["frontier"]))


def run(rec, hooks: dict) -> None:
    from repro_torch.core import DataItem
    from repro_torch.serve.placement import ADMISSION_REJECT, arrival_events

    conf, mix = rec.cell.config, rec.cell.traffic
    arr = inputs.cluster_arrays(conf["cluster"])
    items = inputs.make_trace(mix, rec.seed)
    events = arrival_events([DataItem(it.item_id, it.size_mb, it.arrival_s, it.delta_t_days,
                                      it.target) for it in items])
    # warm-up: the trace's first window on a copy of the service
    _, warm = _service(conf, arr, rec.device)
    warm.run(events[: int(conf["frontier"]["max_batch"])])
    engine, frontier = _service(conf, arr, rec.device)
    if "engine" in hooks:
        hooks["engine"](engine)
    engine.place_many = rec.spans.wrap("place_many", engine.place_many)
    if rec.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    pending = iter(events)
    offered = 0

    def one_event() -> bool:
        nonlocal offered
        ev = next(pending, None)
        if ev is None:
            return False
        frontier.advance(ev.t)
        frontier.submit(ev.payload, ev.t)
        offered += 1
        return True

    def decided() -> tuple[int, int]:
        """(outcomes so far, admission rejections among them)"""
        return (len(frontier.outcomes),
                sum(1 for o in frontier.outcomes if o.status == ADMISSION_REJECT))

    marks = []
    window(rec, one_event, between=lambda: marks.append((offered, *decided())))
    marks.append((offered, *decided()))
    timed_offered, timed_out, timed_adm = marks[0]
    _, all_out, all_adm = marks[-1]
    rec.attempted, rec.failed = timed_offered, timed_adm
    n_ops = timed_out - timed_adm
    rec.facts.update(n_ops=n_ops, n_live=arr.n, offered=offered,
                     traced_ops=(all_out - all_adm) - n_ops,
                     mean_window=n_ops / max(1, len(rec.spans.seconds("place_many", *rec.window_ns))))
    frontier.drain()
    _check(rec, arr, items[:offered], frontier.outcomes, hooks)


def oracle_sample(rec, n: int) -> set:
    """The decisions the frozen oracle makes again."""
    rng = np.random.default_rng([rec.seed, 3])
    return set(rng.choice(n, size=min(int(rec.cell.traffic["oracle_sample"]), n),
                          replace=False).tolist())


def _check(rec, arr, offered_items, outcomes, hooks) -> None:
    mix = rec.cell.traffic
    lim = mix["limits"]
    by_id = {it.item_id: it for it in offered_items}
    seen: dict = {}
    decided = []
    for o in outcomes:
        seen[o.item_id] = seen.get(o.item_id, 0) + 1
        if o.status == "admission_reject" or o.item_id not in by_id:
            continue
        pl = o.placement
        decided.append((by_id[o.item_id], o.status,
                        pl.k if pl else 0, pl.p if pl else 0,
                        tuple(pl.node_ids) if pl else (), o.reason))
    missing = (sum(1 for i in by_id if seen.get(i, 0) != 1)
               + sum(1 for i in seen if i not in by_id))
    n = len(decided)
    sample = oracle_sample(rec, n)
    cluster = drex_sc.Cluster(arr.capacity_mb.copy(), arr.used_mb.copy(), arr.write_bw.copy(),
                              arr.read_bw.copy(), arr.afr.copy(), np.ones(arr.n, dtype=bool))
    if "capture" in hooks:
        hooks["capture"](dict(cluster=cluster, decided=decided, sample=sample))
    got = ref.replay(cluster, decided, sample)
    rec.facts.update(decisions_compared=len(sample), decisions_checked=n,
                     outcomes_missing=missing, invalid=got["invalid"],
                     mismatched=got["mismatched"])
    # an offered item without exactly one outcome is a decision in error
    rec.checks.append(
        Check("decision_errors", float(got["errors"] + missing), float(lim["decision_errors"])))
