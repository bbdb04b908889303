"""The plain reference of the placement cells.

It replays the service's decisions in the order they were made against
its own copy of the cluster, made from the same arrays the program was
given.  Every decision is held to D-Rex's guarantees (distinct live
nodes, each with room for its chunk, availability at least the item's
target over its retention: Eq. 2-3); a sample drawn from the seed is
decided again by the frozen oracle and compared whole, rejections and
their reasons included.  A placed item's chunks are then charged to the
reference's copy, so each sampled decision is judged against the
occupancy the decisions before it left.  Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np

from . import drex_sc

__all__ = ["replay"]


def _valid(c: drex_sc.Cluster, fp: np.ndarray, item, k: int, p: int, nodes) -> bool:
    """Whether a placement keeps D-Rex's guarantees on cluster ``c``."""
    ids = np.asarray(nodes, dtype=np.int64)
    chunk = item.size_mb / k if k >= 1 else np.inf
    return (k >= 1 and p >= 0 and len(ids) == k + p and len(set(nodes)) == len(nodes)
            and bool(np.all((ids >= 0) & (ids < len(c.alive))))
            and bool(np.all(c.alive[ids]))
            and bool(np.all(c.capacity_mb[ids] - c.used_mb[ids] >= chunk))
            and drex_sc.pr_avail_exact(fp[ids], p) >= item.target)


def replay(cluster: drex_sc.Cluster, decided, sample: set, control=None) -> dict:
    """``decided``: [(item, status, k, p, node_ids, reason)] in decision
    order, status "placed" or "rejected"; ``item`` has ``size_mb``,
    ``target`` and ``delta_t_days``.  Counts the placements that break a
    guarantee (``invalid``) and the sampled decisions that differ from
    the oracle's (``mismatched``); ``errors`` counts the decisions with
    either fault once.

    With ``control`` (a numpy float dtype), each sampled decision judged
    is the oracle's own in that precision, put in the program's place."""
    c = cluster.copy()
    fp_cache: dict = {}
    smin = None
    invalid = mismatched = errors = 0
    for i, (item, status, k, p, nodes, reason) in enumerate(decided):
        if item.size_mb > 0:
            smin = item.size_mb if smin is None else min(smin, item.size_mb)
        days = item.delta_t_days
        if days not in fp_cache:
            fp_cache[days] = drex_sc.pr_failure(c.afr, days)
        judged = (status == "placed", k, p, tuple(nodes), reason)
        wrong = False
        if i in sample:
            d = drex_sc.place(c, item.size_mb, item.target, days, smin)
            if control is not None:
                e = drex_sc.place(c, item.size_mb, item.target, days, smin, control)
                judged = (e.ok, e.k, e.p, e.node_ids, e.reason)
            want = (d.ok, d.k, d.p, d.node_ids, d.reason)
            got = judged if d.ok else judged[:1] + judged[4:]
            if got != (want if d.ok else want[:1] + want[4:]):
                mismatched += 1
                wrong = True
        if judged[0] and not _valid(c, fp_cache[days], item, *judged[1:4]):
            invalid += 1
            wrong = True
        errors += wrong
        if status == "placed" and _valid(c, fp_cache[days], item, k, p, nodes):
            c.used_mb[np.asarray(nodes, dtype=np.int64)] += item.size_mb / k
    return {"invalid": invalid, "mismatched": mismatched, "errors": errors}
