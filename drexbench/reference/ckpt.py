"""The plain reference of the checkpoint cells.

Given what the benchmark made (the cluster arrays, the state's bytes,
the policy) and what the program answered (each save's manifest, the
chunks read back from the fabric, the occupancy the save was placed
against), it works out each group's D-Rex SC decision with the frozen
oracle, each group's chunks with the numpy Cauchy-RS code, and each
node's occupancy from the chunks that should be stored.  Nothing here
imports the program.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np

from . import drex_sc, rs

__all__ = ["oracle_cluster", "placement_mismatches", "occupancy", "group_rows",
           "chunk_mismatch_bytes"]


def oracle_cluster(arr, used_mb: np.ndarray) -> drex_sc.Cluster:
    return drex_sc.Cluster(arr.capacity_mb.copy(), np.asarray(used_mb, dtype=np.float64).copy(),
                           arr.write_bw.copy(), arr.read_bw.copy(), arr.afr.copy(),
                           np.ones(arr.n, dtype=bool))


def group_sizes_mb(groups) -> list[float]:
    """The size D-Rex is asked to place for each group: its padded bucket."""
    return [max(rs.bucket_len(g["orig_nbytes"]) / 1e6, 1e-6) for g in groups]


def placement_mismatches(arr, policy: dict, saves, control=None) -> tuple[int, int]:
    """(groups whose (K, P, nodes) differ from the oracle's, groups compared).

    ``saves`` is [(groups, used_mb before the save)] in the order the
    saves ran; the smallest item seen carries over from save to save, as
    the scheduler's does.  Within a save every group is placed against
    the same occupancy (the fabric accounts bytes as chunks land).  With
    ``control`` (a numpy float dtype) the oracle's own decisions in that
    precision are compared in the program's place."""
    smin = None
    bad = total = 0
    for groups, used in saves:
        cluster = oracle_cluster(arr, used)
        memo: dict = {}
        for g, size in zip(groups, group_sizes_mb(groups)):
            smin = size if smin is None else min(smin, size)
            key = (size, smin)
            if key not in memo:
                args = (cluster, size, float(policy["reliability_target"]),
                        float(policy["retention_days"]), smin)
                want = drex_sc.place(*args)
                got = drex_sc.place(*args, control) if control is not None else None
                memo[key] = (want, got)
            d, e = memo[key]
            total += 1
            got = (g["k"], g["p"], tuple(g["node_ids"])) if e is None else (e.k, e.p, e.node_ids)
            if not d.ok or got != (d.k, d.p, d.node_ids):
                bad += 1
    return bad, total


def occupancy(n_nodes: int, stored, dtype=np.float64) -> np.ndarray:
    """MB each node holds when the groups of ``stored`` (a list of
    manifests' group lists) are on the fabric."""
    used = np.zeros(n_nodes, dtype=dtype)
    for groups in stored:
        for g in groups:
            mb = dtype(g["chunk_len"] / 1e6)
            for node in g["node_ids"]:
                used[node] += mb
    return used


def group_rows(leaf_bytes, g, off: int) -> np.ndarray:
    """(K + P, chunk_len) chunk rows of the group at ``off`` of a leaf's
    bytes (numpy, or a torch uint8 tensor coded on its device), on the host."""
    payload = leaf_bytes[off : off + g["orig_nbytes"]]
    data = rs.data_rows(payload, g["k"])
    parity = rs.encode_rows(data, g["p"])
    if isinstance(data, np.ndarray):
        return np.concatenate([data, parity])
    import torch

    return torch.cat([data, parity]).cpu().numpy()


def chunk_mismatch_bytes(manifest, leaves: dict, group_bytes: int, read,
                         workers: int = 4) -> tuple[int, int]:
    """(chunk bytes that differ from the reference code, bytes compared).

    Every chunk of every group is compared, data and parity.  ``leaves``
    holds each leaf's raw bytes (see :func:`group_rows`).  ``read(node,
    group, row)`` returns the bytes the program stored for that chunk, or
    None; a missing chunk counts all its bytes."""
    jobs = []
    for leaf in manifest["leaves"]:
        for part, g in enumerate(leaf["groups"]):
            jobs.append((leaves[leaf["name"]], dict(g, chunk_len=rs.chunk_len(g["orig_nbytes"], g["k"])),
                         part * group_bytes))

    def one(job):
        leaf_bytes, g, off = job
        want = group_rows(leaf_bytes, g, off)
        bad = 0
        for row in range(want.shape[0]):
            got = read(g["node_ids"][row], g, row)
            if got is None or got.size != want.shape[1]:
                bad += want.shape[1]
            elif not np.array_equal(got, want[row]):
                bad += int(np.count_nonzero(got != want[row]))
        return bad, want.size

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(one, jobs))
    return sum(b for b, _ in results), sum(n for _, n in results)
