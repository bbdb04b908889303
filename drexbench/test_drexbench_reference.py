"""The frozen trace generator, the frozen D-Rex SC oracle and the numpy
GF(2^8) code agree with the port at small sizes, and the yardstick counts
what the layout says."""

import json

import numpy as np
import pytest
import torch

from drexbench import catalog, inputs, yardstick
from drexbench.reference import drex_sc, rs

SENTINEL = json.loads((catalog.BENCH_DIR / "traffic" / "sentinel2_750.json").read_text())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_trace_generator_is_the_ports(seed):
    from repro_torch.storage import make_trace

    mix = dict(SENTINEL, n_items=700)
    got = inputs.make_trace(mix, seed)
    days = 700 / mix["rate_per_s"] / 86400.0
    want = make_trace("sentinel2", seed=seed, n_items=700, duration_days=days,
                      delta_t_days=mix["retention_days"])
    assert [(g.size_mb, g.arrival_s, g.target, g.delta_t_days) for g in got] == [
        (w.size_mb, w.arrival_time, w.reliability_target, w.delta_t_days) for w in want]


@pytest.mark.parametrize("kp", [(1, 1), (3, 2), (4, 1), (6, 3), (10, 4)])
def test_cauchy_rs_is_the_ports(kp):
    from repro_torch.ec import ECCodec

    k, p = kp
    payload = np.random.default_rng(k * 31 + p).integers(0, 256, size=50_001, dtype=np.uint8)
    padded = np.zeros(rs.bucket_len(payload.size), dtype=np.uint8)
    padded[: payload.size] = payload
    got = ECCodec(k, p, use_kernel=False, device="cpu").encode(torch.from_numpy(padded)).numpy()
    data = rs.data_rows(payload, k)
    assert got.shape == (k + p, rs.chunk_len(payload.size, k))
    assert np.array_equal(got, np.concatenate([data, rs.encode_rows(data, p)]))
    # the same code on torch tensors, as the save cell's check runs it on the card
    rows = rs.data_rows(torch.from_numpy(payload), k)
    assert np.array_equal(rows.numpy(), data)
    assert np.array_equal(rs.encode_rows(rows, p).numpy(), got[k:])


def _oracle_pair(n_drives: int, seed: int):
    from repro_torch.core import ClusterView
    from repro_torch.core.algorithms import DRexSC

    conf = json.loads((catalog.BENCH_DIR / "configs" / "drex_sc.bb_most_used_10k.json").read_text())
    spec = dict(conf["cluster"], n_drives=n_drives, draw_seed=seed)
    arr = inputs.cluster_arrays(spec)
    view = ClusterView(arr.capacity_mb.copy(), arr.used_mb.copy(), arr.write_bw.copy(),
                       arr.read_bw.copy(), arr.afr.copy(), np.ones(arr.n, dtype=bool))
    sc = DRexSC(device="cpu")
    sc.use_kernel = False
    ref = drex_sc.Cluster(arr.capacity_mb.copy(), arr.used_mb.copy(), arr.write_bw.copy(),
                          arr.read_bw.copy(), arr.afr.copy(), np.ones(arr.n, dtype=bool))
    return view, sc, ref


@pytest.mark.parametrize("n_drives,seed", [(10, 1), (40, 2), (1100, 3)])
def test_oracle_is_the_ports(n_drives, seed):
    from repro_torch.core import DataItem

    view, sc, ref = _oracle_pair(n_drives, seed)
    items = inputs.make_trace(dict(SENTINEL, n_items=12 if n_drives > 100 else 40), seed)
    smin = None
    for it in items:
        smin = it.size_mb if smin is None else min(smin, it.size_mb)
        d = sc.place_scalar(DataItem(it.item_id, it.size_mb, 0.0, it.delta_t_days, it.target), view)
        r = drex_sc.place(ref, it.size_mb, it.target, it.delta_t_days, smin)
        if d.placement is None:
            assert not r.ok and r.reason == d.reason
            continue
        pl = d.placement
        assert (pl.k, pl.p, pl.node_ids) == (r.k, r.p, r.node_ids)
        assert drex_sc.pr_avail_exact(drex_sc.pr_failure(ref.afr, it.delta_t_days)[list(r.node_ids)],
                                      r.p) >= it.target
        view.commit(pl, it.size_mb / pl.k)
        ref.used_mb[list(r.node_ids)] += it.size_mb / r.k


def test_frontier_is_the_ports():
    from repro_torch.core.reliability import ParityFrontier

    probs = np.random.default_rng(5).uniform(1e-4, 0.05, size=300)
    for target in (0.9, 0.999, 0.9999999):
        want = ParityFrontier(probs, target).upto(300)
        assert np.array_equal(drex_sc.prefix_frontier(probs, target, 300), want)


def test_yardstick_counts():
    # one start of 1,025 prefix steps once the budget of 1,024 windows is spent
    assert drex_sc.frontier_dp_ops(10_000) == sum(3 * (i + 2) + 2 for i in range(1025))
    assert drex_sc.frontier_dp_ops(10_000) == drex_sc.frontier_dp_ops(2_000)
    # three nodes: start 0 probes prefixes 1-3, start 1 prefixes 1-2
    assert drex_sc.frontier_dp_ops(3) == (8 + 11 + 14) + (8 + 11)
    g = {"k": 4, "p": 1, "chunk_len": 1000}
    assert yardstick.encode_bytes([g]) == 5 * 1000 + 64 * 4
    assert yardstick.decode_bytes([g, g], [1, 0]) == 5 * 1000 + 64 * 4
