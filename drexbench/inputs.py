"""Inputs the benchmark makes from a configuration file and ``--seed``:
the storage cluster, the checkpointed state and the item trace.

The same arrays go to the program and to the plain reference.  The
trace generator is a frozen copy of the paper-trace generator of the
repository's ``storage/traces.py`` (Table 3 size statistics: a lognormal
body clipped to the published min and max; §5.5's random "number of
nines" targets), kept here so that a change to the program cannot move
the yardstick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "TB_MB",
    "ClusterArrays",
    "Item",
    "cluster_arrays",
    "leaf_table",
    "make_state",
    "make_trace",
    "random_nines",
]

TB_MB = 1_000_000.0


@dataclass
class ClusterArrays:
    """Per-node arrays in MB, MB/s and failures a year, plus racks."""

    capacity_mb: np.ndarray
    used_mb: np.ndarray
    write_bw: np.ndarray
    read_bw: np.ndarray
    afr: np.ndarray
    rack: np.ndarray
    names: list

    @property
    def n(self) -> int:
        return int(self.capacity_mb.shape[0])


def cluster_arrays(spec: dict) -> ClusterArrays:
    """The cluster a configuration states.

    ``models`` rows are ``[name, capacity TB, write MB/s, read MB/s,
    AFR]``.  With ``n_drives`` absent, one drive of each model in order;
    with it, each drive's model and its occupancy (a share of its
    capacity, uniform in ``occupancy``) are drawn with the configuration's
    own ``draw_seed``, never with the run's seed, and racks hold
    ``rack_size`` consecutive drives."""
    models = spec["models"]
    n = int(spec.get("n_drives", len(models)))
    if "n_drives" in spec:
        rng = np.random.default_rng(int(spec["draw_seed"]))
        pick = rng.integers(0, len(models), size=n)
        lo, hi = spec.get("occupancy", [0.0, 0.0])
        share = rng.uniform(float(lo), float(hi), size=n)
    else:
        pick = np.arange(n)
        share = np.zeros(n)
    rows = [models[i] for i in pick]
    cap = np.array([float(r[1]) * TB_MB for r in rows])
    rack_size = int(spec.get("rack_size", n))
    return ClusterArrays(
        capacity_mb=cap,
        used_mb=cap * share,
        write_bw=np.array([float(r[2]) for r in rows]),
        read_bw=np.array([float(r[3]) for r in rows]),
        afr=np.array([float(r[4]) for r in rows]),
        rack=np.arange(n, dtype=np.int64) // rack_size,
        names=[str(r[0]) for r in rows],
    )


def leaf_table(payload: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every leaf of the checkpointed state, in order."""
    return [(str(name), tuple(int(d) for d in shape)) for name, shape in payload["leaves"]]


def make_state(payload: dict, seed: int, device) -> dict:
    """The state a training job would checkpoint: every leaf drawn from
    N(0, init_std) in the payload's dtype, on ``device``, by one
    generator seeded with ``seed`` in one call, then cut into leaves."""
    import torch

    dtype = getattr(torch, payload["dtype"])
    leaves = leaf_table(payload)
    total = sum(math.prod(shape) for _, shape in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    flat.mul_(float(payload["init_std"]))
    state, off = {}, 0
    for name, shape in leaves:
        n = math.prod(shape)
        state[name] = flat[off : off + n].view(shape)
        off += n
    return state


@dataclass(frozen=True)
class Item:
    """One store request: its size, arrival (s), retention (days), target."""

    item_id: int
    size_mb: float
    arrival_s: float
    delta_t_days: float
    target: float


def random_nines(m: int, rng: np.random.Generator) -> np.ndarray:
    """§5.5: x ~ U{-1..5}; f(-1) = 90, f(x) = 100 - 10^-x, f(5) = 99.99999;
    RT ~ U[f(x), f(x+1)] (f(5) when x = 5), as a probability."""

    def f(x: int) -> float:
        if x == -1:
            return 90.0
        if x >= 5:
            return 99.99999
        return 100.0 - 10.0 ** (-x)

    xs = rng.integers(-1, 6, size=m)
    lo = np.array([f(int(x)) for x in xs])
    hi = np.array([f(int(x) + 1) for x in xs])
    return np.where(xs == 5, 99.99999, rng.uniform(lo, hi)) / 100.0


def make_trace(mix: dict, seed: int) -> list[Item]:
    """``n_items`` items of the mix's dataset: sizes from the Table 3
    statistics, arrivals uniform over ``n_items / rate_per_s`` seconds (a
    Poisson process given its count), targets by ``reliability``."""
    spec = mix["dataset"]
    mean, std = float(spec["mean_mb"]), float(spec["std_mb"])
    sigma2 = math.log1p((std / mean) ** 2)
    mu, sigma = math.log(mean) - sigma2 / 2.0, math.sqrt(sigma2)
    n = int(mix["n_items"])
    rng = np.random.default_rng(int(seed))
    sizes = np.clip(rng.lognormal(mu, sigma, size=max(1024, n)),
                    float(spec["min_mb"]), float(spec["max_mb"]))[:n]
    horizon_days = n / float(mix["rate_per_s"]) / 86400.0
    arrivals = np.sort(rng.uniform(0.0, horizon_days, size=n)) * 86400.0
    rel = mix["reliability"]
    targets = random_nines(n, rng) if rel == "random_nines" else np.full(n, float(rel))
    days = float(mix["retention_days"])
    return [Item(i, float(sizes[i]), float(arrivals[i]), days, float(targets[i]))
            for i in range(n)]
