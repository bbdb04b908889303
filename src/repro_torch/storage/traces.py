"""Workload-trace generators matching the paper's four datasets (Table 3).

The original archives (MEVA video clips, Sentinel-2 imagery, SWIM
MapReduce traces, the IBM COS object trace) total hundreds of TB and are
not redistributable; the schedulers only ever observe the tuple
``(size, arrival_time, RT, delta_t)`` per item, so we generate synthetic
traces whose per-item size statistics match Table 3 (count, mean, min,
max, std — lognormal body clipped to the published min/max) with
deterministic seeds. The benchmark presets standardize total request
volume the way the paper does (trim long traces / repeat MEVA).

Pure numpy, copied from the JAX package's ``storage/traces.py`` with its
draw order, so every trace is bit-equal to the reference's for the same
arguments.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.types import DataItem

__all__ = ["TraceSpec", "DATASET_NAMES", "make_trace", "random_reliability_targets"]


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Size model for one dataset; stats in MB, per Table 3."""

    name: str
    n_items: int
    mean_mb: float
    std_mb: float
    min_mb: float
    max_mb: float
    duration_days: float = 70.0  # §5.7 uses 70 days of MEVA input

    @property
    def lognormal_params(self) -> tuple[float, float]:
        """(mu, sigma) of the lognormal matching mean/std before clipping."""
        cv2 = (self.std_mb / self.mean_mb) ** 2
        sigma2 = math.log1p(cv2)
        mu = math.log(self.mean_mb) - sigma2 / 2.0
        return mu, math.sqrt(sigma2)


GB = 1024.0

_SPECS = {
    "meva": TraceSpec("meva", 4157, 117.1, 68.1, 1.4, 856.1),
    "sentinel2": TraceSpec("sentinel2", 256_351, 475.9, 256.5, 2.7, 969.9),
    "swim": TraceSpec("swim", 5214, 23.4 * GB, 177.0 * GB, 1e-6, 5329.5 * GB),
    "ibm_cos": TraceSpec("ibm_cos", 47_529, 2.6 * GB, 18.9 * GB, 0.2, 1345.8 * GB),
}

DATASET_NAMES = sorted(_SPECS)


def random_reliability_targets(m: int, rng: np.random.Generator) -> np.ndarray:
    """Per-item random 'number of nines' targets (paper §5.5).

    x ~ U{-1,...,5}; f(-1)=90, f(x)=100-10^-x for 0<=x<5, f(5)=99.99999;
    RT ~ U[f(x), f(x+1)] (as a probability in (0,1)), or f(5) when x=5.
    """

    def f(x: int) -> float:
        if x == -1:
            return 90.0
        if x >= 5:
            return 99.99999
        return 100.0 - 10.0 ** (-x)

    xs = rng.integers(-1, 6, size=m)
    lo = np.array([f(int(x)) for x in xs])
    hi = np.array([f(int(x) + 1) for x in xs])
    vals = np.where(xs == 5, 99.99999, rng.uniform(lo, hi))
    return vals / 100.0


def make_trace(
    name: str,
    *,
    seed: int = 0,
    total_mb: float | None = None,
    n_items: int | None = None,
    reliability: float | str = "random_nines",
    delta_t_days: float = 365.0,
    duration_days: float | None = None,
    size_scale: float = 1.0,
) -> list[DataItem]:
    """Generate a workload trace.

    ``total_mb``: if set, trim/repeat the trace until the cumulative item
    size reaches this volume (the paper standardizes at 122 TB).
    ``n_items``: alternatively cap the item count (benchmark subsets).
    ``reliability``: a fixed target in (0,1) or ``"random_nines"`` (§5.5).
    ``size_scale``: multiply item sizes (scaled-down CI presets).
    """
    spec = _SPECS.get(name)
    if spec is None:
        raise ValueError(f"unknown dataset {name!r}; known: {DATASET_NAMES}")
    rng = np.random.default_rng(seed)
    duration = spec.duration_days if duration_days is None else duration_days

    mu, sigma = spec.lognormal_params
    want = n_items if n_items is not None else spec.n_items

    sizes_parts: list[np.ndarray] = []
    total = 0.0
    count = 0
    while True:
        batch = np.clip(
            rng.lognormal(mu, sigma, size=max(1024, want)), spec.min_mb, spec.max_mb
        ) * size_scale
        if total_mb is not None:
            csum = total + np.cumsum(batch)
            cut = int(np.searchsorted(csum, total_mb, side="left")) + 1
            sizes_parts.append(batch[:cut])
            total = float(csum[min(cut, len(csum)) - 1])
            count += cut
            if total >= total_mb:
                break
        else:
            need = want - count
            sizes_parts.append(batch[:need])
            count += min(need, len(batch))
            if count >= want:
                break
    sizes = np.concatenate(sizes_parts)
    m = len(sizes)

    arrivals_days = np.sort(rng.uniform(0.0, duration, size=m))
    if isinstance(reliability, str):
        if reliability != "random_nines":
            raise ValueError(f"unknown reliability mode {reliability!r}")
        rts = random_reliability_targets(m, rng)
    else:
        rts = np.full(m, float(reliability))

    return [
        DataItem(
            item_id=i,
            size_mb=float(sizes[i]),
            arrival_time=float(arrivals_days[i] * 86400.0),
            delta_t_days=delta_t_days,
            reliability_target=float(rts[i]),
        )
        for i in range(m)
    ]
