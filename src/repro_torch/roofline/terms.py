"""Roofline terms for one NVIDIA H100 SXM (80GB HBM3, 700 W) per rank.

The port of ``repro.roofline.terms``, with the same formulas and
``to_dict`` keys:

    compute term    = global_FLOPs / (chips * peak_FLOP/s)
    memory term     = per_device_HBM_bytes / HBM_bw
    collective term = per_device_collective_bytes / link_bw

The constants are the H100 SXM datasheet's for the card ``nvidia-smi``
names "NVIDIA H100 80GB HBM3" at its 700 W limit: dense bf16 989e12
FLOP/s and HBM3 3.35e12 B/s.  The link is InfiniBand: a 16x16 mesh spans
32 eight-GPU nodes, so its collectives cross the network, one NDR 400
Gb/s NIC per GPU, 50e9 B/s (NVLink inside a node is faster and is not
what bounds a mesh of this size).  Global FLOPs come from
:func:`repro_torch.roofline.count_fn_flops` over the step without a mesh;
per-device bytes and collective bytes from the step traced on the mesh
(:mod:`repro_torch.launch.dryrun`).  MODEL_FLOPS = 6*N*D (dense) or
6*N_active*D (MoE) gives the useful-compute ratio.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS_BF16 = 989e12       # per GPU, dense bf16 (H100 SXM datasheet)
HBM_BW = 3.35e12               # bytes/s per GPU (HBM3)
IB_NDR_BW = 50e9               # bytes/s per GPU: one InfiniBand NDR 400 Gb/s NIC


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    global_flops: float
    per_device_hbm_bytes: float            # unfused: every op's reads + writes
    per_device_collective_bytes: float
    collective_breakdown: dict
    model_flops: float
    hlo_dot_flops_per_device: float = 0.0  # dot FLOPs of one rank's local ops
    per_device_hbm_bytes_raw: float = 0.0  # the same unfused sum

    @property
    def compute_s(self) -> float:
        return self.global_flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def memory_s(self) -> float:
        return self.per_device_hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.per_device_collective_bytes / IB_NDR_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: no overlap (upper bound on the dominant)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.global_flops if self.global_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the dominant-term-limited step achieves on
        *useful* model FLOPs — the headline score."""
        if self.step_time_s <= 0:
            return 0.0
        achieved = self.model_flops / self.step_time_s
        return achieved / (self.chips * PEAK_FLOPS_BF16)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "global_flops": self.global_flops,
            "model_flops": self.model_flops,
            "per_device_hbm_bytes": self.per_device_hbm_bytes,
            "per_device_hbm_bytes_raw": self.per_device_hbm_bytes_raw,
            "memory_s_raw": self.per_device_hbm_bytes_raw / HBM_BW,
            "per_device_collective_bytes": self.per_device_collective_bytes,
            "collective_breakdown": self.collective_breakdown,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "hlo_dot_flops_per_device": self.hlo_dot_flops_per_device,
        }


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """6*N*D for training, 2*N*D for inference forward (D = tokens)."""
    n = cfg.n_active_params() if cfg.moe else cfg.n_params()
    if shape_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n * tokens
    if shape_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * global_batch
