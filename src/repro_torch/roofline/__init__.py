"""Roofline analysis of the port: FLOP, byte and collective counting of a
traced torch program, and the roofline terms of one H100 per rank.

The reference's HLO parser (``hlo_analysis.parse_hlo``, the fusion
model) and ``breakdown.py`` read XLA HLO text, which torch does not
produce; :class:`TraceStats` counts what one rank's ops read, write and
communicate instead."""

from .counting import FlopCount, TraceStats, count_fn_flops
from .terms import (
    HBM_BW,
    IB_NDR_BW,
    PEAK_FLOPS_BF16,
    RooflineTerms,
    model_flops_for,
)

__all__ = [
    "FlopCount", "TraceStats", "count_fn_flops",
    "RooflineTerms", "model_flops_for",
    "PEAK_FLOPS_BF16", "HBM_BW", "IB_NDR_BW",
]
