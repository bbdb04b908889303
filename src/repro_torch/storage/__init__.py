"""Storage substrate: heterogeneous node sets, workload traces, simulator."""

from .nodesets import NODE_SETS, chameleon_nodes, make_node_set
from .traces import DATASET_NAMES, make_trace, TraceSpec
from .simulator import SimConfig, SimResult, Simulator, run_simulation

__all__ = [
    "NODE_SETS",
    "make_node_set",
    "chameleon_nodes",
    "DATASET_NAMES",
    "make_trace",
    "TraceSpec",
    "Simulator",
    "SimConfig",
    "SimResult",
    "run_simulation",
]
