"""Storage substrate: the paper's heterogeneous node sets."""

from .nodesets import NODE_SETS, chameleon_nodes, make_node_set

__all__ = ["NODE_SETS", "make_node_set", "chameleon_nodes"]
