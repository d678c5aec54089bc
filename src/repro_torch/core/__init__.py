"""Cross Wiring control plane, the port's copy of what the train launcher
runs: physical topology, the decomposition theorems MDMCF uses, MDMCF
itself, and the DP ring's logical-topology demand (numpy and scipy only)."""
from .topology import ClusterSpec, CrossWiring, OCSConfig, PhysicalTopology, Uniform, demand_feasible
from .decomposition import (
    assign_unit,
    check_edge_coloring,
    check_symmetric_split,
    edge_color_bipartite,
    symmetric_split,
    symmetric_split_euler,
    symmetric_split_mcf,
)
from .reconfig import ReconfigResult, config_cosine, ltrr, mdmcf_reconfigure
from .logical import ring_demand, ring_pairs

__all__ = [
    "ClusterSpec",
    "CrossWiring",
    "OCSConfig",
    "PhysicalTopology",
    "Uniform",
    "demand_feasible",
    "assign_unit",
    "check_edge_coloring",
    "check_symmetric_split",
    "edge_color_bipartite",
    "symmetric_split",
    "symmetric_split_euler",
    "symmetric_split_mcf",
    "ReconfigResult",
    "config_cosine",
    "ltrr",
    "mdmcf_reconfigure",
    "ring_demand",
    "ring_pairs",
]
