"""Logical topology demand of one job's DP ring (paper §4.2).

A *logical topology* is a tensor ``C[h, i, j]`` — the number of bidirectional
links required between the h-th spines of pods i and j.  It must be
symmetric (L2-compatibility, eq. 11) and degree-feasible (eq. 12).

The port's copy of the part of ``repro.core.logical`` that
``configs.job_demand`` needs, with one deliberate difference.  On a ring of
two pods the reference's ``ring_pairs`` collapses the ring onto one hop, so
its ``ring_demand`` asks ``links`` per pair; its own test
(``tests/test_logical.py::test_ring_demand_two_pods``) and the per-pod
degree of every larger ring (two hops × ``links``) say that both ring
directions land on that pair, ``2 × links``.  This copy gives ``2 × links``
there (ROADMAP C.2); on three or more pods it gives the reference's answer
exactly.  The random demands, job placements and budget shaving of the
reference (the simulator's workloads) are not copied.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .topology import ClusterSpec

__all__ = ["ring_demand", "ring_pairs"]


def ring_pairs(order: Sequence[int]) -> List[Tuple[int, int]]:
    """The hops ``(order[t], order[t + 1 mod n])`` of a ring over ``order``.

    A ring of two pods has two hops, a→b and the wrap-around b→a, both on
    the one pair (the reference returns one)."""
    n = len(order)
    if n < 2:
        return []
    return [(order[t], order[(t + 1) % n]) for t in range(n)]


def ring_demand(
    spec: ClusterSpec, pods: Sequence[int], links: int, num_groups: Optional[int] = None
) -> np.ndarray:
    """Demand of a bidirectional ring over ``pods`` with ``links`` parallel
    links per hop per spine group (the DP all-reduce pattern)."""
    P = spec.num_pods
    H = num_groups if num_groups is not None else spec.num_ocs_groups
    C = np.zeros((H, P, P), dtype=np.int64)
    for i, j in ring_pairs(list(pods)):
        if i == j:
            continue
        C[:, i, j] += links
        C[:, j, i] += links
    return C
