"""Shared plumbing for per-architecture config modules.

Each ``configs/<arch>.py`` declares:

* ``ARCH_ID``   — the architecture id (``--arch`` value).
* ``config()``  — the exact full-scale :class:`~repro_torch.models.config.ModelConfig`.
* ``PLAN``      — a :class:`ParallelismPlan`: how the architecture's traffic
  maps onto the paper's cluster (TP/EP in-pod, DP across pods over the OCS
  core).

These modules are data, copied from ``repro.configs`` so that the port
imports nothing of the JAX package; ``tests/test_torch_configs.py`` holds
the two copies equal field by field.  :func:`job_demand` is the reference's
too, through the port's own ``core.logical.ring_demand`` (which asks
``2 × links`` on a 2-pod ring where the reference asks ``links``; see
``repro_torch.core.logical``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.logical import ring_demand


@dataclasses.dataclass(frozen=True)
class ParallelismPlan:
    """How one architecture occupies the paper's cluster.

    Attributes
    ----------
    tp:
        tensor-parallel ways — always intra-pod (mesh axis ``model``).
    ep:
        expert-parallel ways — intra-pod; shares the ``model`` axis with TP.
    dp_cross_pod:
        whether the DP gradient ring crosses pods — the traffic the OCS core
        carries and the control plane provisions.
    seq_shard_long:
        long-context cells (batch=1) shard the sequence/state dim of the
        cache over the DP axes instead of the batch dim.
    ocs_links_per_ring_hop:
        how many parallel spine-level links the launcher requests per
        adjacent pod pair in the job's DP ring (per spine group).
    notes:
        one-line applicability note.
    """

    tp: int
    ep: int = 1
    dp_cross_pod: bool = True
    seq_shard_long: bool = False
    ocs_links_per_ring_hop: int = 4
    notes: str = ""


def job_demand(plan: ParallelismPlan, spec, pods: Tuple[int, ...]) -> np.ndarray:
    """Logical-topology demand this job asks from the control plane.

    The cross-pod traffic of an LLM job under the paper's containment policy
    is the DP gradient ring over the pods it occupies (PP would add the same
    chain pattern); TP/EP never leave the pod, so they produce no OCS demand.
    """
    if not plan.dp_cross_pod or len(pods) < 2:
        return np.zeros(
            (spec.num_ocs_groups, spec.num_pods, spec.num_pods), dtype=np.int64
        )
    return ring_demand(spec, list(pods), plan.ocs_links_per_ring_hop)
