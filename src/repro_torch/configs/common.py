"""Shared plumbing for per-architecture config modules.

Each ``configs/<arch>.py`` declares:

* ``ARCH_ID``   — the architecture id (``--arch`` value).
* ``config()``  — the exact full-scale :class:`~repro_torch.models.config.ModelConfig`.
* ``PLAN``      — a :class:`ParallelismPlan`: how the architecture's traffic
  maps onto the paper's cluster (TP/EP in-pod, DP across pods over the OCS
  core).

These modules are data, copied from ``repro.configs`` so that the port
imports nothing of the JAX package; ``tests/test_torch_configs.py`` holds
the two copies equal field by field.
"""
from __future__ import annotations

import dataclasses


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
