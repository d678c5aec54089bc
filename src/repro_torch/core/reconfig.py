"""OCS reconfiguration under Cross Wiring (paper §3.2 ILP model, §4.2).

:func:`mdmcf_reconfigure` is the paper's polynomial-time algorithm for the
Cross Wiring physical topology ("ITV-MDMCF"): Thm 3.1 symmetric split, then
Thm 3.2's sub-permutation specialization (bipartite edge coloring) with a
warm start + Hungarian slot matching for the Min-Rewiring objective (eq. 7).
It realizes **every** feasible logical topology exactly (Thm 4.1).

The port's copy of the part of ``repro.core.reconfig`` that the train
launcher's control plane runs (``repro_torch.launch.train.control_plane``),
with :func:`ltrr` and :func:`config_cosine`.  Left out: the ``mask``
argument (the fault model's degraded-mode solve; the fault model is not
ported), the hook that emits the simulator's trace instants after a solve
(its tracer, ``repro.obs``, is not ported), and the baselines the simulator
compares against (``mdmcf_cold``, the Uniform solvers, Helios, the ILP
checker).  The configuration it emits is the reference's, entry for entry
(``tests/test_torch_control_plane.py``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from .decomposition import edge_color_bipartite, symmetric_split
from .topology import ClusterSpec, OCSConfig, demand_feasible

__all__ = [
    "mdmcf_reconfigure",
    "ltrr",
    "config_cosine",
    "ReconfigResult",
]


class ReconfigResult:
    """Output of a reconfiguration strategy.

    The emitted configuration is frozen: solvers are done mutating it, and
    freezing turns on :class:`~repro_torch.core.topology.OCSConfig`'s derived-view
    memoization (``pair_capacity``/``realized_bidirectional``) for all the
    flow-model / ring-scoring reads between reconfigurations.
    """

    def __init__(self, config: OCSConfig, demand: np.ndarray, seconds: float):
        self.config = config.freeze()
        self.demand = demand
        self.seconds = seconds

    @property
    def ltrr(self) -> float:
        return ltrr(self.config, self.demand)


def _cos(u: np.ndarray, v: np.ndarray) -> float:
    u = u.astype(np.float64).ravel()
    v = v.astype(np.float64).ravel()
    nu, nv = np.linalg.norm(u), np.linalg.norm(v)
    if nu == 0 or nv == 0:
        return 1.0 if nu == nv else 0.0
    return float(min(1.0, max(-1.0, u @ v / (nu * nv))))


def ltrr(config: OCSConfig, C: np.ndarray) -> float:
    """Logical Topology Realization Rate (paper eq. 15):
    cosine between realized bidirectional link counts and the demand."""
    realized = config.realized_bidirectional()
    return _cos(realized, C)


def config_cosine(a: OCSConfig, b: OCSConfig) -> float:
    """cos(x_l, x_{l-1}) — the MRAR building block (paper eq. 16)."""
    return _cos(a.x, b.x)


# --------------------------------------------------------------------------
# ITV-MDMCF (Cross Wiring)
# --------------------------------------------------------------------------

def mdmcf_reconfigure(
    spec: ClusterSpec,
    C: np.ndarray,
    old: Optional[OCSConfig] = None,
    method: str = "euler",
    slot_match: bool = True,
) -> ReconfigResult:
    """The paper's polynomial-time reconfiguration under Cross Wiring.

    ``C``: demand of shape ``(H, P, P)`` satisfying (11)(12).  Realizes it
    exactly.  ``method`` selects the Thm 3.1 implementation ("euler" fast
    path or "mcf" oracle).  With ``old`` given, the edge coloring is
    warm-started from the previous even-OCS sub-permutations and color
    classes are then Hungarian-matched to OCS slots to minimize rewiring.
    """
    t0 = time.perf_counter()
    C = np.asarray(C)
    if not demand_feasible(C, spec):
        raise ValueError("demand violates (11)(12); not a feasible logical topology")
    H = C.shape[0]
    K2 = spec.k_spine // 2
    cfg = OCSConfig(spec, num_groups=H)
    for h in range(H):
        A = symmetric_split(C[h], method=method)
        warm = old.x[h, 0::2] if old is not None else None
        colors = edge_color_bipartite(A, K2, warm=warm)
        order = np.arange(K2)
        if old is not None and slot_match and K2:
            # overlap[t, s] = links kept if color class t lands on slot s
            # (flattened float32 matmuls — much faster than int einsums)
            old_even = old.x[h, 0::2].reshape(K2, -1).astype(np.float32)
            old_odd = (
                np.transpose(old.x[h, 1::2], (0, 2, 1)).reshape(K2, -1).astype(np.float32)
            )
            cflat = colors.reshape(K2, -1).astype(np.float32)
            overlap = cflat @ (old_even + old_odd).T
            rows, cols_idx = linear_sum_assignment(-overlap)
            order = np.empty(K2, dtype=np.int64)
            order[cols_idx] = rows  # slot s gets color class order[s]
        cfg.x[h, 0::2] = colors[order]  # even OCS 2t carries slot t's class
        cfg.x[h, 1::2] = np.transpose(colors[order], (0, 2, 1))  # odd OCS its transpose
    cfg.validate()
    res = ReconfigResult(cfg, C, time.perf_counter() - t0)
    cfg.preseed_pair_capacity(C)  # Thm 4.1: realized == C, skip the reduction
    return res
