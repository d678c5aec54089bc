"""Physical topology design for OCS-based LLM clusters (paper §3.1, §4.1).

Two physical topologies are modeled:

* :class:`CrossWiring` — the paper's contribution.  OCSes come in adjacent
  pairs ``(2k, 2k+1)`` inside each OCS group; the ingress wiring of a spine's
  port pair ``(2k, 2k+1)`` is *swapped* relative to the egress wiring, so the
  even sub-topology and the odd sub-topology are mirrored (transposes of each
  other).  Theorem 4.1: every symmetric, degree-feasible logical topology is
  realizable.

* :class:`Uniform` — the uniform bipartite design used by Gemini / Jupiter
  Evolving: both Tx and Rx of spine port ``k`` land on OCS ``k`` of the
  corresponding group.  Under the L2-compatibility constraint each OCS can
  only host a *symmetric matching* of pods, which makes some logical
  topologies unrealizable (paper Fig. 1).

Everything here is plain numpy — this is the cluster *control plane*.

The port's copy of ``repro.core.topology`` (the port imports nothing of the
JAX package).  It leaves out the ``mask`` arguments of
:meth:`OCSConfig.validate` and :func:`demand_feasible`: they take the fault
model's ``PortMask``, and the fault model is not ported.  Everything else
keeps its name, signature and arithmetic; ``tests/test_torch_control_plane.py``
holds the two copies equal.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

__all__ = [
    "ClusterSpec",
    "PhysicalTopology",
    "CrossWiring",
    "Uniform",
    "OCSConfig",
]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Key deployment-stage parameters of an OCS-based cluster (paper §2.1).

    Attributes
    ----------
    num_pods:
        ``P`` — number of pods.  Must satisfy ``P <= k_ocs``.
    k_spine:
        number of OCS-facing ports per spine (== OCSes per OCS group).
        Must be even (paper §3.1 assumption).
    k_leaf:
        number of spine-facing ports per leaf (== GPU-facing ports per leaf).
    tau:
        number of links between each (leaf, spine) pair inside a pod.
    k_ocs:
        number of ingress (= egress) ports per OCS; bounds the pod count.
    slowdown_cap:
        flow-model slowdown ceiling for starved cross-pod traffic: a flow
        whose OCS circuits are gone still progresses at ``1/slowdown_cap``
        of full rate over residual electrical paths.  ``None`` configures
        *zero* residual electrical capacity — a fully-dark circuit then
        stalls its flows outright (infinite slowdown) instead of quietly
        bottoming out at the cap.
    """

    num_pods: int
    k_spine: int = 8
    k_leaf: int = 8
    tau: int = 1
    k_ocs: int = 512
    slowdown_cap: Optional[float] = 4.0

    def __post_init__(self) -> None:
        if self.k_spine % 2:
            raise ValueError("K_spine must be even (paper assumes port pairing)")
        if self.slowdown_cap is not None and self.slowdown_cap < 1.0:
            raise ValueError("slowdown_cap must be >= 1 (or None for no floor)")
        if self.k_leaf % self.tau:
            raise ValueError("K_leaf must be divisible by tau")
        if self.num_pods > self.k_ocs:
            raise ValueError(
                f"Cross Wiring interconnects at most K_ocs={self.k_ocs} pods; "
                f"got P={self.num_pods}"
            )

    # ---- derived sizes (paper §3.1) -------------------------------------
    @property
    def leaves_per_pod(self) -> int:
        return self.k_spine // self.tau

    @property
    def spines_per_pod(self) -> int:
        return self.k_leaf // self.tau

    @property
    def gpus_per_pod(self) -> int:
        return self.k_spine * self.k_leaf // self.tau

    @property
    def num_gpus(self) -> int:
        return self.num_pods * self.gpus_per_pod

    @property
    def num_ocs_groups(self) -> int:
        # One OCS group per spine index h.
        return self.spines_per_pod

    @property
    def ocs_per_group(self) -> int:
        return self.k_spine


class OCSConfig:
    """A full OCS-layer configuration.

    ``x[h][k]`` is a ``P×P`` 0/1 matrix: ``x[h][k][i, j] == 1`` iff OCS ``k``
    of group ``h`` forwards the egress of pod ``i``'s spine ``h`` into the
    ingress of pod ``j``'s spine ``h`` (a directed optical circuit i→j).

    Feasibility per OCS: each pod has exactly one egress and one ingress port
    on each OCS it is wired to, so each ``x[h][k]`` must have row sums ≤ 1 and
    column sums ≤ 1 (a sub-permutation, ILP constraints (4)(5)).
    """

    def __init__(self, spec: ClusterSpec, num_groups: int | None = None):
        self.spec = spec
        self.num_groups = num_groups if num_groups is not None else spec.num_ocs_groups
        P, K = spec.num_pods, spec.ocs_per_group
        self.x = np.zeros((self.num_groups, K, P, P), dtype=np.int8)
        self._derived_cache: Dict[str, np.ndarray] = {}

    def copy(self) -> "OCSConfig":
        out = OCSConfig(self.spec, self.num_groups)
        out.x = self.x.copy()  # writable even when self is frozen
        return out

    # ---- derived-view cache ----------------------------------------------
    def freeze(self) -> "OCSConfig":
        """Mark ``x`` immutable and enable memoization of the derived views.

        Solvers freeze the configuration they emit (``ReconfigResult``
        does it), so the O(H·P²) reductions below are computed once per
        reconfiguration instead of on every slowdown re-evaluation in
        between.  Hand-built (unfrozen) configs keep recomputing fresh —
        mutate-after-read stays correct for them.  Rebuilding ``x`` on a
        frozen config requires ``invalidate_cache()`` (which re-opens it).
        """
        self.x.flags.writeable = False
        return self

    def invalidate_cache(self) -> None:
        """Drop memoized derived views and make ``x`` writable again."""
        self._derived_cache.clear()
        self.x = np.array(self.x)  # fresh writable buffer

    def _derived(self, key: str, fn) -> np.ndarray:
        if self.x.flags.writeable:
            return fn()  # mutable config: never cache
        out = self._derived_cache.get(key)
        if out is None:
            out = fn()
            out.flags.writeable = False
            self._derived_cache[key] = out
        return out

    def preseed_pair_capacity(self, C: np.ndarray) -> None:
        """Seed the ``pair_capacity`` cache from the demand an *exact*
        solver just realized (Thm 4.1: ``Σ_k x == C``), skipping the
        O(H·K·P²) reduction on every flow-model / ring-scoring read
        between reconfigurations.  Only meaningful on a frozen config;
        callers are the exact MDMCF paths.

        Deliberately seeds *only* ``pair_capacity`` (the slowdown
        re-evaluation hot path): ``realized``/``realized_bidirectional``
        — and therefore :func:`~repro_torch.core.reconfig.ltrr` — keep reducing
        the raw emitted circuits, so the LTRR benchmarks still measure
        realization rather than echo the asserted invariant.
        """
        if self.x.flags.writeable:
            return
        # integer sum first, tiny float divide after — no float64 copy of C
        seed = np.asarray(C).sum(axis=0) / max(1, self.num_groups)
        seed.flags.writeable = False
        self._derived_cache["pair_capacity"] = seed

    # ---- realized logical topology ---------------------------------------
    def realized(self) -> np.ndarray:
        """Directed link counts ``R[h, i, j] = Σ_k x[h][k][i, j]``."""
        return self._derived("realized", lambda: self.x.sum(axis=1))

    def realized_bidirectional(self) -> np.ndarray:
        """Bidirectional (L2-compatible) link counts per (h, i, j).

        A *logical* L2 link i↔j needs one i→j circuit and one j→i circuit.
        The number of bidirectional links is min(R_ij, R_ji) directionwise;
        with symmetric R this is just R.
        """

        def _compute() -> np.ndarray:
            r = self.realized().astype(np.int64)
            return np.minimum(r, np.transpose(r, (0, 2, 1)))

        return self._derived("realized_bidirectional", _compute)

    def pair_capacity(self) -> np.ndarray:
        """Per-group-average bidirectional link capacity between pod pairs
        — the ``(P, P)`` matrix the flow model and ring scoring share."""

        def _compute() -> np.ndarray:
            r = self.realized_bidirectional().astype(np.float64)
            return r.sum(axis=0) / max(1, self.num_groups)

        return self._derived("pair_capacity", _compute)

    def validate(self) -> None:
        """Assert per-OCS sub-permutation feasibility (constraints (4)(5))."""
        if self.x.min() < 0 or self.x.max() > 1:
            raise AssertionError("x must be binary")
        if (self.x.sum(axis=3) > 1).any():
            raise AssertionError("some OCS row sum > 1 (egress port reused)")
        if (self.x.sum(axis=2) > 1).any():
            raise AssertionError("some OCS col sum > 1 (ingress port reused)")

    def rewiring_distance(self, other: "OCSConfig") -> int:
        """Min-Rewiring objective (eq. 7): Σ |x - u| (= Σ x≠u for 0/1 x)."""
        return int(np.count_nonzero(self.x != other.x))

    def changed_pairs(self, other: "OCSConfig") -> FrozenSet[Tuple[int, int]]:
        """Pod pairs ``(i, j)`` (i ≤ j) whose circuits differ from ``other``
        anywhere in the OCS layer — every pair touched by the retune,
        additions included.  Prefer :meth:`dark_pairs` for pricing the
        switching window: a pair that only *gains* circuits keeps its
        surviving capacity live while the new ports tune."""
        diff = (self.x != other.x).any(axis=(0, 1))
        diff |= diff.T
        ii, jj = np.nonzero(np.triu(diff))
        return frozenset(zip(ii.tolist(), jj.tolist()))

    def dark_pairs(self, other: "OCSConfig") -> FrozenSet[Tuple[int, int]]:
        """Pod pairs that carry zero bandwidth while this configuration is
        being switched in from ``other`` (the fluid engine's dark set).

        The unit that retunes is the *circuit* (an OCS port), not the pod
        pair: a circuit occupying the same slot in both configurations
        never goes down, and keeps its pair alive through the window
        (make-before-break at port granularity).  A pair is dark only
        when the new configuration routes over it and **no** circuit
        survives in place — every circuit it will carry is still tuning.
        Pairs that merely gain extra circuits, or lose some while others
        stay put, keep serving; so the fabric that tracks demand with
        incremental deltas (``repro.core.incremental``, not ported) is not
        charged a dark window on capacity it was already serving.  Pairs
        the new configuration abandons entirely contribute zero capacity
        either way and are not in the set.
        """
        new_live = (self.x > 0).any(axis=(0, 1))
        new_live |= new_live.T
        survived = ((self.x > 0) & (other.x > 0)).any(axis=(0, 1))
        survived |= survived.T
        dark = new_live & ~survived
        ii, jj = np.nonzero(np.triu(dark))
        return frozenset(zip(ii.tolist(), jj.tolist()))


class PhysicalTopology:
    """Base class: a wiring between the spine layer and the OCS layer."""

    name = "abstract"

    def __init__(self, spec: ClusterSpec):
        self.spec = spec

    # Sub-classes define which directed circuits a single OCS may realize and
    # what the L2-compatibility constraint means for configurations.

    def l2_feasible(self, config: OCSConfig) -> bool:
        raise NotImplementedError


class CrossWiring(PhysicalTopology):
    """The paper's physical topology (§4.1).

    Port/OCS pairing: for even k, spine port pair ``(k, k+1)`` and OCS pair
    ``(k, k+1)`` in the same group are cross-connected:

    * egress of port k   → OCS k      ingress of port k+1 → OCS k
    * egress of port k+1 → OCS k+1    ingress of port k   → OCS k+1

    Consequence: if even OCS ``2t`` realizes the directed circuit set ``M``
    (a sub-permutation on pods) then the paired odd OCS ``2t+1`` attaches to
    the *same* spine port pairs mirrored, so realizing ``Mᵀ`` on it makes all
    circuits bidirectional at the port-pair granularity — L2 holds without
    constraining the *logical* matrix beyond symmetry.
    """

    name = "cross_wiring"

    def l2_feasible(self, config: OCSConfig) -> bool:
        """L2-compatibility (ILP eq. 6): odd OCS 2t+1 carries the transpose of
        even OCS 2t."""
        x = config.x
        even = x[:, 0::2]
        odd = x[:, 1::2]
        return bool((odd == np.transpose(even, (0, 1, 3, 2))).all())


class Uniform(PhysicalTopology):
    """Uniform bipartite wiring (Gemini / Jupiter Evolving; paper §2.3).

    Both Tx and Rx of spine port k land on OCS k, so a bidirectional logical
    link i↔j on OCS k consumes the full (ingress,egress) pair of pods i and j
    on that OCS: each per-OCS configuration must be a *symmetric matching*
    (x[h][k] symmetric with zero diagonal under L2).
    """

    name = "uniform"

    def l2_feasible(self, config: OCSConfig) -> bool:
        x = config.x
        sym = (x == np.transpose(x, (0, 1, 3, 2))).all()
        nodiag = (np.diagonal(x, axis1=2, axis2=3) == 0).all()
        return bool(sym and nodiag)


def demand_feasible(C: np.ndarray, spec: ClusterSpec) -> bool:
    """Check logical-topology feasibility conditions (11)(12) of the paper.

    ``C`` has shape ``(H, P, P)`` with ``C[h, i, j]`` = # of bidirectional
    links between the h-th spines of pods i and j.
    """
    if C.ndim != 3:
        raise ValueError("C must have shape (H, P, P)")
    sym = (C == np.transpose(C, (0, 2, 1))).all()
    deg = C.sum(axis=2)  # (H, P) row sums
    return bool(sym and (deg <= spec.k_spine).all() and (C >= 0).all())
