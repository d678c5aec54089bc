"""Sharding-spec rules for the paper's mesh (§3.1 containment policy): the
port's copy of ``repro.dist.sharding``'s rules.

The mesh axes mirror the cluster: ``model`` is the intra-pod electrical
domain (TP/EP), ``data``/``pod`` carry data parallelism across the OCS core.
Specs are derived *by name and shape*, never by architecture, from a small
stable vocabulary of leaf names (``wq``/``wk``/``wv``/``wi``/``wg``
column-parallel, ``wo``/``out_proj``/… row-parallel, MoE expert stacks), so
one rule set covers all 10 registered architectures.

The rules run on JAX's leaves: the ``"/"``-joined key and the global,
layer-stacked shape of each leaf of JAX's parameter tree
(``models.convert.jax_leaves`` maps the port's per-layer tensors onto
them).  So a rank's share of a leaf here is the slice that JAX's shard
holds at the same mesh coordinates.  A spec is a tuple with one entry a
dim: ``None``, an axis name, or a tuple of axis names.  The trees are
flat dicts ``{key: shape}`` → ``{key: spec}``.

Divisibility is checked per leaf: a dim that does not divide the axis size
degrades to replicated — a poor layout is acceptable, a failed step is not.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from ..launch.mesh import dp_axes, mesh_axis_sizes

Spec = Tuple[Any, ...]

# weights whose *input* dim is the sharded matmul dim (Megatron row-parallel:
# output projections, low-rank up-projections back to d_model)
_ROW_PARALLEL = frozenset(
    {"wo", "out_proj", "dt_proj", "ts_b", "w_b", "w2"}
)
# MoE expert-stacked weights: the leading expert dim rides the ``model`` axis
# (EP shares the in-pod electrical fabric with TP, configs/common.py)
_EXPERT_STACKED = frozenset({"wi", "wg", "wo"})


def _path_str(path: Sequence[Any]) -> str:
    """A tree path's parts → 'units/l0/mix/wq' (test vocabulary)."""
    return "/".join(str(p) for p in path)


def param_pspec(key: str, shape: Tuple[int, ...], model: int, is_moe: bool) -> Spec:
    """Spec of one parameter leaf for a ``model``-wide TP axis.

    ``key`` is the '/'-joined tree path; ``shape`` the *global* (possibly
    layer-stacked) shape.  Exactly one dim is sharded: the expert dim for
    MoE expert stacks, the input dim for row-parallel weights, the output
    dim otherwise.  Indivisible candidates degrade to replicated.
    """
    nd = len(shape)
    spec = [None] * nd
    if nd < 2 or model <= 0:
        return tuple(spec)
    parts = key.split("/")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""

    def ok(dim: int) -> bool:
        return shape[dim] > 0 and shape[dim] % model == 0

    # MoE expert stacks are 4-D when layer-stacked: (units, E, in, out)
    if is_moe and leaf in _EXPERT_STACKED and parent == "ffn" and nd >= 4:
        if ok(nd - 3):
            spec[nd - 3] = "model"
            return tuple(spec)

    if leaf in _ROW_PARALLEL or (leaf == "wv" and parent == "ffn"):
        cand = nd - 2  # rwkv channel-mix wv is (d_ff, d): row-parallel
    else:
        cand = nd - 1
    if ok(cand):
        spec[cand] = "model"
    return tuple(spec)


def param_specs(shapes: Mapping[str, Tuple[int, ...]], mesh, cfg,
                fsdp: bool = False) -> Dict[str, Spec]:
    """Spec of every leaf of a parameter (or same-shaped moment) tree."""
    if fsdp:
        raise NotImplementedError(
            "param_specs(fsdp=True): ZeRO-3 is not ported to repro_torch yet (ROADMAP A.9)")
    model = mesh_axis_sizes(mesh).get("model", 1)
    is_moe = getattr(cfg, "moe", None) is not None
    return {key: param_pspec(key, tuple(shape), model, is_moe) for key, shape in shapes.items()}


def zero1_dim(
    key: str,
    shape: Tuple[int, ...],
    model: int,
    data: int,
    is_moe: bool,
) -> Optional[int]:
    """Scatter dim for ZeRO-1: the first dim the TP spec leaves replicated
    that divides the DP width.  ``None`` → the leaf stays replicated (the
    optimizer update is redundantly computed, never wrong)."""
    if data <= 0:
        return None
    base = param_pspec(key, shape, model, is_moe)
    for d, size in enumerate(shape):
        if base[d] is None and size > 0 and size % data == 0:
            return d
    return None


def zero1_specs(shapes: Mapping[str, Tuple[int, ...]], mesh, cfg,
                use_pod: bool = False) -> Dict[str, Spec]:
    """Spec of every fp32 optimizer moment sharded over DP (ZeRO-1).

    ``use_pod`` additionally spreads the scatter dim over the ``pod`` axis
    (the ZeRO-3/fsdp layout, where the moments are the HBM bottleneck)."""
    sizes = mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    axes: Tuple[str, ...] = ("data",) if "data" in sizes else ()
    if use_pod and "pod" in sizes:
        axes = axes + ("pod",)
    total = 1
    for a in axes:
        total *= sizes[a]
    is_moe = getattr(cfg, "moe", None) is not None

    specs = {}
    for key, shape in shapes.items():
        shape = tuple(shape)
        base = list(param_pspec(key, shape, model, is_moe))
        if axes:
            d = zero1_dim(key, shape, model, total, is_moe)
            if d is not None:
                base[d] = axes if len(axes) > 1 else axes[0]
        specs[key] = tuple(base)
    return specs


def batch_specs(batch: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Batch leaves (arrays or shapes) shard dim 0 over the DP axes when
    divisible."""
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    total = 1
    for a in dp:
        total *= sizes[a]

    def spec(leaf) -> Spec:
        shape = tuple(getattr(leaf, "shape", leaf))
        if dp and len(shape) >= 1 and shape[0] > 0 and shape[0] % total == 0:
            return (dp if len(dp) > 1 else dp[0],)
        return ()

    return {k: spec(v) for k, v in batch.items()}
