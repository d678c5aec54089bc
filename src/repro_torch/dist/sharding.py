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

A rank of a ``model`` axis above 1 holds only its slice of each leaf: the
block at its ``model`` coordinate along :func:`model_dim` (``local_shape``,
``model_slice``), which the train step, the weight bridge and the
checkpoints share.  With ZeRO-3 (``fsdp``) a rank holds only a block of
that slice: the one at its DP index (:func:`dp_index`, ordered ``("pod",
"data")``) along :func:`fsdp_dim` (:func:`fsdp_slice`).

The serving cache has rules of its own (:func:`cache_specs`), run on JAX's
stacked cache leaves (``models.convert.cache_leaves``): its rows over the
DP axes, its heads (or ``head_dim``, or the MLA latents' sequence dim)
over ``model``.
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


def model_dim(key: str, shape: Tuple[int, ...], model: int, is_moe: bool) -> Optional[int]:
    """The dim of JAX leaf ``key`` (global stacked ``shape``) that
    ``param_pspec`` puts on ``model``, or None (whole on every rank)."""
    if model <= 1:
        return None
    spec = param_pspec(key, tuple(shape), model, is_moe)
    return next((d for d, a in enumerate(spec) if a == "model"), None)


def local_shape(key: str, shape: Tuple[int, ...], mesh, is_moe: bool) -> Tuple[int, ...]:
    """The shape of a rank's slice of JAX leaf ``key`` on ``mesh``'s
    ``model`` axis (``mesh`` a mesh or a ``{axis: size}`` dict)."""
    sizes = mesh if isinstance(mesh, Mapping) else mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    out = list(shape)
    d = model_dim(key, shape, model, is_moe)
    if d is not None:
        out[d] //= model
    return tuple(out)


def model_slice(key: str, shape: Tuple[int, ...], model: int, index: int,
                is_moe: bool) -> Tuple[slice, ...]:
    """The index of the slice of JAX leaf ``key`` that the rank at
    ``model`` coordinate ``index`` holds."""
    out = [slice(None)] * len(shape)
    d = model_dim(key, shape, model, is_moe)
    if d is not None:
        size = shape[d] // model
        out[d] = slice(index * size, (index + 1) * size)
    return tuple(out)


def param_specs(shapes: Mapping[str, Tuple[int, ...]], mesh, cfg,
                fsdp: bool = False) -> Dict[str, Spec]:
    """Spec of every leaf of a parameter (or same-shaped moment) tree.

    With ``fsdp`` (ZeRO-3) each leaf is also cut over the DP axes, ordered
    ``("pod", "data")``, on the dim :func:`zero1_dim` picks at their whole
    width (:func:`fsdp_dim` wherever there is more than one DP rank)."""
    sizes = mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    is_moe = getattr(cfg, "moe", None) is not None
    specs = {}
    for key, shape in shapes.items():
        shape = tuple(shape)
        base = list(param_pspec(key, shape, model, is_moe))
        if fsdp and dp:
            d = zero1_dim(key, shape, model, n_dp, is_moe)
            if d is not None:
                base[d] = dp if len(dp) > 1 else dp[0]
        specs[key] = tuple(base)
    return specs


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


def fsdp_dim(key: str, shape: Tuple[int, ...], model: int, n_dp: int,
             is_moe: bool) -> Optional[int]:
    """The dim of JAX leaf ``key`` (global stacked ``shape``) that ZeRO-3
    cuts over the ``n_dp`` ranks of the DP axes (None: whole on every DP
    rank): ``zero1_dim`` at the mesh's real ``model`` size.  On a stacked
    leaf, dim 0 is the layer (or unit) axis: a rank then holds whole layers."""
    return zero1_dim(key, shape, model, n_dp, is_moe) if n_dp > 1 else None


def dp_index(pod_idx: int, data_idx: int, data: int) -> int:
    """The block of the rank at (``pod_idx``, ``data_idx``) in a leaf cut
    over ``("pod", "data")``: the batch's rows (``batch_specs``) and the
    FSDP parameter blocks (``param_specs(fsdp=True)``), in the order of the
    ranks of the DP group."""
    return pod_idx * data + data_idx


def moment_index(pod_idx: int, data_idx: int, pod: int) -> int:
    """The block of the rank at (``pod_idx``, ``data_idx``) in JAX's FSDP
    moments, cut over ``("data", "pod")`` (``zero1_specs(use_pod=True)``).
    At ``pod`` > 1 it differs from :func:`dp_index`: the port keeps the
    moments in the parameters' blocks and permutes where JAX's shards are
    compared."""
    return data_idx * pod + pod_idx


def fsdp_slice(key: str, shape: Tuple[int, ...], model: int, n_dp: int, index: int,
               is_moe: bool) -> Tuple[slice, ...]:
    """The index of DP block ``index`` (:func:`dp_index`) inside a rank's
    ``model`` slice of JAX leaf ``key`` (global stacked ``shape``); every
    dim whole where the leaf has no :func:`fsdp_dim`."""
    local = list(shape)
    md = model_dim(key, shape, model, is_moe)
    if md is not None:
        local[md] //= model
    out = [slice(None)] * len(shape)
    d = fsdp_dim(key, tuple(shape), model, n_dp, is_moe)
    if d is not None:
        size = local[d] // n_dp
        out[d] = slice(index * size, (index + 1) * size)
    return tuple(out)


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


def cache_specs(shapes: Mapping[str, Tuple[int, ...]], mesh, cfg,
                seq_shard: bool = False) -> Dict[str, Spec]:
    """Spec of every leaf of JAX's serving cache (``{key: stacked shape}``,
    ``models.convert.cache_shapes``): the batch dim over the DP axes, then
    the first of the last two dims that divides ``model`` (kv heads, else
    ``head_dim``; on a rank-4 MLA latent, the sequence dim).  A leaf of
    rank 4 or more carries the leading layer or unit dim, so its batch dim
    is 1; ``seq_shard`` (a batch of 1 at long context) moves the DP cut to
    the dim after the batch.  ``cfg`` is taken for ``param_specs``'
    signature: the rules read shapes only."""
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    total = 1
    for a in dp:
        total *= sizes[a]

    def spec(shape: Tuple[int, ...]) -> Spec:
        nd = len(shape)
        out: list = [None] * nd
        if nd == 0:
            return ()
        bdim = 1 if nd >= 4 else 0
        if seq_shard and bdim + 1 < nd:
            bdim += 1
        if dp and shape[bdim] > 1 and shape[bdim] % total == 0:
            out[bdim] = dp if len(dp) > 1 else dp[0]
        if model > 1 and nd >= 2:
            for d in (nd - 2, nd - 1):
                if d != bdim and shape[d] > 0 and shape[d] % model == 0:
                    out[d] = "model"
                    break
        return tuple(out)

    return {k: spec(tuple(s)) for k, s in shapes.items()}


def spec_slice(spec: Spec, shape: Tuple[int, ...], sizes: Mapping[str, int],
               coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of the block of a leaf of ``shape`` cut as ``spec`` that
    the rank at mesh ``coords`` holds (``sizes``: the mesh's axis sizes):
    ``model`` at its ``model`` coordinate, the DP axes at its
    :func:`dp_index`, as ``model_slice`` and ``batch_specs`` place them."""
    out = []
    for n, a in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if a is None else (a,) if isinstance(a, str) else tuple(a)
        index, count = 0, 1
        for ax in axes:
            index, count = index * sizes[ax] + coords.get(ax, 0), count * sizes[ax]
        size = n // count
        out.append(slice(index * size, (index + 1) * size) if axes else slice(None))
    return tuple(out)


def rows_of(n: int, mesh) -> Tuple[int, int]:
    """(first row, rows) of this rank's block of a batch of ``n`` rows cut
    as :func:`batch_specs` cuts it: block :func:`dp_index` of ``n`` / the
    DP ranks, or every row where they do not divide ``n`` (the batch is
    then whole on every rank).  ``mesh`` is a built mesh."""
    dp = dp_axes(mesh)
    sizes = mesh_axis_sizes(mesh)
    total = 1
    for a in dp:
        total *= sizes[a]
    if not dp or n <= 0 or n % total:
        return 0, n
    coords = mesh.coords()
    index = dp_index(coords.get("pod", 0), coords.get("data", 0), sizes.get("data", 1))
    return index * (n // total), n // total
