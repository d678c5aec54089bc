"""Collectives over the ``model`` axis as autograd functions: the tensor and
expert parallelism of the train step at ``model`` > 1.

Layout (``dist.sharding``): each rank holds only the slice of every
parameter that JAX's ``param_pspec`` gives at its ``model`` coordinate.  The
model's modules (``models/layers.py``, ``attention.py``, ``moe.py``) compute
on those slices in one of two ways:

* *local* (Megatron): where a rank's slice is a whole set of heads, FFN
  columns, vocabulary rows or experts, the rank computes on it directly.
  The replicated residual stream enters through :func:`copy_to` (identity
  forward, all-reduce of the gradient backward) and the partial sums of a
  row-parallel product leave through :func:`reduce_from` (all-reduce
  forward, identity backward), or, where the rank goes on with its own
  columns of them, :func:`scatter_from` (reduce-scatter forward, all-gather
  of the gradient backward);
* *gathered*: where the slice is not such a set (kv heads cut inside
  ``head_dim``, norm scales and ``embed/tok`` cut along ``d_model``, the
  router's expert columns, MLA's down projections), the leaf is gathered
  whole at its use.  Used inside a local region, where each rank's
  gradient is a part of the whole one, the gather's backward is a
  reduce-scatter (:func:`gather`); used on the replicated residual stream,
  where every rank computes the whole gradient, it keeps the rank's own
  slice of it (:func:`gather_whole`) — a reduce-scatter there would add
  ``model`` copies of the same gradient.

Every function is the identity when ``axis`` is None, so the single-device
model runs unchanged.  Each collective counts its call and bytes (an
all-reduce's buffer, a reduce-scatter's input, an all-gather's output)
under ``"model"`` in ``axis.comm``, which the train step hands in as its
``comm``: the in-pod traffic that the paper keeps off the optical core.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# torch 2.13 names these ``*_single`` and deprecates the older names, which
# are the only ones before it
reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class ModelAxis:
    """One rank's place on the ``model`` axis: its ``size``, its ``index``
    (the rank's ``model`` coordinate) and the process ``group`` along it,
    with the ``comm`` dict that its collectives count into."""

    def __init__(self, size: int, index: int, group=None):
        if not 0 <= index < size:
            raise ValueError(f"model index {index} outside an axis of {size}")
        self.size, self.index, self.group = size, index, group
        self.comm: Dict[str, Dict[str, int]] = {}
        # set to a list to record (collective, shape, bytes) of each call
        self.log: Optional[List[Tuple[str, Tuple[int, ...], int]]] = None

    @classmethod
    def of(cls, mesh) -> Optional["ModelAxis"]:
        """The axis of a built mesh (``launch.mesh.make_mesh``), or None
        where its ``model`` axis is 1 or absent."""
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        if sizes.get("model", 1) <= 1:
            return None
        return cls(sizes["model"], mesh.coords()["model"], mesh.group("model"))

    def count(self, t: torch.Tensor, what: str) -> None:
        c = self.comm.setdefault("model", {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += t.numel() * t.element_size()
        if self.log is not None:
            self.log.append((what, tuple(t.shape), t.numel() * t.element_size()))

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` summed (or ``op``) over the axis, in place."""
        self.count(t, "all_reduce")
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The slices ``t`` of every rank joined along ``dim``, in rank order
        (contiguous: the kernels take contiguous rows)."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] * self.size,) + t.shape[1:])
        self.count(out, "all_gather")
        all_gather(out, t, group=self.group)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of ``t`` summed over the axis."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // self.size,) + t.shape[1:])
        self.count(t, "reduce_scatter")
        reduce_scatter(out, t, group=self.group)
        return out.movedim(0, dim).contiguous()

    def own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of a whole ``t`` along ``dim`` (no collective)."""
        size = t.shape[dim] // self.size
        return t.narrow(dim, self.index * size, size)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return axis.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_gather(g, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, whole):
        ctx.dim, ctx.axis, ctx.whole = dim, axis, whole
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        part = axis.own(g, dim).contiguous() if ctx.whole else axis.reduce_scatter(g, dim)
        return part, None, None, None


def copy_to(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """Identity forward, the gradient all-reduced over ``model`` backward:
    where the replicated residual stream enters a local region."""
    return x if axis is None else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """All-reduce over ``model`` forward, identity backward: the partial
    sums of a local region back onto the residual stream."""
    return x if axis is None else _ReduceFrom.apply(x, axis)


def scatter_from(x: torch.Tensor, dim: int, axis: Optional[ModelAxis]) -> torch.Tensor:
    """Reduce-scatter along ``dim`` forward, all-gather of the gradient
    backward: this rank's slice of the partial sums of a local region, for
    a use on that slice alone."""
    return x if axis is None else _ScatterFrom.apply(x, dim % x.dim(), axis)


def gather(x: torch.Tensor, dim: int, axis: Optional[ModelAxis]) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter of the gradient
    backward: a sliced leaf gathered for a use inside a local region."""
    return x if axis is None else _Gather.apply(x, dim % x.dim(), axis, False)


def gather_whole(x: torch.Tensor, dim: int, axis: Optional[ModelAxis]) -> torch.Tensor:
    """All-gather along ``dim`` forward, the rank's own slice of the
    (replicated) gradient backward: a sliced leaf or activation gathered
    for a use on the replicated residual stream."""
    return x if axis is None else _Gather.apply(x, dim % x.dim(), axis, True)


def whole(p: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """Parameter ``p`` whole for a use on the replicated residual stream:
    gathered where the rank holds a slice (``p.tp_dim``), else ``p``."""
    dim = getattr(p, "tp_dim", None)
    return p if axis is None or dim is None else gather_whole(p, dim, axis)


def partial(p: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """Parameter ``p`` whole for a use inside a local region, where each
    rank's gradient is a part: gathered with a reduce-scatter backward
    where the rank holds a slice, else with its gradient all-reduced."""
    if axis is None:
        return p
    dim = getattr(p, "tp_dim", None)
    return copy_to(p, axis) if dim is None else gather(p, dim, axis)


def sliced(p: torch.Tensor, dim: int) -> bool:
    """Whether the rank holds ``p`` cut along ``dim`` (its port dim)."""
    return getattr(p, "tp_dim", None) == dim % p.dim()


def axis_of(module) -> Optional[ModelAxis]:
    """The model axis a module was built for (None: the whole model)."""
    return getattr(module, "tp", None)
