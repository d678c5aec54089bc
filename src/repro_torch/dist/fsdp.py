"""ZeRO-3 (``fsdp``) over the data axes: a rank holds a block of each
parameter, and each layer's parameters are gathered whole just before the
layer runs.

Layout (``dist.sharding.param_specs(fsdp=True)``): on top of its ``model``
slice, each leaf is cut over the DP group (``pod`` × ``data``, ordered
``("pod", "data")``: block ``pod_idx * data + data_idx``, the order of the
group's ranks) along ``fsdp_dim``, the dim ``zero1_dim`` picks on JAX's
layer-stacked shape.  In the port's per-layer tensors that is one of two
cuts (``models.convert.fsdp_cuts``):

* inside the layer (gemma2-9b: ``d_model``; the embedding's vocabulary
  rows): every rank holds a block of every layer's tensor
  (``p.fsdp_dim``).  Gathered by an all-gather; the gradient goes back by
  a reduce-scatter, in fp32;
* along the stacked layer axis (olmo-1b, qwen2.5-14b, deepseek-v3's MoE
  units at data 2): a rank holds whole layers, the layers of its block, and
  an empty tensor for every other layer (``p.fsdp_owner``, the DP index of
  the layer's owner).  Gathered by a broadcast from the owner; the
  gradient goes back by a reduce to the owner, in fp32.

A leaf with no such dim (the stacked norm scales of gemma2-9b) stays whole
on every rank; the train step all-reduces its gradient.  ``p.fsdp_shape``
is the shape of the gathered tensor: the rank's ``model`` slice of the
layer's tensor, which keeps the block's ``tp_dim`` for the model axis's
collectives (``dist.tensor_parallel``).

:func:`gathered` swaps a module's blocks for their gathered tensors for the
length of a ``with`` block.  Every family gathers each module just before
its use: the decoder each layer (dense, MoE, rwkv or Mamba), the embedding
and the final norm (``models.transformer``); whisper each encoder and
decoder layer, its two LayerNorms and its ``tok`` and ``pos`` tables
(``models.whisper``); the VLM its projector and its LM's table for the
text (``models.vlm``); and the fused loss the tied table again.  A
gathered tensor keeps its leaf's dtype, so an fp32 leaf (Mamba's
``A_log``, rwkv's ``u``) is gathered and its gradient reduced in fp32.  The
gathered tensors that the layer's backward needs are kept by autograd until
then (not gathered again), so between the forward and the backward a rank
holds the whole model's weights once; the blocks, the moments and the
gradients stay cut.

Each collective counts its call and bytes (an all-gather's output, a
reduce-scatter's input, a broadcast's or a reduce's buffer) under the DP
group's name in ``axis.comm``, which the train step hands in as its
``comm``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .tensor_parallel import all_gather, reduce_scatter

# how ZeRO-3 cuts a tensor: (its dim, None), or (None, the DP index that
# holds the whole layer)
Cut = Tuple[Optional[int], Optional[int]]


class DPAxis:
    """One rank's place in the DP group of a mesh: its ``size`` (pod ×
    data), its ``index`` (``dist.sharding.dp_index``), the process
    ``group``, the global rank of each index (``ranks``, for a broadcast's
    source and a reduce's destination) and ``name``, the key its
    collectives count under in ``comm``."""

    def __init__(self, size: int, index: int, group, ranks: List[int], name: str):
        if not 0 <= index < size or len(ranks) != size:
            raise ValueError(f"DP index {index} outside a group of {size} ({ranks})")
        self.size, self.index, self.group, self.ranks, self.name = size, index, group, ranks, name
        self.comm: Dict[str, Dict[str, int]] = {}

    @classmethod
    def of(cls, mesh) -> "DPAxis":
        """The DP group of a built mesh (``launch.mesh.make_mesh``) at this
        rank's ``model`` coordinate."""
        axes = [a for a in mesh.axis_names if a in ("pod", "data")]
        if not axes:
            raise ValueError(f"the mesh {mesh.axis_names} has no data axis")
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        coords = mesh.coords()
        ranks = np.arange(int(np.prod(mesh.shape))).reshape(mesh.shape)
        if "model" in sizes:  # the ranks of this model coordinate
            ranks = np.take(ranks, coords["model"], axis=mesh.axis_names.index("model"))
        ranks = ranks.ravel().tolist()
        index = coords.get("pod", 0) * sizes["data"] + coords["data"]
        if len(axes) == 1:
            group = mesh.group(axes[0])
        else:
            group = mesh.dp_group if sizes.get("model", 1) > 1 else dist.group.WORLD
        return cls(len(ranks), index, group, ranks, "+".join(axes))

    def count(self, t: torch.Tensor) -> None:
        c = self.comm.setdefault(self.name, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += t.numel() * t.element_size()


class _AllGather(torch.autograd.Function):
    """The blocks joined along ``dim`` in DP order; backward, the rank's
    block of the gradient summed over the group (fp32)."""

    @staticmethod
    def forward(ctx, block, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        t = block.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] * axis.size,) + t.shape[1:])
        axis.count(out)
        all_gather(out, t, group=axis.group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        t = g.float().movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // axis.size,) + t.shape[1:])
        axis.count(t)
        reduce_scatter(out, t, group=axis.group)
        return out.movedim(0, dim), None, None


class _FromOwner(torch.autograd.Function):
    """A whole layer's tensor broadcast from the rank that holds it;
    backward, the gradient summed onto that rank (fp32; the others get the
    empty gradient of their empty block)."""

    @staticmethod
    def forward(ctx, block, owner, shape, axis):
        ctx.owner, ctx.axis = owner, axis
        mine = owner == axis.index
        out = block.detach() if mine else block.new_empty(shape)  # the root only sends
        axis.count(out)
        dist.broadcast(out, src=axis.ranks[owner], group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        axis, owner = ctx.axis, ctx.owner
        t = g.float().contiguous()
        axis.count(t)
        dist.reduce(t, dst=axis.ranks[owner], group=axis.group)
        return (t if owner == axis.index else t.new_empty((0,))), None, None, None


def gather(p: torch.Tensor, axis: DPAxis) -> torch.Tensor:
    """Parameter block ``p`` gathered whole (its ``fsdp_shape``), with the
    gradient's way back; ``p`` itself where the rank holds it whole."""
    if not hasattr(p, "fsdp_shape"):
        return p
    if p.fsdp_dim is not None:
        full = _AllGather.apply(p, p.fsdp_dim, axis)
    else:
        full = _FromOwner.apply(p, p.fsdp_owner, p.fsdp_shape, axis)
    full.tp_dim = getattr(p, "tp_dim", None)
    return full


_NULL = contextlib.nullcontext()


def gathered(module: torch.nn.Module, names: Optional[Sequence[str]] = None):
    """A context in which ``module``'s parameters (its submodules' too), or
    only its own parameters ``names`` (whisper's ``tok`` and ``pos``, held
    by the root beside its layers), are gathered whole (:func:`gather`); a
    no-op context for a module built without ``fsdp``."""
    axis = getattr(module, "fsdp", None)
    return _NULL if axis is None else _swapped(module, axis, names)


@contextlib.contextmanager
def _swapped(module: torch.nn.Module, axis: DPAxis, names: Optional[Sequence[str]]):
    swaps: List[Tuple[torch.nn.Module, str, torch.nn.Parameter]] = []
    try:
        for mod in module.modules() if names is None else (module,):
            for name, p in list(mod._parameters.items()):
                if p is None or not hasattr(p, "fsdp_shape") or (names is not None
                                                                  and name not in names):
                    continue
                full = gather(p, axis)
                del mod._parameters[name]
                swaps.append((mod, name, p))
                mod.__dict__[name] = full  # a plain attribute while the block is away
        yield module
    finally:
        for mod, name, p in reversed(swaps):
            mod.__dict__.pop(name, None)
            mod._parameters[name] = p


def cut_of(p: torch.Tensor) -> Optional[Cut]:
    """The cut of block parameter ``p`` (``models.convert.fsdp_cuts``), or
    None where the rank holds it whole."""
    return (p.fsdp_dim, p.fsdp_owner) if hasattr(p, "fsdp_shape") else None


def block(part: torch.Tensor, cut: Optional[Cut], axis: Optional[DPAxis]) -> torch.Tensor:
    """The rank's block of ``part``, a whole ``model`` slice of a tensor cut
    as ``cut``: a view of it, or an empty tensor where the rank does not
    own the layer."""
    if axis is None or cut is None:
        return part
    dim, owner = cut
    if dim is not None:
        size = part.shape[dim] // axis.size
        return part.narrow(dim, axis.index * size, size)
    return part if owner == axis.index else part.new_empty((0,))
