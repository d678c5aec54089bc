"""The train steps (the PyTorch twin of ``repro.train.trainstep``).

One step is: the loss of the model's family (``models.registry.loss_fn``:
``lm_loss``, ``whisper_loss`` or ``vlm_loss``, as JAX's ``api.loss``) and its
gradients, summed over ``grad_accum`` microbatches as ``_accum_grads`` does
in JAX, then one AdamW update of the model's parameters in place.  On the
card the model's forward runs the flash attention and RMSNorm kernels (the
attention families, whisper and the VLM), the WKV6 kernel (rwkv6) or, in
jamba's Mamba layers, the selective-scan kernel, and autograd runs their
backward kernels.  Every family trains.

:func:`train_step` is the single-device step; of :class:`TrainHparams` it
honours ``grad_accum`` only, and the distributed flags raise there.

:func:`make_train_step` builds the distributed steps over a mesh
(``launch.mesh``: ``pod`` × ``data`` × ``model``), one process a rank.
Over ``model`` the model is tensor and expert parallel
(``dist.tensor_parallel``, ``models.registry.get_api(mesh=)``): each rank
holds JAX's ``param_pspec`` slice of every leaf and the forward and
backward run the model axis's collectives.  Over the data axes each
rank holds the same slices as the others at its ``model`` coordinate:

* the flat baseline (JAX's ``make_pjit_step``, the paper-faithful data
  plane): one all-reduce of each gradient over pod × data, the mean, then
  AdamW as :func:`~repro_torch.train.optimizer.adamw_update` computes it;
* the hierarchical step (JAX's ``make_hierarchical_step``), leaf by leaf:
  reduce-scatter over ``data`` along the leaf's ZeRO-1 dim (all-reduce
  where it has none), then over ``pod`` an all-reduce, with ``compress``
  of int8 values (JAX's quantizer, summed as int32: the cross-pod bytes
  equal fp32's, as in JAX), the mean, the global norm from the shards,
  AdamW on the shard and an all-gather over ``data``.

With ``zero1`` (always in the hierarchical step) each rank keeps the AdamW
moments of its slice only: the moments are keyed by JAX's leaf keys and
cut along JAX's layer-stacked shapes (``dist.sharding.zero1_specs``), so a
rank's shard is JAX's shard at the same mesh coordinates: its ``model``
slice cut again over ``data`` (``zero1_dim`` at the mesh's real ``model``
size).  The global gradient norm sums each model-cut leaf's squares over
``model`` and counts each whole leaf once, as JAX's ``global_norm`` over
the global arrays; ``compress``'s scale is the leaf's max over ``model``
and ``pod``.  Each rank takes the row block ``pod_idx * data + data_idx``
of the global batch (``batch_specs``); the ranks of one ``model`` group
take the same rows.  The MoE families route each rank's tokens apart, in both
steps, as JAX's hierarchical step does; JAX's flat step routes the global
batch as one under GSPMD, which a data-parallel step cannot without moving
activations.

On the CPU (gloo), four ranks:
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu \
      --hierarchical --zero1 --compress --steps 4
On the card (NCCL, one card a rank): the same without ``--device cpu``;
``chip_smoke.py`` runs it at world 1 and, on a host of several cards, over
them.  With tensor parallelism, qwen2.5-14b on 4 cards:
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen2.5-14b --model 4 --hierarchical --zero1
With ``fsdp`` (ZeRO-3, ``dist.fsdp``; the api from ``get_api(cfg, device,
mesh=mesh, fsdp=True)``) each rank holds only its block of each leaf's
``model`` slice over pod x data (``fsdp_dim``, block ``pod_idx * data +
data_idx``) and the moments of that block: the decoder gathers each layer
as it runs and the gather's backward sums the gradient into the blocks,
so the step all-reduces only the whole leaves' gradients, sums the
blocks' squares over pod x data for the norm and runs AdamW on the
blocks, with no gather after it.  JAX cuts its FSDP moments in ``("data",
"pod")`` order (``zero1_specs(use_pod=True)``); the port keeps them in the
parameters' ``("pod", "data")`` blocks, and a checkpoint gathers both
whole.  The hierarchical step with ``fsdp`` adds the cross-pod pass at
pod 1; across pods it raises (JAX's fails there: ROADMAP C.9).  On 4
cards:
  python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --arch gemma2-9b --fsdp --batch 8 --seq 1024
Every family takes a ``model`` axis (rwkv6 head-parallel, jamba's Mamba
mixers channel-parallel, whisper and the VLM as the attention families)
and ``fsdp`` (each family gathers its modules' blocks just before their
use: ``models.transformer``, ``models.whisper``, ``models.vlm``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..dist import fsdp
from ..dist.sharding import (batch_specs, dp_index, fsdp_dim, local_shape, model_dim,
                             zero1_dim)
from ..dist.tensor_parallel import all_gather as _all_gather
from ..dist.tensor_parallel import reduce_scatter as _reduce_scatter
from ..launch.mesh import dp_axes, mesh_axis_sizes
from ..models.convert import fsdp_cuts, params_from_jax, stacked_shapes
from ..models.registry import loss_fn
from .optimizer import (OptConfig, adamw_init, adamw_leaf, adamw_update, bias_corrections,
                        clip_scale, schedule)


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    grad_accum: int = 1
    hierarchical: bool = False  # hierarchical collectives (make_train_step)
    compress: bool = False  # int8 cross-pod gradient compression (hierarchical step)
    zero1: bool = False  # shard optimizer state over data axis (make_train_step)
    fsdp: bool = False  # ZeRO-3: shard params over the DP axes; gather per layer


def _check_hparams(hp: TrainHparams, mesh: bool = False) -> None:
    """Refuse the distributed flags without a ``mesh``."""
    for flag in () if mesh else ("hierarchical", "compress", "zero1", "fsdp"):
        if getattr(hp, flag):
            raise NotImplementedError(
                f"TrainHparams.{flag} needs a mesh: build the distributed step with "
                "make_train_step (ROADMAP A.7); train_step runs on one device")
    if hp.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, not {hp.grad_accum}")


def make_train_state(api, seed: int = 0) -> dict:
    """{"model": random weights from ``api.init(seed)``, "opt": AdamW state}."""
    model = api.init(seed)
    return {"model": model, "opt": adamw_init(model)}


def batch_to_torch(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``SyntheticData.batch_at``) as tensors on ``device``:
    integer entries (``tokens``, ``targets``) as int64, floating ones
    (``frames``, ``patches``, a float ``mask``) as float32."""
    def cast(v):
        v = np.asarray(v)
        return v.astype(np.float32 if np.issubdtype(v.dtype, np.floating) else np.int64)
    return {k: torch.from_numpy(cast(v)).to(device) for k, v in batch.items()}


def _accum_grads(model: nn.Module, batch: Mapping[str, torch.Tensor], n_micro: int):
    """(loss, {name: grad}) of the model's family loss over ``n_micro``
    microbatches: every entry of the batch split by rows, in order; the loss
    and each gradient are summed as ``x / n_micro`` into fp32, as JAX's
    ``lax.scan`` does.  With one microbatch the gradients keep the param
    dtype, as in JAX.  A parameter the loss does not read gets a zero
    gradient, as in JAX."""
    loss_of = loss_fn(model.cfg)
    names, params = zip(*model.named_parameters())
    if n_micro <= 1:
        loss = loss_of(model, batch)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.detach(), dict(zip(names, grads))
    rows = next(iter(batch.values())).shape[0]
    if rows % n_micro:
        raise ValueError(f"batch of {rows} rows does not split into {n_micro} microbatches")
    mb = rows // n_micro
    loss_acc = torch.zeros((), dtype=torch.float32, device=params[0].device)
    g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in zip(names, params)}
    for i in range(n_micro):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss = loss_of(model, micro)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        loss_acc = loss_acc + loss.detach() / n_micro
        for n, g in zip(names, grads):
            g_acc[n].add_(g / n_micro)
        del loss, grads
    return loss_acc, g_acc


def train_step(model: nn.Module, opt_state: dict, batch: Mapping[str, torch.Tensor],
               opt: OptConfig, hp: TrainHparams = TrainHparams()) -> Dict[str, torch.Tensor]:
    """One AdamW step on ``model`` and ``opt_state``, in place.  Returns
    ``{"loss", "lr", "grad_norm"}`` as 0-dim tensors (no host sync)."""
    _check_hparams(hp)
    loss, grads = _accum_grads(model, batch, hp.grad_accum)
    metrics = adamw_update(model, grads, opt_state, opt)
    metrics["loss"] = loss
    return metrics


# ---------------------------------------------------------------------------
# distributed steps over the data axes
# ---------------------------------------------------------------------------

def quantize_int8(gs: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """JAX's cross-pod quantizer: round(gs / scale * 127) (half to even, as
    ``jnp.round``), clipped to [-127, 127], as the int32 that is summed."""
    return torch.clamp(torch.round(gs / scale * 127.0), -127, 127).to(torch.int32)


class MeshStep:
    """The distributed train step of :func:`make_train_step`:
    ``step(state, batch)`` takes the global batch, trains ``state`` in place
    and returns ``{"loss", "lr", "grad_norm"}`` (0-dim tensors, the same on
    every rank).  ``init_state(seed)`` builds the state: this rank's model
    (its ``model`` slices of every leaf, on ``mesh.device``; under ``fsdp``
    its blocks of them) and its AdamW moments.  ``api`` must come from
    ``get_api(cfg, device, mesh=mesh)`` where the mesh's ``model`` axis is
    above 1, and with ``fsdp=True`` under ``hp.fsdp``.

    ``leaves`` maps each JAX key to its port names (``jax_leaves``),
    ``shapes`` to its global stacked shape, ``mdims`` to the dim the
    ``model`` axis cuts (None: whole on every rank) and ``local`` to the
    shape of this rank's slice, ``dims`` to the dim its moments are cut
    along over ``data`` (None: whole), which is where ``zero1_specs`` puts
    ``"data"``; under ``fsdp``, ``dims`` is the dim that cuts both the
    parameters and the moments over the whole DP group (``fsdp_dim``), and
    ``names`` maps each key to the port names of this rank's block (the
    layers it owns where the stacked layer axis is cut).
    ``comm`` counts the last step's collectives per axis (``"data"``,
    ``"pod"``, ``"model"`` — the forward's and backward's as well as the
    step's —, and ``"pod+data"`` for the groups over both, where ZeRO-3's
    gathers count): calls, and bytes as the sizes of the tensors handed in
    (a reduce-scatter's input, an all-reduce's buffer, an all-gather's
    output)."""

    def __init__(self, api, cfg, opt: OptConfig, mesh, hp: TrainHparams, batch_shape):
        _check_hparams(hp, mesh=True)
        sizes = mesh_axis_sizes(mesh)
        if "data" not in sizes:
            raise ValueError(f"the mesh {mesh.axis_names} has no data axis")
        if hp.fsdp and hp.hierarchical and sizes.get("pod", 1) > 1:
            raise NotImplementedError(
                "the hierarchical step with fsdp across pods: JAX's reference fails there "
                "(its moments are cut over data x pod, its gradients over data alone; "
                "ROADMAP C.9)")
        self.model = sizes.get("model", 1)
        self.axis, self.fsdp = api.axis, api.dp
        if (self.axis.size if self.axis is not None else 1) != self.model:
            raise ValueError(f"the mesh's model axis is {self.model}: build the api with "
                             "get_api(cfg, device, mesh=mesh)")
        if (self.fsdp is not None) != hp.fsdp:
            raise ValueError(f"TrainHparams.fsdp is {hp.fsdp}: build the api with "
                             f"get_api(cfg, device, mesh=mesh, fsdp={hp.fsdp})")
        self.api, self.cfg, self.opt, self.mesh, self.hp = api, cfg, opt, mesh, hp
        self.dp = dp_axes(mesh)
        self.data, self.pod = sizes["data"], sizes.get("pod", 1)
        self.n_dp = self.data * self.pod

        is_moe = cfg.moe is not None
        self.leaves, self.shapes = stacked_shapes(cfg)
        self.mdims = {k: model_dim(k, s, self.model, is_moe) for k, s in self.shapes.items()}
        self.local = {k: local_shape(k, s, sizes, is_moe) for k, s in self.shapes.items()}
        coords = mesh.coords()
        self.data_idx, self.model_idx = coords["data"], coords.get("model", 0)
        self.dp_idx = dp_index(coords.get("pod", 0), self.data_idx, self.data)
        dpname = "+".join(self.dp)
        if hp.fsdp:  # parameters and moments in the same blocks over pod x data
            self.dims = {k: fsdp_dim(k, s, self.model, self.n_dp, is_moe)
                         for k, s in self.shapes.items()}
            self.cut_axis, self.cut_n, self.cut_idx = dpname, self.n_dp, self.dp_idx
        else:
            sharded = hp.zero1 or hp.hierarchical  # JAX: zero1 specs for either
            self.dims = {k: zero1_dim(k, s, self.model, self.data, is_moe) if sharded else None
                         for k, s in self.shapes.items()}
            self.cut_axis, self.cut_n, self.cut_idx = "data", self.data, self.data_idx
        self.names = {k: self._block_names(k) for k in self.leaves}
        self.cuts = fsdp_cuts(cfg, self.model, self.n_dp) if hp.fsdp else {}
        self.batch_specs = batch_specs(batch_shape, mesh)
        self.batch_rows = {k: tuple(getattr(v, "shape", v))[0] for k, v in batch_shape.items()}

        self.groups = {a: mesh.group(a) for a in self.dp}
        # the group over pod x data: the world at model 1, else this model
        # coordinate's (a single data axis is its own group)
        self.groups.setdefault(dpname, mesh.dp_group if self.model > 1 else dist.group.WORLD)
        if self.model > 1:
            self.groups["model"] = mesh.group("model")
        self.sizes = {"data": self.data, "pod": self.pod, dpname: self.n_dp, "model": self.model}
        # the rank at pod 0, data 0 of this rank's model coordinate
        self.dp_src = int(np.ravel_multi_index(
            [coords[a] if a == "model" else 0 for a in mesh.axis_names], mesh.shape))
        self.comm: Dict[str, Dict[str, int]] = {}

    # ---- layout ----------------------------------------------------------
    def _block_names(self, key: str):
        """The port names of this rank's block of JAX leaf ``key``: the
        layers it owns where ZeRO-3 cuts the stacked layer axis."""
        names = self.leaves[key]
        if self.hp.fsdp and isinstance(names, tuple) and self.dims[key] == 0:
            per = len(names) // self.n_dp
            return names[self.dp_idx * per:(self.dp_idx + 1) * per]
        return names

    def _cut(self, key: str, local: torch.Tensor) -> torch.Tensor:
        """This rank's block of its ``model`` slice ``local`` (a view): its
        ``data`` slice (ZeRO-1), or its DP block (ZeRO-3)."""
        dim = self.dims[key]
        if dim is None:
            return local
        size = local.shape[dim] // self.cut_n
        return local.narrow(dim, self.cut_idx * size, size)

    def model_slice(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's ``model`` slice of JAX leaf ``key`` (a view of ``whole``)."""
        dim = self.mdims[key]
        if dim is None:
            return whole
        size = whole.shape[dim] // self.model
        return whole.narrow(dim, self.model_idx * size, size)

    def shard(self, key: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of JAX leaf ``key``'s moments (a view of
        ``whole``): its ``model`` slice cut over ``data`` (over pod x data
        under ``fsdp``)."""
        return self._cut(key, self.model_slice(key, whole))

    def gather_model(self, key: str, local: torch.Tensor) -> torch.Tensor:
        """JAX leaf ``key`` whole from every rank's ``model`` slice ``local``
        (a collective over ``model`` where the leaf is cut)."""
        dim = self.mdims[key]
        return local if dim is None else self._gather(local, dim, "model", count=False)

    def gather(self, key: str, shard: torch.Tensor) -> torch.Tensor:
        """JAX leaf ``key`` whole from every rank's moment ``shard`` (or,
        under ``fsdp``, parameter block): a collective over ``data`` (pod x
        data) and one over ``model`` where the leaf is cut."""
        dim = self.dims[key]
        local = shard if dim is None else self._gather(shard, dim, self.cut_axis, count=False)
        return self.gather_model(key, local)

    def param(self, params: Mapping[str, torch.Tensor], key: str) -> torch.Tensor:
        """This rank's part of JAX leaf ``key`` from the model's named
        ``params``, stacked along the layer axis: its ``model`` slice, or
        under ``fsdp`` its block of it."""
        return self._stacked(params, self.names[key])

    def whole_param(self, key: str, part: torch.Tensor) -> torch.Tensor:
        """JAX leaf ``key`` whole from every rank's :meth:`param`."""
        return self.gather(key, part) if self.hp.fsdp else self.gather_model(key, part)

    def param_state(self, flat: Mapping[str, Any], dtype=None) -> Dict[str, torch.Tensor]:
        """The state dict of this rank's model from JAX's flat
        ``params/...`` leaves (numpy, whole): its ``model`` slices, and
        under ``fsdp`` its blocks of them (empty where it owns no layer)."""
        state = params_from_jax(flat, self.cfg, dtype, model=self.model, index=self.model_idx)
        if self.hp.fsdp:
            state = {n: fsdp.block(t, self.cuts[n], self.fsdp).clone() for n, t in state.items()}
        return state

    def init_opt(self) -> dict:
        """Zero fp32 moments of this rank's slices and step 0."""
        dev = self.mesh.device

        def zeros():
            out = {}
            for k, shape in self.local.items():
                shape, dim = list(shape), self.dims[k]
                if dim is not None:
                    shape[dim] //= self.cut_n
                out[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
            return out

        return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def init_state(self, seed: int = 0) -> dict:
        """{"model": ``api.init(seed)`` — at ``model`` > 1 this rank's slices
        of the weights ``init(seed)`` gives the whole model, under ``fsdp``
        its blocks of them —, without ``fsdp`` the weights of the rank at
        pod 0, data 0 on every rank of its ``model`` coordinate, "opt":
        :meth:`init_opt`}."""
        dev, want = self.api.device, self.mesh.device
        if dev.type != want.type or dev.index not in (None, want.index):
            raise ValueError(f"the model's device {dev} is not the mesh's {want}")
        model = self.api.init(seed)
        if self.n_dp > 1 and not self.hp.fsdp:
            with torch.no_grad():
                for p in model.parameters():
                    dist.broadcast(p, src=self.dp_src, group=self.groups["+".join(self.dp)])
        return {"model": model, "opt": self.init_opt()}

    def local_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """This rank's rows of the global ``batch``: the block ``dp_idx`` of
        each entry that ``batch_specs`` shards, the whole entry otherwise."""
        out = {}
        for k, v in batch.items():
            if v.shape[0] != self.batch_rows[k]:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows; the step was built "
                                 f"for {self.batch_rows[k]}")
            if self.batch_specs[k]:
                rows = v.shape[0] // self.n_dp
                v = v[self.dp_idx * rows:(self.dp_idx + 1) * rows]
            out[k] = v
        return out

    # ---- collectives -----------------------------------------------------
    def _count(self, axis: str, t: torch.Tensor) -> None:
        c = self.comm.setdefault(axis, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += t.numel() * t.element_size()

    def _all_reduce(self, t: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        self._count(axis, t)
        dist.all_reduce(t, op=op, group=self.groups[axis])
        return t

    def _scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Reduce-scatter over ``data`` along ``dim`` (moved to the front:
        the collective splits dim 0), contiguous: NCCL's cross-pod
        all-reduce that follows takes no strided tensor."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // self.data,) + t.shape[1:])
        self._count("data", t)
        _reduce_scatter(out, t, group=self.groups["data"])
        return out.movedim(0, dim).contiguous()

    def _gather(self, t: torch.Tensor, dim: int, axis: str = "data",
                count: bool = True) -> torch.Tensor:
        """All-gather over ``axis`` (``data``, the DP group or ``model``)
        along ``dim`` (counted in ``comm`` inside the step)."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] * self.sizes[axis],) + t.shape[1:])
        if count:
            self._count(axis, out)
        _all_gather(out, t, group=self.groups[axis])
        return out.movedim(0, dim)

    def _cross_pod(self, gs: torch.Tensor, key: str) -> torch.Tensor:
        """The sum over ``pod``: plain, or of JAX's int8 values as int32 with
        the scale of the leaf's max over ``model`` and ``pod``."""
        if not self.hp.compress:
            return self._all_reduce(gs, "pod")
        amax = gs.abs().max()
        if self.mdims[key] is not None:
            amax = self._all_reduce(amax, "model", op=dist.ReduceOp.MAX)
        amax = self._all_reduce(amax, "pod", op=dist.ReduceOp.MAX)
        scale = torch.clamp(amax, min=1e-12)
        q = self._all_reduce(quantize_int8(gs, scale), "pod")
        return q.to(torch.float32) * (scale / 127.0)

    def _sum_over(self, parts: list, which: list, axis: str) -> None:
        """Sum ``parts[i]`` over ``axis`` for each i in ``which``, in one
        all-reduce."""
        if which:
            summed = self._all_reduce(torch.stack([parts[i] for i in which]), axis)
            for j, i in enumerate(which):
                parts[i] = summed[j]

    # ---- the step --------------------------------------------------------
    @staticmethod
    def _stacked(tensors: Mapping[str, torch.Tensor], names, pop: bool = False):
        get = tensors.pop if pop else tensors.__getitem__
        return torch.stack([get(n) for n in names]) if isinstance(names, tuple) else get(names)

    def _reduced(self, grads: Dict[str, torch.Tensor], key: str):
        """(the mean gradient over the DP group of this rank's part of leaf
        ``key`` — the whole leaf in the flat step without ``fsdp`` —,
        whether that part is cut, so that the global norm sums its squares
        over DP).  Under ``fsdp`` the gather's backward has summed a cut
        leaf's gradient into its block already."""
        hp, dp = self.hp, "+".join(self.dp)
        dim = self.dims[key]
        g = self._stacked(grads, self.names[key], pop=True).float()
        if hp.fsdp:
            gs = g if dim is not None else self._all_reduce(g, dp)
        elif hp.hierarchical:
            gs = self._scatter(g, dim) if dim is not None else self._all_reduce(g, "data")
        else:  # flat: the whole gradient, then this rank's slice
            gs = self._all_reduce(g, dp)
        if hp.hierarchical and "pod" in self.groups:
            gs = self._cross_pod(gs, key)
        return gs / self.n_dp, dim is not None and (hp.fsdp or hp.hierarchical)

    def __call__(self, state: dict, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model, st, hp = state["model"], state["opt"], self.hp
        self.comm = {}
        for axis in (self.axis, self.fsdp):  # the forward's and backward's collectives
            if axis is not None:
                axis.comm = self.comm
        loss, grads = _accum_grads(model, self.local_batch(batch), hp.grad_accum)
        dp = "+".join(self.dp)
        loss = self._all_reduce(loss.float().clone(), dp) / self.n_dp
        with torch.no_grad():
            shards, parts, cut = {}, [], []
            for key in self.dims:
                gs, scattered = self._reduced(grads, key)
                parts.append(torch.sum(gs * gs))
                cut.append(scattered)
                # the flat step's ZeRO-1: this rank's slice of the whole gradient
                flat_cut = not (hp.fsdp or hp.hierarchical) and self.dims[key] is not None
                shards[key] = self._cut(key, gs).clone() if flat_cut else gs
                del gs
            # the squares summed over the DP axes where the leaf is cut there,
            # then over model where it is cut: each whole leaf counts once
            self._sum_over(parts, [i for i, c in enumerate(cut) if c], self.cut_axis)
            self._sum_over(parts, [i for i, k in enumerate(self.dims)
                                   if self.mdims[k] is not None], "model")
            sq = torch.zeros((), dtype=torch.float32, device=loss.device)
            for part in parts:  # JAX's order of leaves
                sq = sq + part
            gnorm = torch.sqrt(sq)
            clip = clip_scale(self.opt, gnorm)
            step = st["step"]
            lr, bc = schedule(self.opt, step), bias_corrections(self.opt, step)
            params = dict(model.named_parameters())
            for key, dim in self.dims.items():
                names = self.names[key]
                p = self._stacked(params, names)
                if not hp.fsdp:
                    p = self._cut(key, p)
                new = adamw_leaf(p.float(), shards.pop(key) * clip, st["m"][key], st["v"][key],
                                 lr, bc, self.opt).to(p.dtype)
                if not hp.fsdp and dim is not None:  # ZeRO-1: the slices joined again
                    new = self._gather(new, dim, "data")
                if isinstance(names, tuple):
                    for u, name in enumerate(names):
                        params[name].copy_(new[u])
                else:
                    params[names].copy_(new)
            st["step"] = step + 1
        return {"loss": loss, "lr": lr, "grad_norm": gnorm}


def make_train_step(api, cfg, opt: OptConfig, mesh, hp: TrainHparams, batch_shape) -> MeshStep:
    """The distributed step over ``mesh`` (a built ``launch.mesh.Mesh``;
    this process is one rank; ``api`` from ``get_api(cfg, device,
    mesh=mesh)``): hierarchical with ``hp.hierarchical``, else the flat
    baseline.  ``batch_shape`` maps each
    batch entry to its global shape (or an array of it)."""
    return MeshStep(api, cfg, opt, mesh, hp, batch_shape)
