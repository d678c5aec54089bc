"""The train steps (the PyTorch twin of ``repro.train.trainstep``).

One step is: the loss of the model's family (``models.registry.loss_fn``:
``lm_loss``, ``whisper_loss`` or ``vlm_loss``, as JAX's ``api.loss``) and its
gradients, summed over ``grad_accum`` microbatches as ``_accum_grads`` does
in JAX, then one AdamW update of the model's parameters in place.  On the
card the model's forward runs the flash attention and RMSNorm kernels (the
attention families, whisper and the VLM) or the WKV6 kernel (rwkv6), and
autograd runs their backward kernels.  jamba's hybrid does not train yet:
its plain selective scan through autograd keeps hundreds of GB at full
width, and waits for a scan kernel with its backward (ROADMAP B.10).

:func:`train_step` is the single-device step; of :class:`TrainHparams` it
honours ``grad_accum`` only, and the distributed flags raise there.

:func:`make_train_step` builds the distributed steps over the data axes of a
mesh (``launch.mesh``: ``pod`` × ``data``, ``model`` = 1), one process a
rank, every rank holding the whole model:

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
rank's shard is JAX's shard at the same mesh coordinates.  Each rank takes
the row block ``pod_idx * data + data_idx`` of the global batch
(``batch_specs``).  The MoE families route each rank's tokens apart, in both
steps, as JAX's hierarchical step does; JAX's flat step routes the global
batch as one under GSPMD, which a data-parallel step cannot without moving
activations.

On the CPU (gloo), four ranks:
  python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu \
      --hierarchical --zero1 --compress --steps 4
On the card (NCCL, one card a rank): the same without ``--device cpu``;
``chip_smoke.py`` runs it at world 1 and, on a host of several cards, over
them.  Tensor parallelism (``model`` > 1) and ``fsdp`` raise
``NotImplementedError`` (ROADMAP A.9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..dist.sharding import batch_specs, zero1_dim
from ..launch.mesh import dp_axes, mesh_axis_sizes
from ..models.convert import jax_leaves
from ..models.registry import loss_fn, model_class
from .optimizer import (OptConfig, adamw_init, adamw_leaf, adamw_update, bias_corrections,
                        clip_scale, schedule)


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    grad_accum: int = 1
    hierarchical: bool = False  # hierarchical collectives (make_train_step)
    compress: bool = False  # int8 cross-pod gradient compression (hierarchical step)
    zero1: bool = False  # shard optimizer state over data axis (make_train_step)
    fsdp: bool = False  # ZeRO-3 (not ported: ROADMAP A.9)


def _check_hparams(hp: TrainHparams, mesh: bool = False) -> None:
    """Refuse what the step does not port: ``fsdp``, and without a ``mesh``
    the distributed flags."""
    if hp.fsdp:
        raise NotImplementedError("TrainHparams.fsdp: ZeRO-3 is not ported to repro_torch "
                                  "yet (ROADMAP A.9)")
    for flag in () if mesh else ("hierarchical", "compress", "zero1"):
        if getattr(hp, flag):
            raise NotImplementedError(
                f"TrainHparams.{flag} needs a mesh: build the distributed step with "
                "make_train_step (ROADMAP A.7); train_step runs on one device")
    if hp.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, not {hp.grad_accum}")


def _check_trains(cfg) -> None:
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: training the hybrid family is not ported to repro_torch yet: "
            "it waits for a selective-scan kernel and its backward (ROADMAP B.10)")


def make_train_state(api, seed: int = 0) -> dict:
    """{"model": random weights from ``api.init(seed)``, "opt": AdamW state}.
    Every family trains but jamba's hybrid (ROADMAP B.10)."""
    _check_trains(api.cfg)
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


# torch 2.13 names these ``*_single`` and deprecates the older names, which
# are the only ones before it
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class MeshStep:
    """The distributed train step of :func:`make_train_step`:
    ``step(state, batch)`` takes the global batch, trains ``state`` in place
    and returns ``{"loss", "lr", "grad_norm"}`` (0-dim tensors, the same on
    every rank).  ``init_state(seed)`` builds the state: the whole model on
    ``mesh.device`` and this rank's AdamW moments.

    ``leaves`` maps each JAX key to its port names (``jax_leaves``),
    ``shapes`` to its stacked shape, ``dims`` to the dim its moments are cut
    along over ``data`` (None: whole), which is where ``zero1_specs`` puts
    ``"data"``.
    ``comm`` counts the last step's collectives per axis (``"data"``,
    ``"pod"``, and ``"pod+data"`` for the groups over both): calls, and
    bytes as the sizes of the tensors handed in (a reduce-scatter's input,
    an all-reduce's buffer, an all-gather's output)."""

    def __init__(self, api, cfg, opt: OptConfig, mesh, hp: TrainHparams, batch_shape):
        _check_hparams(hp, mesh=True)
        sizes = mesh_axis_sizes(mesh)
        if sizes.get("model", 1) > 1:
            raise NotImplementedError(
                f"a model axis of {sizes['model']}: tensor parallelism is not ported to "
                "repro_torch yet (ROADMAP A.9); the steps run over the data axes")
        if "data" not in sizes:
            raise ValueError(f"the mesh {mesh.axis_names} has no data axis")
        _check_trains(cfg)
        self.api, self.cfg, self.opt, self.mesh, self.hp = api, cfg, opt, mesh, hp
        self.dp = dp_axes(mesh)
        self.data, self.pod = sizes["data"], sizes.get("pod", 1)
        self.n_dp = self.data * self.pod

        named = dict(model_class(cfg)(cfg, torch.device("meta")).named_parameters())
        self.leaves = jax_leaves(named, cfg)
        self.shapes = {k: (len(n),) + tuple(named[n[0]].shape) if isinstance(n, tuple)
                       else tuple(named[n].shape) for k, n in self.leaves.items()}
        sharded = hp.zero1 or hp.hierarchical  # JAX: zero1 specs for either
        self.dims = {k: zero1_dim(k, s, 1, self.data, cfg.moe is not None) if sharded else None
                     for k, s in self.shapes.items()}
        self.batch_specs = batch_specs(batch_shape, mesh)
        self.batch_rows = {k: tuple(getattr(v, "shape", v))[0] for k, v in batch_shape.items()}

        coords = mesh.coords()
        self.data_idx = coords["data"]
        self.dp_idx = coords.get("pod", 0) * self.data + self.data_idx
        self.groups = {a: mesh.group(a) for a in self.dp}
        # with model = 1 the group over pod x data is the world
        self.groups.setdefault("+".join(self.dp), dist.group.WORLD)
        self.comm: Dict[str, Dict[str, int]] = {}

    # ---- layout ----------------------------------------------------------
    def shard(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of JAX leaf ``key`` (a view of ``full``)."""
        dim = self.dims[key]
        if dim is None:
            return full
        size = full.shape[dim] // self.data
        return full.narrow(dim, self.data_idx * size, size)

    def gather(self, key: str, shard: torch.Tensor) -> torch.Tensor:
        """JAX leaf ``key`` whole from every rank's ``shard`` (a collective
        over ``data`` where the leaf is cut)."""
        dim = self.dims[key]
        return shard if dim is None else self._gather(shard, dim, count=False)

    def init_opt(self) -> dict:
        """Zero fp32 moments of this rank's slices and step 0."""
        dev = self.mesh.device

        def zeros():
            out = {}
            for k, shape in self.shapes.items():
                shape, dim = list(shape), self.dims[k]
                if dim is not None:
                    shape[dim] //= self.data
                out[k] = torch.zeros(shape, dtype=torch.float32, device=dev)
            return out

        return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def init_state(self, seed: int = 0) -> dict:
        """{"model": ``api.init(seed)``, rank 0's weights on every rank,
        "opt": :meth:`init_opt`}."""
        dev, want = self.api.device, self.mesh.device
        if dev.type != want.type or dev.index not in (None, want.index):
            raise ValueError(f"the model's device {dev} is not the mesh's {want}")
        model = self.api.init(seed)
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p, src=0)
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
        the collective splits dim 0)."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] // self.data,) + t.shape[1:])
        self._count("data", t)
        _reduce_scatter(out, t, group=self.groups["data"])
        return out.movedim(0, dim)

    def _gather(self, t: torch.Tensor, dim: int, count: bool = True) -> torch.Tensor:
        """All-gather over ``data`` along ``dim`` (counted in ``comm``
        inside the step)."""
        t = t.movedim(dim, 0).contiguous()
        out = t.new_empty((t.shape[0] * self.data,) + t.shape[1:])
        if count:
            self._count("data", out)
        _all_gather(out, t, group=self.groups["data"])
        return out.movedim(0, dim)

    def _cross_pod(self, gs: torch.Tensor) -> torch.Tensor:
        """The sum over ``pod``: plain, or of JAX's int8 values as int32."""
        if not self.hp.compress:
            return self._all_reduce(gs, "pod")
        amax = self._all_reduce(gs.abs().max(), "pod", op=dist.ReduceOp.MAX)
        scale = torch.clamp(amax, min=1e-12)
        q = self._all_reduce(quantize_int8(gs, scale), "pod")
        return q.to(torch.float32) * (scale / 127.0)

    # ---- the step --------------------------------------------------------
    def _stacked(self, tensors: Mapping[str, torch.Tensor], key: str, pop: bool = False):
        names = self.leaves[key]
        get = tensors.pop if pop else tensors.__getitem__
        return torch.stack([get(n) for n in names]) if isinstance(names, tuple) else get(names)

    def __call__(self, state: dict, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model, st, hp = state["model"], state["opt"], self.hp
        self.comm = {}
        loss, grads = _accum_grads(model, self.local_batch(batch), hp.grad_accum)
        dp = "+".join(self.dp)
        loss = self._all_reduce(loss.float().clone(), dp) / self.n_dp
        with torch.no_grad():
            shards, parts, cut = {}, [], []
            for key, dim in self.dims.items():
                g = self._stacked(grads, key, pop=True).float()
                if hp.hierarchical:
                    gs = self._scatter(g, dim) if dim is not None else self._all_reduce(g, "data")
                    if "pod" in self.groups:
                        gs = self._cross_pod(gs)
                    gs = gs / self.n_dp
                    cut.append(dim is not None)
                else:  # flat: the whole gradient, then this rank's slice
                    gs = self._all_reduce(g, dp) / self.n_dp
                    cut.append(False)
                parts.append(torch.sum(gs * gs))
                shards[key] = gs if hp.hierarchical or dim is None else self.shard(key, gs).clone()
                del g, gs
            if any(cut):  # the scattered leaves' squares, summed over data at once
                idx = [i for i, c in enumerate(cut) if c]
                summed = self._all_reduce(torch.stack([parts[i] for i in idx]), "data")
                for j, i in enumerate(idx):
                    parts[i] = summed[j]
            sq = torch.zeros((), dtype=torch.float32, device=loss.device)
            for part in parts:  # JAX's order of leaves
                sq = sq + part
            gnorm = torch.sqrt(sq)
            clip = clip_scale(self.opt, gnorm)
            step = st["step"]
            lr, bc = schedule(self.opt, step), bias_corrections(self.opt, step)
            params = dict(model.named_parameters())
            for key, dim in self.dims.items():
                p = self.shard(key, self._stacked(params, key))
                new = adamw_leaf(p.float(), shards.pop(key) * clip, st["m"][key], st["v"][key],
                                 lr, bc, self.opt).to(p.dtype)
                full = new if dim is None else self._gather(new, dim)
                names = self.leaves[key]
                if isinstance(names, tuple):
                    for u, name in enumerate(names):
                        params[name].copy_(full[u])
                else:
                    params[names].copy_(full)
            st["step"] = step + 1
        return {"loss": loss, "lr": lr, "grad_norm": gnorm}


def make_train_step(api, cfg, opt: OptConfig, mesh, hp: TrainHparams, batch_shape) -> MeshStep:
    """The distributed step over ``mesh``'s data axes (a built
    ``launch.mesh.Mesh``; this process is one rank): hierarchical with
    ``hp.hierarchical``, else the flat baseline.  ``batch_shape`` maps each
    batch entry to its global shape (or an array of it)."""
    return MeshStep(api, cfg, opt, mesh, hp, batch_shape)
