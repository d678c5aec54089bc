"""The single-device train step (the PyTorch twin of the single-device part
of ``repro.train.trainstep``).

One step is: the loss of the model's family (``models.registry.loss_fn``:
``lm_loss``, ``whisper_loss`` or ``vlm_loss``, as JAX's ``api.loss``) and its
gradients, summed over ``grad_accum`` microbatches as ``_accum_grads`` does
in JAX, then one AdamW update of the model's parameters in place.  On the
card the model's forward runs the flash attention and RMSNorm kernels (the
attention families, whisper and the VLM) or the WKV6 kernel (rwkv6), and
autograd runs their backward kernels.  jamba's hybrid does not train yet:
its plain selective scan through autograd keeps hundreds of GB at full
width, and waits for a scan kernel with its backward (ROADMAP B.10).

Of :class:`TrainHparams` only ``grad_accum`` is honoured here.  The
distributed steps (``hierarchical``, ``compress``, ``zero1``, ``fsdp``) are
not ported yet (ROADMAP A.7) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.registry import loss_fn
from .optimizer import OptConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    grad_accum: int = 1
    hierarchical: bool = False  # shard_map hierarchical collectives (not ported)
    compress: bool = False  # int8 cross-pod gradient compression (not ported)
    zero1: bool = False  # shard optimizer state over data axis (not ported)
    fsdp: bool = False  # ZeRO-3 (not ported)


def _check_hparams(hp: TrainHparams) -> None:
    for flag in ("hierarchical", "compress", "zero1", "fsdp"):
        if getattr(hp, flag):
            raise NotImplementedError(
                f"TrainHparams.{flag}: the distributed train steps are not ported to "
                "repro_torch yet (ROADMAP A.7)")
    if hp.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, not {hp.grad_accum}")


def make_train_state(api, seed: int = 0) -> dict:
    """{"model": random weights from ``api.init(seed)``, "opt": AdamW state}.
    Every family trains but jamba's hybrid (ROADMAP B.10)."""
    if api.cfg.family == "hybrid":
        raise NotImplementedError(
            f"{api.cfg.name}: training the hybrid family is not ported to repro_torch yet: "
            "it waits for a selective-scan kernel and its backward (ROADMAP B.10)")
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
