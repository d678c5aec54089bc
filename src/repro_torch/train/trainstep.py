"""The single-device train step (the PyTorch twin of the single-device part
of ``repro.train.trainstep``).

One step is: the loss and its gradients, summed over ``grad_accum``
microbatches as ``_accum_grads`` does in JAX, then one AdamW update of the
model's parameters in place.  On the card the model's forward runs the flash
attention and RMSNorm kernels (dense families) or the WKV6 kernel (rwkv6),
and autograd runs their backward kernels.

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

from ..models.transformer import lm_loss
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
    The decoder-only families train; whisper's and the VLM's losses
    (``whisper_loss``, ``vlm_loss``) are not wired to the step yet."""
    if api.cfg.family in ("audio", "vlm"):
        raise NotImplementedError(f"{api.cfg.name}: training the {api.cfg.family} family is "
                                  "not ported to repro_torch yet (ROADMAP A.1)")
    model = api.init(seed)
    return {"model": model, "opt": adamw_init(model)}


def batch_to_torch(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``SyntheticData.batch_at``) as int64 tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)
            for k, v in batch.items()}


def _accum_grads(model: nn.Module, batch: Mapping[str, torch.Tensor], n_micro: int):
    """(lm_loss, {name: grad}) over ``n_micro`` microbatches: the batch's rows
    split in order; the loss and each gradient are summed as ``x / n_micro``
    into fp32, as JAX's ``lax.scan`` does.  With one microbatch the
    gradients keep the param dtype, as in JAX.  A parameter the loss does
    not read gets a zero gradient, as in JAX."""
    names, params = zip(*model.named_parameters())
    if n_micro <= 1:
        loss = lm_loss(model, batch)
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
        loss = lm_loss(model, micro)
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
