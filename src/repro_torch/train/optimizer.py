"""AdamW + cosine schedule + global-norm clipping (the PyTorch twin of
``repro.train.optimizer``).

The state is a dict ``{"m", "v", "step"}``: ``m`` and ``v`` map each
parameter name of the model to an fp32 tensor whatever the param dtype, and
``step`` is an int32 tensor.  :func:`adamw_update` applies one step to the
model's parameters in place (the JAX version returns new arrays) and
computes the update in fp32, cast back to the param dtype, as JAX does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def schedule(opt: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (fp32 tensor): linear warmup, then cosine
    down to ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(opt.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - opt.warmup_steps) / max(opt.total_steps - opt.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = opt.min_lr_frac + (1 - opt.min_lr_frac) * cos
    return opt.lr * warm * frac


def adamw_init(model: nn.Module) -> dict:
    """Zero fp32 moments for every parameter of ``model``, on its device."""
    params = dict(model.named_parameters())
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    device = next(iter(params.values())).device
    return {
        "m": zeros,
        "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def adamw_update(model: nn.Module, grads: Mapping[str, torch.Tensor], state: dict,
                 opt: OptConfig) -> Dict[str, torch.Tensor]:
    """One AdamW step on ``model``'s parameters and ``state``, in place.

    ``grads`` maps parameter names to gradients (any float dtype).  Clipping
    is by the global norm (guarded by ``max(gnorm, 1e-9)``), the bias
    corrections use ``step + 1``, and the decoupled weight decay applies to
    every parameter, as in JAX.  Returns ``{"lr", "grad_norm"}``."""
    step = state["step"]
    lr = schedule(opt, step)
    gnorm = global_norm(grads.values())
    scale = clip_scale(opt, gnorm)
    bc = bias_corrections(opt, step)
    for name, p in model.named_parameters():
        g = grads[name].float() * scale
        p.copy_(adamw_leaf(p.float(), g, state["m"][name], state["v"][name], lr, bc, opt))
    state["step"] = step + 1
    return {"lr": lr, "grad_norm": gnorm}


def clip_scale(opt: OptConfig, gnorm: torch.Tensor) -> torch.Tensor:
    """min(1, clip_norm / max(gnorm, 1e-9)): the global-norm clip factor."""
    return torch.clamp(opt.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def bias_corrections(opt: OptConfig, step: torch.Tensor):
    """(1 - beta1**t, 1 - beta2**t) at t = step + 1, fp32 tensors."""
    t = (step + 1).to(torch.float32)
    return tuple(1 - torch.pow(torch.tensor(b, dtype=torch.float32, device=t.device), t)
                 for b in (opt.beta1, opt.beta2))


@torch.no_grad()
def adamw_leaf(p32: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
               lr: torch.Tensor, bc, opt: OptConfig) -> torch.Tensor:
    """AdamW on one fp32 leaf (or a shard of one) with its clipped fp32
    gradient ``g``: updates the moments ``m`` and ``v`` in place and returns
    the new fp32 value of ``p32``; ``bc`` is :func:`bias_corrections`."""
    b1, b2 = opt.beta1, opt.beta2
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    delta = (m / bc[0]) / (torch.sqrt(v / bc[1]) + opt.eps) + opt.weight_decay * p32
    return p32 - lr * delta
