"""Shared neural-net building blocks (PyTorch twin of ``repro.models.layers``).

Conventions
-----------
* weights keep the JAX package's (in, out) orientation and layers compute
  ``x @ W``, so parameters carry over from JAX without a transpose
  (:mod:`repro_torch.models.convert`)
* weights are stored in ``cfg.pdtype`` and matmuls run in ``cfg.cdtype``
  with fp32 softmax/norm accumulations
* ``rmsnorm`` goes through :func:`repro_torch.kernels.ops.rmsnorm` (the
  Triton kernels on the card, forward and backward); the JAX model path
  computes it in XLA
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..kernels import ops


# ---------------------------------------------------------------------------
# init helpers (same distributions as the JAX initialisers)
# ---------------------------------------------------------------------------

def dense_init(t: torch.Tensor, gen: torch.Generator, scale: Optional[float] = None) -> None:
    """normal x 1/sqrt(in) for an (in, out) weight, drawn in fp32."""
    s = scale if scale is not None else 1.0 / math.sqrt(t.shape[0])
    w = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
    t.copy_(w.mul_(s))


def embed_init(t: torch.Tensor, gen: torch.Generator) -> None:
    w = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
    t.copy_(w.mul_(0.02))


def _param(shape, cfg, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.pdtype, device=device))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm(x: torch.Tensor, kind: str, scale=None, bias=None, eps: float = 1e-6) -> torch.Tensor:
    if kind == "rmsnorm":
        return ops.rmsnorm(x, scale, eps=eps)
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * scale.float() + bias.float()
    elif kind != "nonparametric":
        raise ValueError(kind)
    return y.to(x.dtype)


class Norm(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.kind = cfg.norm_kind
        d = cfg.d_model
        if self.kind in ("rmsnorm", "layernorm"):
            self.scale = _param((d,), cfg, device)
        if self.kind == "layernorm":
            self.bias = _param((d,), cfg, device)
        if self.kind not in ("rmsnorm", "layernorm", "nonparametric"):
            raise ValueError(self.kind)

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.kind in ("rmsnorm", "layernorm"):
            nn.init.ones_(self.scale)
        if self.kind == "layernorm":
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm(x, self.kind, getattr(self, "scale", None), getattr(self, "bias", None))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, kind: str, wi, wo, wg=None) -> torch.Tensor:
    h = x @ wi.to(x.dtype)
    if kind == "swiglu":
        h = F.silu(x @ wg.to(x.dtype)) * h
    elif kind == "geglu":
        h = F.gelu(x @ wg.to(x.dtype), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ wo.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, cfg, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
        self.kind = cfg.mlp_kind
        self.wi = _param((d, f), cfg, device)
        if self.kind in ("swiglu", "geglu"):
            self.wg = _param((d, f), cfg, device)
        self.wo = _param((f, d), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wi, getattr(self, "wg", None), self.wo):
            if w is not None:
                dense_init(w.data, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.kind, self.wi, self.wo, getattr(self, "wg", None))


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,).  Rotates the two
    halves of the head (not interleaved pairs), in fp32, cast back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions.float()[:, None] * freqs  # (seq, hd/2)
    cos = torch.cos(ang)[:, None, :]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.tok = _param((cfg.vocab_size, cfg.d_model), cfg, device)
        if not cfg.tie_embeddings:
            self.out = _param((cfg.d_model, cfg.vocab_size), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        embed_init(self.tok.data, gen)
        if not self.cfg.tie_embeddings:
            dense_init(self.out.data, gen)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens, self.tok).to(cfg.cdtype)
        if cfg.embed_scale:
            # the constant is rounded to the compute dtype first, as in JAX
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype, device=x.device)
        return x

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits (..., V)."""
        if self.cfg.tie_embeddings:
            logits = x @ self.tok.to(x.dtype).T
        else:
            logits = x @ self.out.to(x.dtype)
        return softcap(logits.float(), self.cfg.logit_softcap)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz - gold


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean next-token NLL.  logits (..., V) fp32, targets int (...)."""
    nll = _nll(logits, targets)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _chunk_nll(embed: Embed, h: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return _nll(embed.unembed(h), targets)  # (B, chunk), from fp32 softcapped logits


def cross_entropy_fused(h: torch.Tensor, embed: Embed, targets: torch.Tensor, mask=None,
                        chunk: int = 512) -> torch.Tensor:
    """Fused unembed + NLL, chunked over the sequence (``cross_entropy_fused``
    of the JAX package).

    Never keeps the full (B, S, V) logits: each chunk's logits are produced,
    reduced to (lse, gold) and dropped, and ``torch.utils.checkpoint``
    recomputes them chunk by chunk in the backward pass.  The chunk is
    ``chunk``, or gcd(S, chunk) when S is not a multiple of it, or S when
    S < chunk, as in JAX."""
    B, S, d = h.shape
    if S % chunk:
        chunk = S if S < chunk else math.gcd(S, chunk)
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        hx, tx = h[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        nll = torch.utils.checkpoint.checkpoint(_chunk_nll, embed, hx, tx, use_reentrant=False)
        if mask is not None:
            mx = mask[:, c0:c0 + chunk].to(torch.float32)
            tot = tot + (nll * mx).sum()
            cnt = cnt + mx.sum()
        else:
            tot = tot + nll.sum()
            cnt = cnt + nll.numel()
    return tot / torch.clamp(cnt, min=1)
