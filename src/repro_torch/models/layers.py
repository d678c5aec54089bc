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
* a module built for a rank of a ``model`` axis (``models.registry.
  local_model``) holds its parameters' slices and runs the collectives of
  ``dist.tensor_parallel``: the norms gather their scales, the MLPs are
  column/row-parallel, the embedding gathers the looked-up rows' pieces and
  the fused loss is vocabulary-parallel
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..dist import tensor_parallel as tp
from ..kernels import ops


# ---------------------------------------------------------------------------
# init helpers (same distributions as the JAX initialisers)
# ---------------------------------------------------------------------------

def dense_init(t: torch.Tensor, gen: torch.Generator, scale: Optional[float] = None) -> None:
    """normal x 1/sqrt(in) for an (in, out) weight, drawn in fp32."""
    s = scale if scale is not None else 1.0 / math.sqrt(t.shape[0])
    w = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
    t.copy_(w.mul_(s))


def stacked_init(t: torch.Tensor, gen: torch.Generator) -> None:
    """normal x 1/sqrt(in) for an (E, in, out) stack of expert weights (JAX's
    ``init_moe`` ``stack``): the fan-in is the second axis, and each expert
    is drawn in fp32 on its own, so no fp32 copy of the whole stack is made."""
    s = 1.0 / math.sqrt(t.shape[1])
    for w in t:
        dense_init(w, gen, s)


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
    """The config's norm over d_model, or ``kind`` over ``width`` (MLA's
    ``q_norm`` and ``kv_norm`` are RMSNorms of the latent widths)."""

    def __init__(self, cfg, device, width: Optional[int] = None, kind: Optional[str] = None):
        super().__init__()
        self.kind = kind or cfg.norm_kind
        d = width or cfg.d_model
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
        axis = tp.axis_of(self)
        scale, bias = getattr(self, "scale", None), getattr(self, "bias", None)
        # the norm runs on the replicated residual stream: a scale (and bias)
        # cut along d_model over the model axis is gathered whole
        scale = scale if scale is None else tp.whole(scale, axis)
        bias = bias if bias is None else tp.whole(bias, axis)
        return norm(x, self.kind, scale, bias)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu_tanh_stepwise(x: torch.Tensor) -> torch.Tensor:
    """tanh-GELU as ``jax.nn.gelu(approximate=True)`` computes it: op by op
    in x's dtype, the constants rounded to it first, so that in bf16 every
    intermediate rounds as in JAX (``F.gelu`` rounds once, and differs from
    JAX's bf16 result in ~44% of entries by one step)."""
    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


# Which tanh-GELU: the VLM projector uses ``gelu_tanh_stepwise``, because
# its output is the prefix that every later position attends to, so a
# rounding step there moves every token's logits. The MLPs keep ``F.gelu``
# (one launch, against ~6 for the stepwise form): a step there moves only
# its own position, and the greedy tokens still match JAX's in bf16.
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
        return mlp_parallel(self, x, self.kind)


def mlp_parallel(mod: nn.Module, x: torch.Tensor, kind: str) -> torch.Tensor:
    """:func:`mlp` of ``mod``'s ``wi``/``wg``/``wo`` on a rank of its model
    axis: column-parallel ``wi``/``wg`` and row-parallel ``wo`` where the
    rank holds a slice of the FFN columns, then the all-reduce; the whole
    MLP on every rank where ``d_ff`` does not divide the axis."""
    axis, wg = tp.axis_of(mod), getattr(mod, "wg", None)
    if axis is not None and tp.sliced(mod.wi, -1):
        y = mlp(tp.copy_to(x, axis), kind, mod.wi, mod.wo, wg)
        return tp.reduce_from(y, axis)
    return mlp(x, kind, mod.wi, mod.wo, wg)


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

    def unembed_names(self) -> Tuple[str, ...]:
        """The table the unembedding reads (``tok`` tied, else ``out``):
        what ZeRO-3 gathers for the logits and the loss (``fsdp.gathered``);
        a lookup reads ``tok`` alone."""
        return ("tok",) if self.cfg.tie_embeddings else ("out",)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = F.embedding(tokens, self.tok)
        if tp.sliced(self.tok, -1):
            # embed/tok cut along d_model: each rank looks up its columns of
            # the rows, and the rows' pieces are gathered (B x S x d moved,
            # not the V x d table)
            x = tp.gather_whole(x, -1, tp.axis_of(self))
        x = x.to(cfg.cdtype)
        if cfg.embed_scale:
            # the constant is rounded to the compute dtype first, as in JAX
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.cdtype, device=x.device)
        return x

    def unembed_matrix(self) -> torch.Tensor:
        """The (d, V) unembedding, the whole vocabulary on every rank of a
        model axis: the tied ``tok`` transposed (a view), or ``out``."""
        axis = tp.axis_of(self)
        return tp.whole(self.tok, axis).T if self.cfg.tie_embeddings else tp.whole(self.out, axis)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits (..., V), the whole vocabulary on every rank of a
        model axis, which moves logits, never the table: ``embed/out`` cut
        along V gives the rank's vocabulary slice of the logits, gathered;
        a tied ``embed/tok`` cut along ``d_model`` gives the partial logits
        of the rank's columns, summed in fp32.  The softcap comes after.
        (The loss takes :meth:`unembed_weight` instead.)"""
        axis = tp.axis_of(self)
        if self.cfg.tie_embeddings and tp.sliced(self.tok, -1):
            cols = axis.own(tp.copy_to(x, axis), -1)
            logits = tp.reduce_from((cols @ self.tok.to(x.dtype).T).float(), axis)
        elif not self.cfg.tie_embeddings and tp.sliced(self.out, -1):
            part = (tp.copy_to(x, axis) @ self.out.to(x.dtype)).float()
            logits = tp.gather_whole(part, -1, axis)
        else:
            logits = (x @ self.unembed_matrix().to(x.dtype)).float()
        return softcap(logits, self.cfg.logit_softcap)

    def unembed_weight(self):
        """(w (d, V_r), v0): this rank's vocabulary slice of the (d, V)
        unembedding, columns v0 .. v0 + V_r, on a model axis that divides V:
        ``embed/out`` cut along V, or the rows of a tied ``embed/tok``."""
        axis = self.tp
        if self.cfg.tie_embeddings:
            # embed/tok (V, d) cut along d_model: gathered whole (its gradient
            # reduce-scattered back), then this rank's vocabulary rows
            rows = axis.own(tp.partial(self.tok, axis), 0)
            return rows.T, axis.index * rows.shape[0]
        return self.out, axis.index * self.out.shape[1]


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


def _chunk_nll(w: torch.Tensor, cap, h: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The NLL (B, chunk) from the fp32 softcapped logits of the (d, V)
    unembedding ``w``."""
    return _nll(softcap((h @ w.to(h.dtype)).float(), cap), targets)


def _chunk_nll_parallel(w: torch.Tensor, v0: int, cap, axis, h: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """The NLL (B, chunk) of a rank's vocabulary slice ``w`` (d, V_r), from
    v0: the max, the sum of exponentials and the gold logit reduced over
    the model axis."""
    logits = softcap((h @ w.to(h.dtype)).float(), cap)
    top = axis.all_reduce(logits.detach().amax(dim=-1), op=torch.distributed.ReduceOp.MAX)
    sumexp = tp.reduce_from(torch.exp(logits - top[..., None]).sum(dim=-1), axis)
    t = targets.long() - v0
    inside = (t >= 0) & (t < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(inside, t, 0)[..., None])[..., 0]
    gold = tp.reduce_from(torch.where(inside, gold, 0.0), axis)
    return top + torch.log(sumexp) - gold


def cross_entropy_fused(h: torch.Tensor, embed: Embed, targets: torch.Tensor, mask=None,
                        chunk: int = 512) -> torch.Tensor:
    """Fused unembed + NLL, chunked over the sequence (``cross_entropy_fused``
    of the JAX package).

    Never keeps the full (B, S, V) logits: each chunk's logits are produced,
    reduced to (lse, gold) and dropped, and ``torch.utils.checkpoint``
    recomputes them chunk by chunk in the backward pass.  The chunk is
    ``chunk``, or gcd(S, chunk) when S is not a multiple of it, or S when
    S < chunk, as in JAX.  On a rank of a model axis that divides the
    vocabulary the loss is vocabulary-parallel
    (:meth:`Embed.unembed_weight`): each chunk's logits are the rank's
    vocabulary slice, and the recomputation repeats the chunk's
    collectives."""
    B, S, d = h.shape
    if S % chunk:
        chunk = S if S < chunk else math.gcd(S, chunk)
    axis = tp.axis_of(embed)
    if axis is None or embed.cfg.vocab_size % axis.size:  # the whole vocabulary
        # the matrix is taken here, not inside the recomputed chunk: a
        # gathered ZeRO-3 table is only swapped in while the forward runs
        fn, lead = _chunk_nll, (embed.unembed_matrix(), embed.cfg.logit_softcap)
    else:
        w, v0 = embed.unembed_weight()
        h = tp.copy_to(h, axis)
        fn, lead = _chunk_nll_parallel, (w, v0, embed.cfg.logit_softcap, axis)
    tot = h.new_zeros((), dtype=torch.float32)
    cnt = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, chunk):
        nll = torch.utils.checkpoint.checkpoint(fn, *lead, h[:, c0:c0 + chunk],
                                                targets[:, c0:c0 + chunk], use_reentrant=False)
        if mask is not None:
            mx = mask[:, c0:c0 + chunk].to(torch.float32)
            tot = tot + (nll * mx).sum()
            cnt = cnt + mx.sum()
        else:
            tot = tot + nll.sum()
            cnt = cnt + nll.numel()
    return tot / torch.clamp(cnt, min=1)
