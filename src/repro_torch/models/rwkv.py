"""RWKV-6 "Finch" block (PyTorch twin of ``repro.models.rwkv``): attention-free
time mixing with data-dependent per-channel decay (arXiv:2404.05892), plus
squared-ReLU channel mixing.

The WKV recurrence (state S_t ∈ ℝ^{K×V} per head)

    y_t = r_t · (S_{t-1} + diag(u) k_t vᵀ_t)
    S_t = diag(w_t) S_{t-1} + k_t vᵀ_t

goes through :func:`repro_torch.kernels.ops.wkv6` (the CUDA kernel on the
card), where the JAX model path runs it through ``ssm.chunked_scan``.  The
kernel takes ``log w = -exp(wlog)``; the JAX model forms
``w = exp(-exp(wlog))``.  The kernel returns y in fp32 whatever the compute
dtype, as the JAX model keeps it up to the group norm.

State: ``(x_prev (B,1,d), wkv (B,H,K,V) fp32)`` for the time mix and
``x_prev (B,1,d)`` for the channel mix, updated in place when given.
Parameter names, shapes and (in, out) orientation follow the JAX pytree;
``w0`` and ``u`` are fp32 whatever ``param_dtype`` is, as in JAX.

On a rank of a ``model`` axis (``dist.tensor_parallel``) that divides the
heads, the time mix is head-parallel: ``wr``/``wk``/``wv``/``wg`` are
column slices of whole heads, ``u``, ``w0`` and ``ln_scale`` the same
heads' channels, ``wo`` is row-parallel, and the WKV6 kernel and the group
norm run on the rank's heads (its state is those heads', ``(B, H/model, K,
K)``).  The ddlerp token shift runs on the whole ``d`` on every rank,
because ``xr @ wr`` contracts over all of it: ``mu``, ``ts_a`` and ``ts_b``
are gathered (JAX cuts ``ts_a``'s 5 x L outputs and ``ts_b``'s L rows, which
do not line up), and so are the decay LoRA's ``w_a`` and ``w_b`` (a pair
over its rank, not over heads), of which the rank keeps its channels'
columns of ``w_b``: gathering both weights moves less than an all-reduce
of the (B, S, d) fp32 product would.  The channel mix is a Megatron pair
(``wk`` column, ``wv`` row) with ``mu_k``/``mu_r`` gathered; see
:meth:`RWKVChannelMix.forward` for its receptance.  The token-shift states
``x_prev`` are whole on every rank.  Where the axis does not divide the
heads (or, for the channel mix, ``d_ff`` and ``d``), every rank computes
the whole mix from gathered weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist import tensor_parallel as tp
from ..kernels import ops
from .layers import _param, dense_init


def rwkv_dims(cfg):
    rc = cfg.rwkv
    return rc, cfg.d_model // rc.head_dim, rc.head_dim


def local_heads(cfg, model: int) -> int:
    """The WKV heads that a rank of a ``model`` axis computes: H / model
    where the axis divides them (head-parallel), else all H."""
    H = rwkv_dims(cfg)[1]
    return H // model if H % model == 0 else H


def rwkv_state_shapes(cfg, batch: int, model: int = 1):
    """The time mix's x_prev, its wkv state (of a rank's heads on a
    ``model`` axis, :func:`local_heads`) and the channel mix's x_prev."""
    rc, H, K = rwkv_dims(cfg)
    return (
        (batch, 1, cfg.d_model),  # time-mix x_prev
        (batch, local_heads(cfg, model), K, K),  # wkv state
        (batch, 1, cfg.d_model),  # channel-mix x_prev
    )


def _shifted(x: torch.Tensor, x_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x moved one token later: x_prev (zeros without a state) comes first."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _uniform_mix(t: torch.Tensor, gen: torch.Generator) -> None:
    """uniform [0.25, 0.75), the JAX initialiser's token-shift mix."""
    w = torch.rand(t.shape, generator=gen, device=t.device, dtype=torch.float32)
    t.copy_(w.mul_(0.5).add_(0.25))


class RWKVTimeMix(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        rc, H, K = rwkv_dims(cfg)
        d, L = cfg.d_model, rc.tokenshift_lora
        self.cfg = cfg
        self.mu = _param((5, d), cfg, device)
        # shared token-shift lora: x -> 5 per-channel lerp adjustments
        self.ts_a = _param((d, 5 * L), cfg, device)
        self.ts_b = _param((L, 5 * d), cfg, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _param((d, d), cfg, device))
        self.w0 = nn.Parameter(torch.empty((d,), dtype=torch.float32, device=device))
        self.w_a = _param((d, rc.decay_lora), cfg, device)
        self.w_b = _param((rc.decay_lora, d), cfg, device)
        self.u = nn.Parameter(torch.empty((d,), dtype=torch.float32, device=device))
        self.ln_scale = _param((d,), cfg, device)  # per-head group norm scale

    def reset_parameters(self, gen: torch.Generator) -> None:
        _uniform_mix(self.mu.data, gen)
        dense_init(self.ts_a.data, gen)
        dense_init(self.ts_b.data, gen, scale=0.01)
        for w in (self.wr, self.wk, self.wv, self.wg, self.wo, self.w_a):
            dense_init(w.data, gen)
        dense_init(self.w_b.data, gen, scale=0.01)
        self.w0.data.copy_(torch.randn(self.w0.shape, generator=gen, device=self.w0.device)
                           .mul_(0.5).sub_(0.5))
        self.u.data.copy_(torch.randn(self.u.shape, generator=gen, device=self.u.device)
                          .mul_(0.1))
        nn.init.ones_(self.ln_scale)

    def forward(self, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """x (B,S,d) -> y (B,S,d).  ``state`` = (x_prev, wkv), written in place."""
        rc, H, K = rwkv_dims(self.cfg)
        B, S, d = x.shape
        dt = x.dtype
        x_prev, wkv0 = state if state is not None else (None, None)
        axis = tp.axis_of(self)
        w = {n: getattr(self, n) for n in ("mu", "ts_a", "ts_b", "wr", "wk", "wv", "wg", "wo",
                                           "w0", "w_a", "w_b", "u", "ln_scale")}
        heads = axis is not None and local_heads(self.cfg, axis.size) < H
        if heads:  # this rank's heads; the token shift and the decay LoRA gathered
            H = local_heads(self.cfg, axis.size)
            x = tp.copy_to(x, axis)
            for n in ("mu", "ts_a", "ts_b", "w_a", "w_b"):
                w[n] = tp.partial(w[n], axis)
            w["w_b"] = axis.own(w["w_b"], -1)
        elif axis is not None:  # the whole time mix on every rank
            w = {n: tp.whole(p, axis) for n, p in w.items()}
        xs = _shifted(x, x_prev)

        # Finch ddlerp token shift: per-channel static mu + low-rank dynamic term
        delta = xs - x
        base = x + delta * w["mu"][0].to(dt)
        dyn = torch.tanh(base @ w["ts_a"].to(dt)).reshape(B, S, 5, rc.tokenshift_lora)
        dyn = torch.einsum("bsfr,rfd->bsfd", dyn,
                           w["ts_b"].to(dt).reshape(rc.tokenshift_lora, 5, d))
        mixed = x[:, :, None] + delta[:, :, None] * (w["mu"].to(dt) + dyn)  # (B,S,5,d)
        xr, xk, xv, xw, xg = mixed.unbind(dim=2)

        r = (xr @ w["wr"].to(dt)).reshape(B, S, H, K)
        k = (xk @ w["wk"].to(dt)).reshape(B, S, H, K)
        v = (xv @ w["wv"].to(dt)).reshape(B, S, H, K)
        g = F.silu(xg @ w["wg"].to(dt))
        wlog = w["w0"] + torch.tanh(xw @ w["w_a"].to(dt)).float() @ w["w_b"].float()
        log_w = -torch.exp(wlog).reshape(B, S, H, K)  # log of the (0,1) decay
        u = w["u"].reshape(H, K)
        if wkv0 is None:
            y, _ = ops.wkv6(r, k, v, log_w, u,
                            torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device),
                            out_dtype=torch.float32)
        else:
            y, _ = ops.wkv6(r, k, v, log_w, u, wkv0, s_out=wkv0, out_dtype=torch.float32)
            x_prev.copy_(x[:, -1:])

        # per-head group norm, statistics in fp32 (y is fp32 already)
        yf = y.float()
        mu_ = yf.mean(-1, keepdim=True)
        var = yf.var(-1, unbiased=False, keepdim=True)
        yf = (yf - mu_) * torch.rsqrt(var + 64e-5)
        y = yf.reshape(B, S, H * K).to(dt) * w["ln_scale"].to(dt)
        out = (y * g) @ w["wo"].to(dt)
        return tp.reduce_from(out, axis) if heads else out


class RWKVChannelMix(nn.Module):
    """Squared-ReLU channel mix with its own token shift."""

    def __init__(self, cfg, device):
        super().__init__()
        d = cfg.d_model
        self.mu_k = _param((d,), cfg, device)
        self.mu_r = _param((d,), cfg, device)
        self.wk = _param((d, cfg.d_ff), cfg, device)
        self.wv = _param((cfg.d_ff, d), cfg, device)
        self.wr = _param((d, d), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        _uniform_mix(self.mu_k.data, gen)
        _uniform_mix(self.mu_r.data, gen)
        for w in (self.wk, self.wv, self.wr):
            dense_init(w.data, gen)

    def forward(self, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B,S,d) -> (B,S,d).  ``x_prev`` (B,1,d) is written in place.

        On a model axis that divides ``d_ff`` and ``d``, ``wk``/``wv`` are a
        Megatron pair and ``wr`` is cut along its outputs, while the
        receptance multiplies the *reduced* product of ``wv``.  The partial
        products are reduce-scattered over ``d`` and multiplied by the
        rank's own columns of ``r``, and that product is gathered: the
        bytes of one all-reduce, where gathering ``r`` whole beside an
        all-reduce of ``k @ wv`` would move a (B, S, d) gather more."""
        dt = x.dtype
        axis = tp.axis_of(self)
        w = {n: getattr(self, n) for n in ("mu_k", "mu_r", "wk", "wv", "wr")}
        local = axis is not None and tp.sliced(self.wk, -1) and tp.sliced(self.wr, -1)
        if local:
            x = tp.copy_to(x, axis)
            w["mu_k"], w["mu_r"] = tp.partial(w["mu_k"], axis), tp.partial(w["mu_r"], axis)
        elif axis is not None:  # the whole channel mix on every rank
            w = {n: tp.whole(p, axis) for n, p in w.items()}
        delta = _shifted(x, x_prev) - x
        xk = x + delta * w["mu_k"].to(dt)
        xr = x + delta * w["mu_r"].to(dt)
        if x_prev is not None:
            x_prev.copy_(x[:, -1:])
        k = torch.square(torch.relu(xk @ w["wk"].to(dt)))
        r = torch.sigmoid(xr @ w["wr"].to(dt))
        if local:
            return tp.gather_whole(r * tp.scatter_from(k @ w["wv"].to(dt), -1, axis), -1, axis)
        return r * (k @ w["wv"].to(dt))
