"""Selective state-space (Mamba-1 / S6) block, used by jamba's hybrid stack
(PyTorch twin of ``repro.models.ssm``).

The recurrence  h_t = a_t ⊙ h_{t-1} + b_t  (diagonal, data-dependent) runs
through :func:`repro_torch.kernels.ops.selective_scan`: on the card the
hand-written selective-scan kernel (``kernels/csrc/selective_scan.cu``),
in prefill, in every decode step (S = 1, from and into the cache's fp32
state) and in training, whose backward is a kernel too
(``selective_scan_bwd.cu``); on the CPU the plain version, JAX's scan in
two levels (``kernels/ref.py``):

* :func:`scan_chunk`: an exact scan *within* a chunk, a log-step doubling
  (Hillis–Steele) scan with JAX's ``associative_scan`` combine
  ``(a1, b1)∘(a2, b2) = (a1·a2, a2·b1 + b2)``; no decay-ratio divisions.
* :func:`chunked_scan`: a sequential loop *over* chunks that carries the
  state, with a caller-supplied ``chunk_fn`` that expands each chunk's
  decays and inputs and reads out its outputs, so the (B, S, d_in, N) state
  tensor is never formed whole.

The JAX package computes the scan in XLA and has no Pallas kernel for it:
the kernel is the port's own.

State: ``(conv_buf (B, d_conv-1, d_in) in the compute dtype, ssm_state
(B, d_in, N) fp32)``, updated in place when given.  Parameter names, shapes
and (in, out) orientation follow the JAX pytree; ``A_log`` and ``D`` are
fp32 whatever ``param_dtype`` is, as in JAX.

On a rank of a ``model`` axis (``dist.tensor_parallel``) that divides
``d_in``, the mixer is channel-parallel: the rank runs the conv, the scan
and the gate on its d_in / model channels (``conv_w``, ``conv_b``,
``dt_bias`` and ``D`` are its slices; its state holds those channels) and
``out_proj`` is row-parallel.  JAX's cuts of the other leaves do not line
up with the channels, so:

* ``in_proj`` is cut contiguously over ``[x | z]``, so no rank holds x and
  z of the same channels: the product ``x @ in_proj`` (B, S, 2 d_in) is
  gathered, not the weight, and the rank takes its channels of both halves;
* ``x_proj`` is cut over its dt_rank + 2N outputs and ``dt_proj`` over its
  dt_rank inputs, while the rank contracts over its own channels and needs
  its own output channels: both weights are gathered (they are small
  beside the activations) and the rank's partial ``dbc`` is all-reduced in
  fp32 (B, S, dt_rank + 2N);
* ``A_log`` is cut over its N states: gathered, the rank's channels kept.

Where the axis does not divide ``d_in``, every rank computes the whole
mixer from gathered weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist import tensor_parallel as tp
from ..kernels import ops, ref
from .layers import _param, dense_init

CHUNK = ref.SCAN_CHUNK  # tokens a chunk of the plain scan: JAX's apply_lm(scan_chunk_size=64)
scan_chunk, chunked_scan = ref.scan_chunk, ref.chunked_scan  # the plain scan's two levels


def selective_scan(dt: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                   A: torch.Tensor, h0: torch.Tensor):
    """The selective scan of ``mamba_block``, in fp32: per channel d and
    state n, h_t = exp(dt_t A) h_{t-1} + dtx_t B_t and y_t = h_t · C_t
    (``kernels.ops.selective_scan``: the kernel on the card, JAX's chunked
    doubling scan on the CPU).

    dt, dtx: (B, S, d_in); Bm, Cm: (B, S, N); A: (d_in, N); h0: (B, d_in, N).
    Returns (y (B, S, d_in), h_S)."""
    return ops.selective_scan(dt, dtx, Bm, Cm, A, h0)


def mamba_dims(cfg):
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    dt_rank = mc.dt_rank or -(-cfg.d_model // 16)
    return mc, d_in, dt_rank


def local_channels(cfg, model: int) -> int:
    """The d_in channels that a rank of a ``model`` axis computes: d_in /
    model where the axis divides them (channel-parallel), else all d_in."""
    d_in = mamba_dims(cfg)[1]
    return d_in // model if d_in % model == 0 else d_in


def mamba_state_shape(cfg, batch: int, model: int = 1):
    """The conv buffer and the scan state (of a rank's channels on a
    ``model`` axis, :func:`local_channels`)."""
    mc, _, _ = mamba_dims(cfg)
    d_in = local_channels(cfg, model)
    return (
        (batch, mc.d_conv - 1, d_in),  # conv_buf
        (batch, d_in, mc.d_state),  # ssm_state
    )


class Mamba(nn.Module):
    """The Mamba-1 mixer: in_proj to (x, z), a causal depthwise conv over S,
    the selective scan with input-dependent dt, B, C, then y·silu(z) and
    out_proj."""

    def __init__(self, cfg, device):
        super().__init__()
        mc, d_in, dt_rank = mamba_dims(cfg)
        d = cfg.d_model
        self.cfg = cfg
        self.in_proj = _param((d, 2 * d_in), cfg, device)
        self.conv_w = _param((mc.d_conv, d_in), cfg, device)
        self.conv_b = _param((d_in,), cfg, device)
        self.x_proj = _param((d_in, dt_rank + 2 * mc.d_state), cfg, device)
        self.dt_proj = _param((dt_rank, d_in), cfg, device)
        self.dt_bias = _param((d_in,), cfg, device)
        self.A_log = nn.Parameter(torch.empty((d_in, mc.d_state), dtype=torch.float32,
                                              device=device))
        self.D = nn.Parameter(torch.empty((d_in,), dtype=torch.float32, device=device))
        self.out_proj = _param((d_in, d), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """JAX's ``init_mamba``: normal/sqrt(in) projections, conv_w
        normal/sqrt(d_conv), zero conv_b and dt_bias, D one, and the
        deterministic S4D-real A_log = log(1..N) on every channel."""
        for w in (self.in_proj, self.conv_w, self.x_proj, self.dt_proj, self.out_proj):
            dense_init(w.data, gen)  # conv_w (d_conv, d_in): 1/sqrt(d_conv)
        nn.init.zeros_(self.conv_b)
        nn.init.zeros_(self.dt_bias)
        N = self.A_log.shape[1]
        A = torch.arange(1, N + 1, dtype=torch.float32, device=self.A_log.device)
        self.A_log.data.copy_(torch.log(A).expand_as(self.A_log))
        nn.init.ones_(self.D)

    def forward(self, x: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """x (B, S, d) -> y (B, S, d).  ``state`` = (conv_buf, ssm_state),
        written in place; without it the conv sees zeros before the first
        token and the scan starts from a zero state."""
        mc, d_in, dt_rank = mamba_dims(self.cfg)
        B, S, _ = x.shape
        dt_ = x.dtype
        axis = tp.axis_of(self)
        w = {n: getattr(self, n) for n in ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                                           "dt_bias", "A_log", "D", "out_proj")}
        chans = axis is not None and local_channels(self.cfg, axis.size) < d_in
        if chans:  # this rank's channels (module docstring)
            x = tp.copy_to(x, axis)
            w["x_proj"] = axis.own(tp.partial(w["x_proj"], axis), 0)
            w["dt_proj"] = axis.own(tp.partial(w["dt_proj"], axis), -1)
            w["A_log"] = axis.own(tp.partial(w["A_log"], axis), 0)
            d_in = local_channels(self.cfg, axis.size)
        elif axis is not None:  # the whole mixer on every rank
            w = {n: tp.whole(p, axis) for n, p in w.items()}
        xz = x @ w["in_proj"].to(dt_)
        if chans:  # [x | z] whole, then the rank's channels of each half
            xz = tp.gather(xz, -1, axis)
            xpart, z = (axis.own(t, -1) for t in xz.chunk(2, dim=-1))
        else:
            xpart, z = xz.chunk(2, dim=-1)  # (B, S, d_in) each

        # causal depthwise conv along S, summed tap by tap in the compute dtype
        if state is not None:
            conv_buf, ssm_state = state
            xcat = torch.cat([conv_buf.to(dt_), xpart], dim=1)
        else:
            ssm_state = torch.zeros((B, d_in, mc.d_state), dtype=torch.float32,
                                    device=x.device)
            xcat = F.pad(xpart, (0, 0, mc.d_conv - 1, 0))
        cw = w["conv_w"].to(dt_)
        xc = xcat[:, 0:S] * cw[0]
        for i in range(1, mc.d_conv):
            xc = xc + xcat[:, i:i + S] * cw[i]
        xc = F.silu(xc + w["conv_b"].to(dt_))

        dbc = xc @ w["x_proj"].to(dt_)
        if chans:  # the partial sums over the rank's channels, added in fp32
            dbc = tp.copy_to(tp.reduce_from(dbc.float(), axis), axis).to(dt_)
        dt = dbc[..., :dt_rank] @ w["dt_proj"].to(dt_)
        dt = F.softplus(dt.float() + w["dt_bias"].float())  # (B, S, d_in) fp32
        Bm = dbc[..., dt_rank:dt_rank + mc.d_state].float()
        Cm = dbc[..., dt_rank + mc.d_state:].float()
        xcf = xc.float()
        y, final = selective_scan(dt, dt * xcf, Bm, Cm, -torch.exp(w["A_log"]), ssm_state)
        if state is not None:
            conv_buf.copy_(xcat[:, -(mc.d_conv - 1):] if mc.d_conv > 1 else xcat[:, :0])
            ssm_state.copy_(final)
        y = (y + w["D"] * xcf).to(dt_) * F.silu(z)
        out = y @ w["out_proj"].to(dt_)
        return tp.reduce_from(out, axis) if chans else out
