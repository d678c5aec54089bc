"""Public kernel entry points: layout adaptation in front of the kernels.

Layouts at this boundary follow the *model* convention (B, S, H, D); the
kernels use (B, H, S, D), taken here as a transposed view of the same
memory (no copy: the CUDA kernels read strides).  Each op dispatches on the
tensor's device inside its kernel wrapper: a CUDA tensor goes to the
hand-written kernel or the call raises, a CPU tensor goes to the plain
version.  There is no flag to force either path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import flash_attention as _flash
from .rmsnorm import rmsnorm as _rmsnorm
from .selective_scan import selective_scan as _selective_scan
from .wkv6 import wkv6 as _wkv6


def attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention with model-layout inputs; returns (B, Sq, Hq, D)."""
    out = _flash(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap, scale=scale,
    )
    return out.transpose(1, 2)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    return _rmsnorm(x, scale, eps=eps)


def wkv6(
    r: torch.Tensor,  # (B, S, H, K)
    k: torch.Tensor,  # (B, S, H, K)
    v: torch.Tensor,  # (B, S, H, V)
    log_w: torch.Tensor,  # (B, S, H, K) fp32
    u: torch.Tensor,  # (H, K) fp32
    s0: torch.Tensor,  # (B, H, K, V) fp32
    *,
    s_out: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 with model-layout inputs; returns (y (B,S,H,V) in ``out_dtype``,
    r's dtype by default, s_final).  With ``s_out`` (which may be ``s0``) the
    final state is written there."""
    y, s_final = _wkv6(*(a.transpose(1, 2) for a in (r, k, v, log_w)), u, s0, s_out=s_out,
                       out_dtype=out_dtype)
    return y.transpose(1, 2), s_final


def selective_scan(
    dt: torch.Tensor,  # (B, S, d_in) fp32
    dtx: torch.Tensor,  # (B, S, d_in) fp32
    Bm: torch.Tensor,  # (B, S, N) fp32
    Cm: torch.Tensor,  # (B, S, N) fp32
    A: torch.Tensor,  # (d_in, N) fp32
    h0: torch.Tensor,  # (B, d_in, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba mixer's selective scan in the model's layout; returns (y
    (B, S, d_in), h_S (B, d_in, N)), fp32."""
    return _selective_scan(dt, dtx, Bm, Cm, A, h0)
