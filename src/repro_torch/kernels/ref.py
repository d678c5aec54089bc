"""Plain PyTorch versions of the hand-written kernels — their contracts.

Line for line the math of ``repro.kernels.ref``: they materialise the full
score matrix and reduce in fp32, so the tests hold the kernels against the
most obviously correct implementation (WKV6 steps through the sequence
one token at a time).  On a CPU tensor the kernel wrappers run these; on
the card ``chip_smoke.py`` compares each kernel with them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def mha_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    s = torch.where(ok[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def rmsnorm_reference(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * scale.float()).to(x.dtype)


def wkv6_reference(
    r: torch.Tensor,  # (B, H, T, K)
    k: torch.Tensor,  # (B, H, T, K)
    v: torch.Tensor,  # (B, H, T, V)
    log_w: torch.Tensor,  # (B, H, T, K)  (log of per-channel decay, < 0)
    u: torch.Tensor,  # (H, K)  bonus for the current token
    s0: torch.Tensor,  # (B, H, K, V)  initial state
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV6:  y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ);
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ.  Returns (y in ``out_dtype``, r's
    dtype by default; S fp32)."""
    T = r.shape[2]
    rf, kf, vf = (a.float() for a in (r, k, v))
    wf = torch.exp(log_w.float())
    uf = u.float()
    S = s0.float()
    ys = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]  # (B,H,K,V)
        att = S + uf[None, :, :, None] * kv
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, att))
        S = wt[..., :, None] * S + kv
    y = torch.stack(ys, dim=2)  # (B, H, T, V)
    return y.to(out_dtype or r.dtype), S
