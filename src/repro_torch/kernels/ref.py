"""Plain PyTorch versions of the hand-written kernels — their contracts.

The forward versions are line for line the math of ``repro.kernels.ref``:
they materialise the full score matrix and reduce in fp32, so the tests hold
the kernels against the most obviously correct implementation (WKV6 steps
through the sequence one token at a time).  The backward versions of flash
attention and RMSNorm, which the JAX package leaves to XLA, are their
explicit gradient formulas (flash attention's from o, the row log-sum-exp
and dO).  On a CPU tensor the kernel wrappers run these; on the card
``chip_smoke.py`` compares each kernel with them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _scores(q, k, causal, window, softcap, scale):
    """Scores after scale and softcap, fp32 (B, Hq, Sq, Sk), the visibility
    mask (Sq, Sk), and tanh(z / softcap) (None without a softcap); k is
    already repeated to Hq heads."""
    Sq, Sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    return s, ok, t


def mha_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Attention in q's dtype; with ``return_lse`` also the row log-sum-exp
    of the masked scores, fp32 (B, Hq, Sq), as the kernel writes it for
    training."""
    D = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s, ok, _ = _scores(q, k, causal, window, softcap, scale)
    s = torch.where(ok[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def mha_backward_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    o: torch.Tensor,  # (B, Hq, Sq, D) the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) fp32, the forward's row log-sum-exp
    do: torch.Tensor,  # (B, Hq, Sq, D) the gradient of o
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype, by the explicit formula of the
    backward kernel, fp32 throughout: P = exp(s - lse) where visible, else
    0; Delta = rowsum(dO o); dS = P (dO V^T - Delta) (1 - tanh^2(z/softcap))
    scale; dQ = dS K, dK = dS^T Q, dV = P^T dO, dK and dV summed over the q
    heads of each kv group."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    qf, dof = q.float(), do.float()
    s, ok, t = _scores(qf, kf, causal, window, softcap, scale)
    p = torch.where(ok[None, None], torch.exp(s - lse.float()[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf).reshape(B, Hkv, group, Sk, D).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof).reshape(B, Hkv, group, Sk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_reference(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * scale.float()).to(x.dtype)


def rmsnorm_backward_reference(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale in scale's dtype) of y = x r scale,
    r = rsqrt(mean(x^2) + eps), for the gradient g of y, in fp32:
    dx = r (g scale) - x r^3 mean(x g scale); dscale = sum over rows of
    g x r."""
    d = x.shape[-1]
    xf, gf = x.float().reshape(-1, d), g.float().reshape(-1, d)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = gf * scale.float()
    dx = r * gs - xf * r ** 3 * torch.mean(xf * gs, dim=-1, keepdim=True)
    dscale = (gf * xf * r).sum(0)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32x3: bool) -> torch.Tensor:
    """a @ b with the operands rounded as the tensor cores see them: with
    ``tf32x3`` each is split into hi = tf32(x) and lo = tf32(x - hi) and the
    product is hi·hi + hi·lo + lo·hi; else one TF32 pass."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if not tf32x3:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def wkv6_chunked_reference(
    r: torch.Tensor,  # (B, H, T, K)
    k: torch.Tensor,  # (B, H, T, K)
    v: torch.Tensor,  # (B, H, T, V)
    log_w: torch.Tensor,  # (B, H, T, K)
    u: torch.Tensor,  # (H, K)
    s0: torch.Tensor,  # (B, H, K, V)
    *,
    chunk: int = 32,
    sub: int = 16,
    tf32x3: bool = True,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV6 in the chunked form of the CUDA kernel, step for step, for the
    tests.  Per chunk of ``chunk`` tokens (the last one zero-padded, log_w 0),
    with cl the inclusive cumulative sum of log_w and cl_prev the exclusive:

        inter = (r ⊙ exp(cl_prev)) · S_in
        A     = off-diagonal sub-chunk blocks: (r_t ⊙ exp(cl_prev_t − g)) ·
                (k_j ⊙ exp(g − cl_j))ᵀ, g = cl_prev at the later sub-chunk's
                start; diagonal sub-chunk blocks elementwise,
                Σ_k r_t k_j D_tj below the diagonal, with
                D_tj = exp(cl_prev_t − cl_j) = w_{t−1} ⋯ w_{j+1} multiplied
                out in that order (w = exp(log_w)), and r_t · (u ⊙ k_t) on it
        y     = inter + A · v
        S_out = diag(exp(cl_C)) S_in + (k ⊙ exp(cl_C − cl))ᵀ · v

    Every exponent is ≤ 0.  The products run through :func:`_mm`: TF32 with a
    hi/lo split when ``tf32x3`` (the kernel's ``mma.sync``), one TF32 pass
    otherwise; the diagonal blocks stay in fp32."""
    B, H, T, K = r.shape
    C = chunk
    pad = (-T) % C
    rf, kf, vf, lw = (torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
                      for a in (r, k, v, log_w))
    uf = u.float()[None, :, None, :]  # (1, H, 1, K)
    S = s0.float().clone()
    ys = []
    for c0 in range(0, T + pad, C):
        rc, kc, vc, lc = (a[:, :, c0:c0 + C] for a in (rf, kf, vf, lw))
        cl = torch.cumsum(lc, dim=2)
        clp = torch.cat([torch.zeros_like(cl[:, :, :1]), cl[:, :, :-1]], dim=2)
        total = cl[:, :, -1:]  # (B, H, 1, K)
        inter = _mm(rc * torch.exp(clp), S, tf32x3)
        A = torch.zeros(B, H, C, C)
        for p in range(0, C, sub):
            rp, clp_p, kp = rc[:, :, p:p + sub], clp[:, :, p:p + sub], kc[:, :, p:p + sub]
            wp = torch.exp(lc[:, :, p:p + sub])
            decay = torch.zeros(B, H, sub, sub, K)  # [t, j]: w_{t-1} ⋯ w_{j+1}, j < t
            for t in range(1, sub):
                d = torch.ones(B, H, K)
                for j in range(t - 1, -1, -1):
                    decay[:, :, t, j] = d
                    d = d * wp[:, :, j]
            blk = torch.einsum("bhtk,bhjk,bhtjk->bhtj", rp, kp, decay)
            blk = blk + torch.diag_embed((rp * uf * kp).sum(-1))
            A[:, :, p:p + sub, p:p + sub] = blk
            if p:
                g = clp[:, :, p:p + 1]  # (B, H, 1, K)
                rq = rp * torch.exp(clp_p - g)
                kq = kc[:, :, :p] * torch.exp(g - cl[:, :, :p])
                A[:, :, p:p + sub, :p] = _mm(rq, kq.transpose(-1, -2), tf32x3)
        ys.append(inter + _mm(A, vc, tf32x3))
        kd = kc * torch.exp(total - cl)
        S = torch.exp(total).transpose(-1, -2) * S + _mm(kd.transpose(-1, -2), vc, tf32x3)
    y = torch.cat(ys, dim=2)[:, :, :T]
    return y.to(out_dtype or r.dtype), S
