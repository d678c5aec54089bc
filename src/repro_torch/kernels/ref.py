"""Plain PyTorch versions of the hand-written kernels — their contracts.

The forward versions are line for line the math of ``repro.kernels.ref``:
they materialise the full score matrix and reduce in fp32, so the tests hold
the kernels against the most obviously correct implementation (WKV6 steps
through the sequence one token at a time).  The backward versions of flash
attention and RMSNorm, which the JAX package leaves to XLA, are their
explicit gradient formulas (flash attention's from o, the row log-sum-exp
and dO).  On a CPU tensor the kernel wrappers run these; on the card
``chip_smoke.py`` compares each kernel with them.  Two CPU mirrors of a
kernel's own algebra, used by the tests only, follow the CUDA kernels step
for step: the chunked WKV6 and the tiles of the bf16 flash-attention
backward.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

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
    ok = _visible(torch.arange(Sq, device=q.device), torch.arange(Sk, device=q.device),
                  causal, window)
    return s, ok, t


def _visible(q_pos, k_pos, causal, window):
    """The (len(q_pos), len(k_pos)) mask of the (q, k) pairs attention sees."""
    ok = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


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


def dkdv_q_tiles(k0: int, Sq: int, Sk: int, causal: bool, window: Optional[int],
                 tile: int = 64) -> range:
    """The q tiles that the bf16 dK/dV kernel walks for the key tile at k0."""
    k_last = min(k0 + tile, Sk) - 1
    q_end = Sq if window is None else min(Sq, k_last + window)
    return range(k0 // tile if causal else 0, -(-q_end // tile))


def dq_key_tiles(q0: int, Sq: int, Sk: int, causal: bool, window: Optional[int],
                 tile: int = 64) -> range:
    """The key tiles that the bf16 dQ kernel walks for the q tile at q0."""
    end = -(-Sk // tile)
    if causal:
        end = min(end, (min(q0 + tile, Sq) - 1) // tile + 1)
    begin = 0 if window is None or q0 - window + 1 <= 0 else (q0 - window + 1) // tile
    return range(begin, end)


def mha_backward_tiled(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    o: torch.Tensor,  # (B, Hq, Sq, D)
    lse: torch.Tensor,  # (B, Hq, Sq) fp32
    do: torch.Tensor,  # (B, Hq, Sq, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    tile: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward kernels of ``csrc/flash_attention_bwd.cu`` step for
    step, for the tests: the same (q tile, key tile) pairs of ``tile`` rows
    and the same products, in fp32.

    dK/dV: per key tile, the q tiles of :func:`dkdv_q_tiles`; S^T and dP^T
    formed once per pair, P^T and dS^T rounded to bf16 (for bf16 inputs)
    before dV += P^T dO and dK += dS^T Q, into one fp32 part per q head,
    summed over each kv group in head order.  dQ: per q tile, the key tiles
    of :func:`dq_key_tiles`; S and dP again, dS rounded to bf16 before
    dQ += dS K.  Gradients in the inputs' dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if q.dtype == torch.bfloat16:
        def rnd(x):
            return x.to(torch.bfloat16).float()
    else:
        def rnd(x):
            return x
    qf, dof, lsef = q.float(), do.float(), lse.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    delta = (dof * o.float()).sum(-1)

    def p_ds(q0, k0):
        """P and dS of the tile pair, (B, Hq, q rows, keys), zero where masked."""
        qs, ks = slice(q0, min(q0 + tile, Sq)), slice(k0, min(k0 + tile, Sk))
        z = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, qs], kf[:, :, ks]) * scale
        deriv = 1.0
        if softcap is not None:
            t = torch.tanh(z / softcap)
            z, deriv = softcap * t, 1.0 - t * t
        ok = _visible(torch.arange(qs.start, qs.stop), torch.arange(ks.start, ks.stop),
                      causal, window)
        p = torch.where(ok, torch.exp(z - lsef[:, :, qs, None]), 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, qs], vf[:, :, ks])
        return qs, ks, p, p * (dp - delta[:, :, qs, None]) * deriv * scale

    dk_part = torch.zeros(B, Hq, Sk, D)
    dv_part = torch.zeros(B, Hq, Sk, D)
    for k0 in range(0, Sk, tile):
        for qt in dkdv_q_tiles(k0, Sq, Sk, causal, window, tile):
            qs, ks, p, ds = p_ds(qt * tile, k0)
            pt, dst = rnd(p.transpose(-1, -2)), rnd(ds.transpose(-1, -2))  # P^T, dS^T
            dv_part[:, :, ks] += pt @ dof[:, :, qs]
            dk_part[:, :, ks] += dst @ qf[:, :, qs]
    dq = torch.zeros(B, Hq, Sq, D)
    for q0 in range(0, Sq, tile):
        for kt in dq_key_tiles(q0, Sq, Sk, causal, window, tile):
            qs, ks, _, ds = p_ds(q0, kt * tile)
            dq[:, :, qs] += rnd(ds) @ kf[:, :, ks]

    def group_sum(part):
        part = part.reshape(B, Hkv, group, Sk, D)
        acc = part[:, :, 0]
        for hg in range(1, group):
            acc = acc + part[:, :, hg]
        return acc

    return (dq.to(q.dtype), group_sum(dk_part).to(k.dtype), group_sum(dv_part).to(v.dtype))


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


def rmsnorm_bwd_team_rows(rows: int, rows_per_block: int, teams: int,
                          rows_per_step: int) -> List[List[List[int]]]:
    """The rows of each team of each block of ``csrc/rmsnorm_bwd.cu``, in the
    order the team takes them: block b starts at b rows_per_block, and at
    step k team t takes rows start + (k teams + t) rows_per_step + j for
    j < rows_per_step, up to the block's end."""
    blocks = -(-rows // rows_per_block)
    steps = rows_per_block // (teams * rows_per_step)
    out = []
    for b in range(blocks):
        start, end = b * rows_per_block, min((b + 1) * rows_per_block, rows)
        out.append([[row for k in range(steps) for j in range(rows_per_step)
                     for row in [start + (k * teams + t) * rows_per_step + j] if row < end]
                    for t in range(teams)])
    return out


def rmsnorm_backward_blocked(
    x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, eps: float = 1e-6, *,
    rows_per_block: int, teams: int, rows_per_step: int, phases: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RMSNorm backward with dscale summed in the order of
    ``csrc/rmsnorm_bwd.cu`` under the split ``rmsnorm.bwd_plan`` gives: each
    team adds g x r over its rows (:func:`rmsnorm_bwd_team_rows`) and each
    block adds its teams in order into one partial row; then, per column,
    ``phases`` sums each add every phases-th partial row in order (phase q:
    rows q, q + phases, ..) and the phase sums are added in order; all in
    fp32.  dx is the plain version's: it has no sum across rows."""
    dx, _ = rmsnorm_backward_reference(x, scale, g, eps=eps)
    d = x.shape[-1]
    xf, gf = x.float().reshape(-1, d), g.float().reshape(-1, d)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    terms = gf * xf * r  # each row's share of dscale
    parts = []
    for block in rmsnorm_bwd_team_rows(xf.shape[0], rows_per_block, teams, rows_per_step):
        team_sums = []
        for team in block:
            acc = torch.zeros(d)
            for row in team:
                acc = acc + terms[row]
            team_sums.append(acc)
        parts.append(_sum_in_order(team_sums))
    zero = torch.zeros(d)
    phase_sums = [_sum_in_order([zero] + parts[q::phases]) for q in range(phases)]
    return dx, _sum_in_order(phase_sums).to(scale.dtype)


def _sum_in_order(rows: List[torch.Tensor]) -> torch.Tensor:
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return acc


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
