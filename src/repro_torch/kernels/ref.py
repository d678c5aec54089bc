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


def wkv6_backward_reference(
    r: torch.Tensor,  # (B, H, T, K)
    k: torch.Tensor,  # (B, H, T, K)
    v: torch.Tensor,  # (B, H, T, V)
    log_w: torch.Tensor,  # (B, H, T, K)
    u: torch.Tensor,  # (H, K)
    s0: torch.Tensor,  # (B, H, K, V)
    dy: Optional[torch.Tensor],  # (B, H, T, V) the gradient of y, None for zeros
    ds_final: Optional[torch.Tensor],  # (B, H, K, V) the gradient of S_{T-1}, None for zeros
) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv in r's dtype; dlog_w, du, ds0 fp32) of
    :func:`wkv6_reference`, in fp32, by the passes of the backward kernel.
    With w = exp(log_w), S_{-1} = s0, G_{T-1} = ds_final and a_t = Σ_k r_t u k_t:

    * forward in t, rebuilding S:  dr_t = S_{t-1} dy_t + u ⊙ k_t (dy_t · v_t),
      Q_t = r_t ⊙ (S_{t-1} dy_t), and at the end Q_T = rowsum(ds_final ⊙ S_{T-1});
    * backward in t, with G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ:
      dk_t = r_t ⊙ u (dy_t · v_t) + G_t v_t,  dv_t = a_t dy_t + G_tᵀ k_t,
      R_t = k_t ⊙ (G_t v_t),  dlog_w_t = Σ_{s>t} Q_s − Σ_{j≥t} R_j, each
      step adding Q_{t+1} − R_t (no stored state, no division by w);
    * du = Σ_{b,t} r_t ⊙ k_t (dy_t · v_t), ds0 = G_{-1}."""
    B, H, T, K = r.shape
    rf, kf, vf = (a.float() for a in (r, k, v))
    dyf = torch.zeros_like(vf) if dy is None else dy.float()
    wf = torch.exp(log_w.float())
    uf = u.float()[None]  # (1, H, K)
    dyv = (dyf * vf).sum(-1, keepdim=True)  # (B, H, T, 1)
    S = s0.float()
    dr = torch.empty_like(rf)
    Q = torch.empty_like(rf)
    for t in range(T):
        sdy = torch.einsum("bhkv,bhv->bhk", S, dyf[:, :, t])
        dr[:, :, t] = sdy + uf * kf[:, :, t] * dyv[:, :, t]
        Q[:, :, t] = rf[:, :, t] * sdy
        S = wf[:, :, t, :, None] * S + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    G = torch.zeros_like(S) if ds_final is None else ds_final.float()
    q_next = (G * S).sum(-1)  # Q_T
    a = (rf * uf[:, :, None] * kf).sum(-1, keepdim=True)  # (B, H, T, 1)
    dk, dv, dlog_w = torch.empty_like(kf), torch.empty_like(vf), torch.empty_like(rf)
    acc = torch.zeros_like(q_next)
    for t in range(T - 1, -1, -1):
        gv = torch.einsum("bhkv,bhv->bhk", G, vf[:, :, t])
        dk[:, :, t] = rf[:, :, t] * uf * dyv[:, :, t] + gv
        dv[:, :, t] = a[:, :, t] * dyf[:, :, t] + torch.einsum("bhkv,bhk->bhv", G, kf[:, :, t])
        acc = acc + (q_next - kf[:, :, t] * gv)
        dlog_w[:, :, t] = acc
        q_next = Q[:, :, t]
        G = wf[:, :, t, :, None] * G + rf[:, :, t, :, None] * dyf[:, :, t, None, :]
    du = (rf * kf * dyv).sum((0, 2))
    return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlog_w, du, G


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32's 10 mantissa bits (toward zero), as the tensor cores
    read an operand that is not already TF32."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32x3: bool, cut: bool = False) -> torch.Tensor:
    """a @ b with the operands rounded as the tensor cores see them: with
    ``tf32x3`` each is split into hi = tf32(x) and lo = tf32(x - hi) and the
    product is hi·hi + hi·lo + lo·hi; else one TF32 pass.  tf32 rounds to
    nearest (``cvt.rna``), or with ``cut`` cuts the low bits off."""
    rnd = _tf32_cut if cut else _tf32
    a_hi, b_hi = rnd(a), rnd(b)
    if not tf32x3:
        return a_hi @ b_hi
    a_lo, b_lo = rnd(a - a_hi), rnd(b - b_hi)
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


def chunk_cumsum(lw: torch.Tensor, part: int = 8) -> torch.Tensor:
    """CL (..., C + 1, K) of a chunk's log_w (..., C, K), as every WKV6
    backward kernel forms it: CL[0] = 0 and CL[t + 1] = cl_t, the inclusive
    sum over tokens 0..t, taken within parts of ``part`` tokens and then
    with the totals of the earlier parts added in order.  So cl_prev_t =
    CL[t], cl_t = CL[t + 1] and cl_C = CL[C], each one value."""
    *lead, C, K = lw.shape
    parts = lw.reshape(*lead, C // part, part, K)
    inner = torch.cumsum(parts, dim=-2)
    totals = inner[..., -1, :]
    pre = torch.cumsum(totals, dim=-2) - totals  # the earlier parts' totals
    cl = (pre[..., None, :] + inner).reshape(*lead, C, K)
    return torch.cat([torch.zeros_like(cl[..., :1, :]), cl], dim=-2)


def _decays(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """D[t, j] = w_{j+1} ⋯ w_{t−1} for j < t (0 elsewhere) over a sub-chunk's
    w (..., S, K), twice: multiplied out down each row (from w_{t−1}, for A
    and dr) and down each column (from w_{j+1}, for dk), as the kernel
    carries them."""
    *lead, S, K = w.shape
    rows = torch.zeros(*lead, S, S, K)
    cols = torch.zeros(*lead, S, S, K)
    for t in range(1, S):
        d = torch.ones(*lead, K)
        for j in range(t - 1, -1, -1):
            rows[..., t, j, :] = d
            d = d * w[..., j, :]
    for j in range(S - 1):
        d = torch.ones(*lead, K)
        for t in range(j + 1, S):
            cols[..., t, j, :] = d
            d = d * w[..., t, :]
    return rows, cols


def wkv6_backward_chunked_reference(
    r: torch.Tensor,  # (B, H, T, K)
    k: torch.Tensor,  # (B, H, T, K)
    v: torch.Tensor,  # (B, H, T, V)
    log_w: torch.Tensor,  # (B, H, T, K)
    u: torch.Tensor,  # (H, K)
    s0: torch.Tensor,  # (B, H, K, V)
    dy: Optional[torch.Tensor],  # (B, H, T, V), None for zeros
    ds_final: Optional[torch.Tensor],  # (B, H, K, V), None for zeros
    *,
    chunk: int = 32,
    sub: int = 16,
    tf32x3: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """The gradients of :func:`wkv6_backward_reference` in the chunked form of
    ``csrc/wkv6_bwd.cu``, step for step, for the tests.  Chunks of ``chunk``
    tokens (the last one zero-padded, log_w 0), cl as :func:`chunk_cumsum`
    forms it, w = exp(log_w):

    * two state sweeps: S_in of every chunk from S_out = diag(exp(cl_C)) S_in
      + (k ⊙ exp(cl_C − cl))ᵀ v, and G_out (the gradient of the state after
      the chunk; ds_final for the last) from G_in = diag(exp(cl_C)) G_out +
      (r ⊙ exp(cl_prev))ᵀ dy; ds0 = G_in of chunk 0;
    * per chunk, with dA = dy vᵀ and A the forward's matrix (off-diagonal
      sub-chunk block (r ⊙ exp(cl_prev − g)) (k ⊙ exp(g − cl))ᵀ about g =
      cl_prev at the later sub-chunk's start; diagonal blocks elementwise with
      the decay carried as a product of w's; r·(u ⊙ k) on the diagonal):
      dr = exp(cl_prev) ⊙ (dy S_inᵀ) + intra(dA, k) + u ⊙ k (dy·v),
      dk = exp(cl_C − cl) ⊙ (v G_outᵀ) + intra(dAᵀ, r) + r ⊙ u (dy·v),
      dv = Aᵀ dy + (k ⊙ exp(cl_C − cl)) G_out;
    * dlog_w from Q_t = r_t ⊙ (dr_t − u ⊙ k_t (dy_t·v_t)) and R_t = k_t ⊙
      (dk_t − r_t ⊙ u (dy_t·v_t)): per token Q_{t+1} − R_t summed from the
      end within the chunk (its last token's pair left out), then a carry
      pass adds, from the last chunk back, each chunk's cross pair (the next
      chunk's Q_0, or Q_T = rowsum(ds_final ⊙ S_final), minus its last R) and
      the later chunks' totals.

    The products run through :func:`_mm` with the kernels' split, hi and lo
    cut to TF32 (3xTF32 when ``tf32x3``, else one TF32 pass); the diagonal
    blocks stay in fp32.  Returns (dr, dk, dv in r's dtype; dlog_w, du, ds0
    fp32)."""
    B, H, T, K = r.shape
    C = chunk
    nc = -(-T // C)
    pad = nc * C - T

    def mm(a, b):
        return _mm(a, b, tf32x3, cut=True)

    def chunks(a):
        a = torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
        return a.reshape(B, H, nc, C, a.shape[-1])

    rc, kc, vc, lc = (chunks(a) for a in (r, k, v, log_w))
    dc = chunks(torch.zeros_like(v, dtype=torch.float32) if dy is None else dy)
    uf = u.float()[None, :, None, None, :]  # (1, H, 1, 1, K)
    CL = chunk_cumsum(lc)
    clp, cl, total, g = CL[..., :C, :], CL[..., 1:, :], CL[..., C:, :], CL[..., sub:sub + 1, :]
    kd = kc * torch.exp(total - cl)  # k ⊙ exp(cl_C − cl)
    decay = torch.exp(total).transpose(-1, -2)  # (B, H, nc, K, 1)

    S = s0.float()
    s_in = []
    for c in range(nc):  # the forward sweep
        s_in.append(S)
        S = decay[:, :, c] * S + mm(kd[:, :, c].transpose(-1, -2), vc[:, :, c])
    G = torch.zeros_like(S) if ds_final is None else ds_final.float()
    q_last = (G * S).sum(-1)  # Q_T = rowsum(ds_final ⊙ S_final)
    rd = rc * torch.exp(clp)  # r ⊙ exp(cl_prev)
    g_out = [None] * nc
    for c in range(nc - 1, -1, -1):  # the backward sweep
        g_out[c] = G
        G = decay[:, :, c] * G + mm(rd[:, :, c].transpose(-1, -2), dc[:, :, c])
    ds0 = G
    s_in, g_out = torch.stack(s_in, 2), torch.stack(g_out, 2)  # (B, H, nc, K, V)

    # the chunk-parallel pass
    lo, hi = slice(0, sub), slice(sub, C)
    dA = mm(dc, vc.transpose(-1, -2))  # dy vᵀ, (B, H, nc, C, C)
    bonus = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]  # dy_t · v_t
    rq = rc[..., hi, :] * torch.exp(clp[..., hi, :] - g)  # r ⊙ exp(cl_prev − g), later sub-chunk
    kq = kc[..., lo, :] * torch.exp(g - cl[..., lo, :])  # k ⊙ exp(g − cl), earlier sub-chunk
    A = torch.zeros(B, H, nc, C, C)
    A[..., hi, lo] = mm(rq, kq.transpose(-1, -2))
    intra_dr, intra_dk = torch.zeros_like(rc), torch.zeros_like(kc)
    below = torch.tril(torch.ones(sub, sub), diagonal=-1)
    w = torch.exp(lc)
    for p in (lo, hi):
        rp, kp = rc[..., p, :], kc[..., p, :]
        rows, cols = _decays(w[..., p, :])
        A[..., p, p] = (torch.einsum("...tk,...jk,...tjk->...tj", rp, kp, rows)
                        + torch.diag_embed((rp * uf * kp).sum(-1)))
        dap = dA[..., p, p] * below
        intra_dr[..., p, :] = torch.einsum("...tj,...jk,...tjk->...tk", dap, kp, rows)
        intra_dk[..., p, :] = torch.einsum("...tj,...tk,...tjk->...jk", dap, rp, cols)
    drm = torch.exp(clp) * mm(dc, s_in.transpose(-1, -2))
    drm[..., hi, :] += torch.exp(clp[..., hi, :] - g) * mm(dA[..., hi, lo], kq)
    dkm = torch.exp(total - cl) * mm(vc, g_out.transpose(-1, -2))
    dkm[..., lo, :] += (torch.exp(g - cl[..., lo, :])
                        * mm(dA[..., hi, lo].transpose(-1, -2), rq))
    dr = drm + intra_dr + uf * kc * bonus
    dk = dkm + intra_dk + rc * uf * bonus
    dv = mm(kd, g_out) + mm(A.transpose(-1, -2), dc)

    # dlog_w: per token Q_{t+1} − R_t, summed from the end of each part of 8
    # tokens, then the later parts' totals; a chunk's last pair is the carry's
    Q, R = rc * (drm + intra_dr), kc * (dkm + intra_dk)
    n_last = T - (nc - 1) * C
    D = torch.zeros_like(Q)
    D[..., :-1, :] = Q[..., 1:, :] - R[..., :-1, :]
    D[:, :, -1, n_last - 1:] = 0.0
    parts = D.reshape(B, H, nc, C // 8, 8, K)
    local = parts.flip(-2).cumsum(-2).flip(-2)
    later = local[..., 0, :].flip(-2).cumsum(-2).flip(-2) - local[..., 0, :]
    P = (local + later[..., None, :]).reshape(B, H, nc, C, K)
    r_last = R[:, :, :, C - 1].clone()
    r_last[:, :, -1] = R[:, :, -1, n_last - 1]
    carry = torch.empty(B, H, nc, K)
    run = q_last - r_last[:, :, -1]
    carry[:, :, -1] = run
    for c in range(nc - 2, -1, -1):
        run = (Q[:, :, c + 1, 0] - r_last[:, :, c]) + (P[:, :, c + 1, 0] + run)
        carry[:, :, c] = run
    dlog_w = P + carry[..., None, :]
    du = (rc * kc * bonus).sum((0, 2, 3))

    def tokens(a, dtype):
        return a.reshape(B, H, nc * C, a.shape[-1])[:, :, :T].to(dtype)

    return (tokens(dr, r.dtype), tokens(dk, k.dtype), tokens(dv, v.dtype),
            tokens(dlog_w, torch.float32), du, ds0)


# ---------------------------------------------------------------------------
# the selective scan (Mamba-1): JAX's chunked doubling scan and its gradient
# ---------------------------------------------------------------------------

SCAN_CHUNK = 64  # tokens a chunk of the selective scan: JAX's apply_lm(scan_chunk_size=64)


def scan_chunk(decay: torch.Tensor, inp: torch.Tensor, h0: torch.Tensor):
    """h_t = decay_t * h_{t-1} + inp_t within a chunk (axis 1): a log-step
    doubling (Hillis-Steele) scan with JAX's ``associative_scan`` combine
    ``(a1, b1)o(a2, b2) = (a1 a2, a2 b1 + b2)``; no decay-ratio divisions.

    decay/inp: (B, Q, ...); h0: (B, ...).  Returns (states (B, Q, ...), h_Q).
    """
    a, b = decay, inp
    Q, step = a.shape[1], 1
    while step < Q:  # element t takes in the prefix that ends at t - step
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    states = a * h0[:, None] + b
    return states, states[:, -1]


def chunked_scan(aux, h0: torch.Tensor, chunk_fn, chunk: int):
    """Run ``chunk_fn(h, aux_chunk) -> (h_next, y_chunk (B, Q, ...))`` over the
    chunks of the (B, S, ...) tensors ``aux`` in order, threading the state,
    so the (B, S, ...) state tensor is never formed whole.  The chunk is
    JAX's: ``chunk`` if it divides S, else S when S < chunk, else
    gcd(S, chunk).  Returns (y (B, S, ...), final state)."""
    S = aux[0].shape[1]
    if S % chunk:
        chunk = S if S < chunk else math.gcd(S, chunk)
    h, ys = h0, []
    for start in range(0, S, chunk):
        h, y = chunk_fn(h, tuple(t[:, start:start + chunk] for t in aux))
        ys.append(y)
    return torch.cat(ys, dim=1), h


def selective_scan_reference(dt, dtx, Bm, Cm, A, h0):
    """The selective scan of ``mamba_block``, in fp32: per channel d and
    state n, h_t = exp(dt_t A) h_{t-1} + dtx_t B_t and y_t = h_t . C_t, in
    chunks of ``SCAN_CHUNK`` tokens (JAX's rule when it does not divide S).

    dt, dtx: (B, S, d_in); Bm, Cm: (B, S, N); A: (d_in, N); h0: (B, d_in, N).
    Returns (y (B, S, d_in), h_S)."""
    def chunk_fn(h, ac):
        dt_c, dtx_c, b_c, c_c = ac  # (B,Q,d_in), (B,Q,d_in), (B,Q,N), (B,Q,N)
        decay = torch.exp(dt_c[..., None] * A)  # (B, Q, d_in, N)
        binp = dtx_c[..., None] * b_c[:, :, None, :]
        states, h2 = scan_chunk(decay, binp, h)
        return h2, torch.einsum("bqdn,bqn->bqd", states, c_c)

    return chunked_scan((dt, dtx, Bm, Cm), h0, chunk_fn, SCAN_CHUNK)


def selective_scan_backward_reference(dt, dtx, Bm, Cm, A, h0, dy, dh=None):
    """The gradients of :func:`selective_scan_reference`'s (y, h_S) given dy
    (B, S, d_in) and dh (B, d_in, N; None for zero): (ddt, ddtx (B, S,
    d_in), dB, dC (B, S, N), dA (d_in, N), dh0 (B, d_in, N)), fp32.  A plain
    reverse sweep: the state before every 64-token chunk is kept, each chunk
    is run forward again from it and walked back token by token with
    G_t = C_t dy_t + a_{t+1} G_{t+1} (G = dh after the last token),
    da_t = G_t h_{t-1}, ddt_t = sum_n da_t a_t A, dA = sum_{b,t} da_t a_t
    dt_t, ddtx_t = sum_n G_t B_t, dB_t = sum_d G_t dtx_t, dC_t = sum_d dy_t
    h_t and dh0 = a_0 G_0."""
    dt, dtx, Bm, Cm, A = (t.float() for t in (dt, dtx, Bm, Cm, A))
    dy = dy.float()
    B, S, D = dt.shape

    def step(h, t):
        return torch.exp(dt[:, t, :, None] * A) * h + dtx[:, t, :, None] * Bm[:, t, None, :]

    starts, h = [], h0.float()
    for t in range(S):  # the state before each chunk
        if t % SCAN_CHUNK == 0:
            starts.append(h)
        h = step(h, t)
    ddt, ddtx = torch.zeros_like(dt), torch.zeros_like(dtx)
    dB, dC, dA = torch.zeros_like(Bm), torch.zeros_like(Cm), torch.zeros_like(A)
    carry = torch.zeros_like(starts[0]) if dh is None else dh.float()
    for c in reversed(range(len(starts))):
        t0 = c * SCAN_CHUNK
        hs = [starts[c]]
        for t in range(t0, min(t0 + SCAN_CHUNK, S)):
            hs.append(step(hs[-1], t))
        for i in reversed(range(len(hs) - 1)):
            t = t0 + i
            a = torch.exp(dt[:, t, :, None] * A)
            g = Cm[:, t, None, :] * dy[:, t, :, None] + carry
            da = g * hs[i] * a
            ddt[:, t] = (da * A).sum(-1)
            dA += (da * dt[:, t, :, None]).sum(0)
            ddtx[:, t] = (g * Bm[:, t, None, :]).sum(-1)
            dB[:, t] = (g * dtx[:, t, :, None]).sum(1)
            dC[:, t] = (dy[:, t, :, None] * hs[i + 1]).sum(1)
            carry = a * g
    return ddt, ddtx, dB, dC, dA, carry


# ---------------------------------------------------------------------------
# the selective-scan kernels' chunked algebra, mirrored on the CPU
# ---------------------------------------------------------------------------

KERNEL_CHUNK = 64  # tokens between the states the kernels keep (selective_scan.CHUNK)
KERNEL_SUB = 16  # tokens whose a_t and h_t the backward kernel holds in registers


def _scan_steps(dt, dtx, Bm, A):
    """a_t = exp(dt_t A) and dtx_t B_t as functions of t, each (B, d_in, N)."""
    return (lambda t: torch.exp(dt[:, t, :, None] * A),
            lambda t: dtx[:, t, :, None] * Bm[:, t, None, :])


def selective_scan_chunked_reference(dt, dtx, Bm, Cm, A, h0, *, chunk: int = KERNEL_CHUNK):
    """The forward kernel's algebra (``csrc/selective_scan.cu``) token by
    token in fp32.  Returns (y (B, S, d_in), h_S, hs (B, ceil(S / chunk),
    d_in, N): the state before every chunk-th token)."""
    dt, dtx, Bm, Cm, A = (t.float() for t in (dt, dtx, Bm, Cm, A))
    B, S, D = dt.shape
    decay, inp = _scan_steps(dt, dtx, Bm, A)
    y = torch.empty_like(dt)
    hs = torch.empty((B, -(-S // chunk), D, A.shape[1]))
    h = h0.float()
    for t in range(S):
        if t % chunk == 0:
            hs[:, t // chunk] = h
        h = decay(t) * h + inp(t)
        y[:, t] = (h * Cm[:, t, None, :]).sum(-1)
    return y, h, hs


def selective_scan_backward_chunked_reference(dt, dtx, Bm, Cm, A, h0, dy, dh=None, *,
                                              chunk: int = KERNEL_CHUNK, sub: int = KERNEL_SUB,
                                              hs: Optional[torch.Tensor] = None):
    """The backward kernel's algebra (``csrc/selective_scan_bwd.cu``) in
    fp32, for :func:`selective_scan_backward_reference`'s gradients: the
    chunks in reverse, each run forward from its saved state in ``hs`` (the
    forward's, made here when None) to the first state of each ``sub``-token
    sub-chunk, then each sub-chunk, last first, run again from its first
    state keeping a_t and h_t, and walked back from the carry (dh, or zero):
    G_t = C_t dy_t + carry, da = G_t h_{t-1} a_t, carry = a_t G_t.  dA is
    summed per row and then over the rows in order; dh0 is the last carry."""
    if chunk % sub:
        raise ValueError(f"a chunk of {chunk} tokens is not whole sub-chunks of {sub}")
    dt, dtx, Bm, Cm, A, dy = (t.float() for t in (dt, dtx, Bm, Cm, A, dy))
    B, S, D = dt.shape
    decay, inp = _scan_steps(dt, dtx, Bm, A)
    if hs is None:
        hs = selective_scan_chunked_reference(dt, dtx, Bm, Cm, A, h0, chunk=chunk)[2]
    carry = torch.zeros_like(hs[:, 0]) if dh is None else dh.float()
    ddt, ddtx = torch.empty_like(dt), torch.empty_like(dtx)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    da_rows = torch.zeros_like(hs[:, 0])
    for c0 in range((S - 1) // chunk * chunk, -1, -chunk):
        firsts, h = [hs[:, c0 // chunk]], hs[:, c0 // chunk]
        for u0 in range(c0 + sub, min(c0 + chunk, S), sub):
            for t in range(u0 - sub, u0):
                h = decay(t) * h + inp(t)
            firsts.append(h)
        for u0, first in reversed(list(zip(range(c0, S, sub), firsts))):
            ts = range(u0, min(u0 + sub, S))
            a_s, h_s = [], [first]
            for t in ts:
                a_s.append(decay(t))
                h_s.append(a_s[-1] * h_s[-1] + inp(t))
            for i in reversed(range(len(ts))):
                t = ts[i]
                g = Cm[:, t, None, :] * dy[:, t, :, None] + carry
                da = g * h_s[i] * a_s[i]
                ddt[:, t] = (da * A).sum(-1)
                ddtx[:, t] = (g * Bm[:, t, None, :]).sum(-1)
                da_rows = da_rows + da * dt[:, t, :, None]
                dB[:, t] = (g * dtx[:, t, :, None]).sum(1)
                dC[:, t] = (dy[:, t, :, None] * h_s[i + 1]).sum(1)
                carry = a_s[i] * g
    dA = torch.zeros_like(A)
    for b in range(B):
        dA = dA + da_rows[b]
    return ddt, ddtx, dB, dC, dA, carry
