"""GQA/MQA, cross- and MLA attention (PyTorch twin of
``repro.models.attention``).

Cache-polymorphic like the JAX version:

* ``cache=None``            — training / scoring over a full sequence
* ``cache=(…), pos=None``   — prefill: full sequence, cache slots [0:S] written
* ``cache=(…), pos=int``    — decode: one token at position ``pos``

Shapes: x (B, S, d); GQA cache k/v (B, S_max, Hkv, Dh), the JAX layout; MLA
cache (c_kv (B, S_max, R), k_rope (B, S_max, Dr)).  The cache is updated in
place with index writes (JAX's cache is functional).

Train and prefill attention go through :func:`repro_torch.kernels.ops.attention`
(the CUDA flash-attention kernel on the card), where the JAX model path uses
XLA's ``sdpa_chunked``; the kernel keeps the probabilities in fp32 before
P·V, where ``sdpa_chunked`` casts them to the compute dtype.  Decode at
``pos > 0`` is outside the kernel's contract (its q and k positions both
start at 0), so it is plain torch here, as it is XLA in JAX.

``causal=False`` (whisper's encoder) is full attention through the same
kernel.  Whisper's cross-attention (:func:`cross_attention`) attends from
the decoder to the encoder's output, Sq != Sk, always through the kernel
with ``causal=False``: in prefill and at every decode step, where the
cross K/V are recomputed from the encoder output as JAX's
``whisper.decode`` does; on a model axis it is head-parallel too, over
the whole encoder output that every rank holds.

MLA (DeepSeek-V3) trains and prefills in the expanded form, with query and
key heads of nope + rope = 192 and value heads of 128: the flash kernel
takes only v.shape == k.shape, so that attention is plain torch
(:func:`_sdpa_chunked`, JAX's ``sdpa_chunked``), and a Dq != Dv kernel is
ROADMAP B.1's.  Decode is the absorbed form over the compressed cache.
Its two RMSNorms (``q_norm``, ``kv_norm``) go through the RMSNorm kernel.

On a rank of a ``model`` axis (``dist.tensor_parallel``), training runs
head-parallel where the axis divides the query heads: the rank's slice of
``wq`` (MLA: ``wuq``, ``wuk``, ``wuv``) is a set of whole heads, ``wo``
is row-parallel and its partial sums are all-reduced, and
``ops.attention`` launches the flash kernel at the rank's head counts.
GQA's ``wk``/``wv`` are local where the axis divides the kv heads too;
else (kv heads cut inside ``head_dim``, or fewer kv heads than ranks) they
are gathered and each rank takes the kv heads its query heads read.  MLA's
down projections and norms run on the replicated residual stream with
gathered weights.  Where the axis does not divide the query heads, every
rank computes the whole attention from gathered weights.

Serving on such a rank: a GQA layer's cache holds the kv heads that the
rank's query heads read (:func:`kv_heads`: ``kv0 .. kv1``): prefill
writes them beside the flash kernel's call on the rank's heads, and a
decode step reads them for the rank's query heads, as on one device;
where ``cache_specs`` cuts inside a kv head (``head_dim``, one kv head
over four ranks) the rank keeps that head whole.  MLA's latents come from the gathered down projections on the
replicated stream, so every rank writes the same whole ``c_kv`` and
``k_rope`` (``cache_specs`` cuts their sequence dim); its absorbed decode
takes the rank's heads of ``wuk``/``wuv`` and ends in the row-parallel
``wo``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..dist import tensor_parallel as tp
from ..kernels import ops
from .layers import Norm, _param, apply_rope, dense_init, softcap

ATTN_Q_CHUNK = 1024  # query block of _sdpa_chunked, as JAX's


def _mask_bias(q_pos, kv_pos, window=None, valid_len=None) -> torch.Tensor:
    """Additive fp32 mask: causal + sliding window (None: none) + cache validity."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    ok = k <= q
    if window is not None:
        ok &= k > q - window
    if valid_len is not None:
        ok &= k < valid_len
    return torch.where(ok, 0.0, -1e30).float()


def kv_heads(cfg, size: int, index: int) -> Tuple[int, int]:
    """(kv0, kv1): the kv heads that the query heads of the rank at ``model``
    coordinate ``index`` of an axis of ``size`` read, where the axis divides
    the query heads; all of them where it does not (every rank then
    computes the whole attention)."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if size <= 1 or hq % size:
        return 0, hkv
    g, n = hq // hkv, hq // size
    return index * n // g, ((index + 1) * n - 1) // g + 1


def _decode_attention(q, ck, cv, pos: int, window: Optional[int], cap: Optional[float],
                      idx=None):
    """q (B, 1, Hq, D) over the cache's first pos+1 slots; returns (B, 1, Hq, D).
    ``idx`` (a rank's query heads whose kv heads do not fall in equal
    groups) gives each query head's kv head in the cache.

    Slots past ``pos`` carry a -1e30 mask in JAX and so a weight of exactly
    zero; they are left out here instead of being masked, and without a
    window the remaining mask is all zeros and is left out too."""
    B, S, hq, hd = q.shape
    kv_k = ck[:, : pos + 1].to(q.dtype)
    kv_v = cv[:, : pos + 1].to(q.dtype)
    if idx is not None:
        kv_k, kv_v = kv_k[:, :, idx], kv_v[:, :, idx]
    hkv = kv_k.shape[2]
    g = hq // hkv
    qg = q.reshape(B, S, hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B, hkv, g, S, D)
    kk = kv_k.permute(0, 2, 1, 3)[:, :, None]  # (B, hkv, 1, Sk, D)
    vv = kv_v.permute(0, 2, 1, 3)[:, :, None]
    sc = (qg.float() @ kk.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    sc = softcap(sc, cap)
    if window is not None:
        kv_pos = torch.arange(pos + 1, device=q.device)
        q_pos = torch.arange(pos, pos + 1, device=q.device)
        sc = sc + _mask_bias(q_pos, kv_pos, window)
    pr = torch.softmax(sc, dim=-1).to(q.dtype)
    out = pr @ vv  # (B, hkv, g, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, hq, hd)


def gqa_attention(
    mod: "GQAAttention",
    x: torch.Tensor,
    cfg,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    pos: Optional[int] = None,
) -> torch.Tensor:
    """Returns y (B, S, d); ``cache`` is written in place.  ``window`` None
    means no sliding window; ``causal=False`` is full attention (train and
    prefill; a decode step attends to the slots before it)."""
    B, S, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    axis = tp.axis_of(mod)
    w = {n: getattr(mod, n) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
         if hasattr(mod, n)}
    heads = axis is not None and hq % axis.size == 0 and tp.sliced(mod.wq, -1)
    idx = None
    if heads:  # this rank's query heads, and the kv heads they read
        g, hq = hq // hkv, hq // axis.size
        kv0, kv1 = kv_heads(cfg, axis.size, axis.index)
        x = tp.copy_to(x, axis)
        if not (hkv % axis.size == 0 and tp.sliced(mod.wk, -1)):
            # wk/wv (and bk/bv) cut inside head_dim, or fewer kv heads than
            # ranks: gathered whole, then the columns of kv heads kv0 .. kv1
            for n in ("wk", "wv", "bk", "bv"):
                if n in w:
                    w[n] = tp.partial(w[n], axis)[..., kv0 * hd:kv1 * hd]
        hkv = kv1 - kv0
    elif axis is not None:  # the whole attention on every rank
        w = {n: tp.whole(p, axis) for n, p in w.items()}

    q = x @ w["wq"].to(x.dtype)
    k = x @ w["wk"].to(x.dtype)
    v = x @ w["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + w["bq"].to(x.dtype)
        k = k + w["bk"].to(x.dtype)
        v = v + w["bv"].to(x.dtype)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)
    if heads:
        # the kv head of each local query head; where they do not fall in
        # equal groups, each query head reads its own copy of its kv head
        idx = [(axis.index * hq + i) // g - kv0 for i in range(hq)]
        if not (hq % hkv or idx != [i // (hq // hkv) for i in range(hq)]):
            idx = None

    if pos is None:  # train / prefill: positions 0..S-1
        q_pos = torch.arange(S, device=x.device)
    else:
        q_pos = torch.arange(pos, pos + 1, device=x.device)
    if cfg.use_rope:
        q = apply_rope(q, q_pos, cfg.rope_theta)
        k = apply_rope(k, q_pos, cfg.rope_theta)

    if cache is not None:
        ck, cv = cache
        start = 0 if pos is None else pos
        ck[:, start : start + S] = k.to(ck.dtype)
        cv[:, start : start + S] = v.to(cv.dtype)

    if pos is None:
        if idx is not None:
            k, v = k[:, :, idx], v[:, :, idx]
        out = ops.attention(q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap)
    else:
        out = _decode_attention(q, ck, cv, pos, window, cfg.attn_softcap, idx)
    out = out.reshape(B, S, hq * hd) @ w["wo"].to(x.dtype)
    return tp.reduce_from(out, axis) if heads else out


class GQAAttention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = _param((d, hq * hd), cfg, device)
        self.wk = _param((d, hkv * hd), cfg, device)
        self.wv = _param((d, hkv * hd), cfg, device)
        self.wo = _param((hq * hd, d), cfg, device)
        if cfg.qkv_bias:
            self.bq = _param((hq * hd,), cfg, device)
            self.bk = _param((hkv * hd,), cfg, device)
            self.bv = _param((hkv * hd,), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init(w.data, gen)
        if self.cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                nn.init.zeros_(b)

    def forward(self, x, *, window=None, causal=True, cache=None, pos=None):
        return gqa_attention(self, x, self.cfg, window=window, causal=causal, cache=cache,
                             pos=pos)


# ---------------------------------------------------------------------------
# cross-attention (whisper's decoder over the encoder output)
# ---------------------------------------------------------------------------

def cross_attention(mod: "CrossAttention", x: torch.Tensor, enc: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, d) attends to all of enc (B, Se, d): no mask, no cache, no
    position; returns (B, S, d).  On a model axis that divides the heads
    it is head-parallel, as :func:`gqa_attention`: the rank's heads of
    ``wq``/``wk``/``wv`` from the replicated ``x`` and ``enc``, the
    row-parallel ``wo`` and its all-reduce; else the whole attention on
    every rank from gathered weights."""
    B, S, _ = x.shape
    Se = enc.shape[1]
    hq, hd = cfg.num_heads, cfg.head_dim
    axis = tp.axis_of(mod)
    w = {n: getattr(mod, n) for n in ("wq", "wk", "wv", "wo")}
    heads = axis is not None and hq % axis.size == 0 and tp.sliced(mod.wq, -1)
    if heads:
        hq //= axis.size
        x, enc = tp.copy_to(x, axis), tp.copy_to(enc, axis)
    elif axis is not None:
        w = {n: tp.whole(p, axis) for n, p in w.items()}
    q = (x @ w["wq"].to(x.dtype)).reshape(B, S, hq, hd)
    k = (enc @ w["wk"].to(x.dtype)).reshape(B, Se, hq, hd)
    v = (enc @ w["wv"].to(x.dtype)).reshape(B, Se, hq, hd)
    out = ops.attention(q, k, v, causal=False)
    out = out.reshape(B, S, hq * hd) @ w["wo"].to(x.dtype)
    return tp.reduce_from(out, axis) if heads else out


class CrossAttention(nn.Module):
    """Parameters named as JAX's ``init_cross``: ``wq``, ``wk``, ``wv``
    (d -> Hq·Dh) and ``wo``, no bias."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        d, hdim = cfg.d_model, cfg.num_heads * cfg.head_dim
        self.wq = _param((d, hdim), cfg, device)
        self.wk = _param((d, hdim), cfg, device)
        self.wv = _param((d, hdim), cfg, device)
        self.wo = _param((hdim, d), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init(w.data, gen)

    def forward(self, x, enc):
        return cross_attention(self, x, enc, self.cfg)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def _sdpa_chunked(q, k, v, scale: float, chunk: int = ATTN_Q_CHUNK) -> torch.Tensor:
    """Exact causal attention over query blocks of ``chunk`` rows, q and k
    positions both 0..S-1: q (B, S, H, Dq), k (B, S, H, Dq), v (B, S, H, Dv)
    -> (B, S, H, Dv).  fp32 scores (JAX's ``preferred_element_type``), the
    probabilities cast to q's dtype before P·V, as ``sdpa_chunked``.  A
    block attends to keys 0..q0+chunk-1 only: the keys past it carry JAX's
    -1e30 mask, a weight of exactly zero."""
    B, S, H, _ = q.shape
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, S, D)
    out = []
    for q0 in range(0, S, chunk):
        q1 = min(q0 + chunk, S)
        sc = (qh[:, :, q0:q1].float() @ kh[:, :, :q1].float().transpose(-1, -2)) * scale
        sc.add_(_mask_bias(torch.arange(q0, q1, device=q.device),
                           torch.arange(q1, device=q.device)))
        pr = torch.softmax(sc, dim=-1).to(q.dtype)
        del sc
        out.append(pr @ vh[:, :, :q1])
    return torch.cat(out, dim=2).permute(0, 2, 1, 3)


def mla_attention(
    mod: "MLAAttention",
    x: torch.Tensor,
    cfg,
    *,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    pos: Optional[int] = None,
) -> torch.Tensor:
    """Returns y (B, S, d); ``cache`` (c_kv, k_rope) is written in place.
    Train and prefill use the expanded form; decode the absorbed form over
    the compressed cache."""
    m = cfg.mla
    B, S, d = x.shape
    h = cfg.num_heads
    R, nope, rdim, vdim = m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(nope + rdim)
    axis = tp.axis_of(mod)
    w = {n: getattr(mod, n) for n in ("wuq", "wuk", "wuv", "wo")}
    heads = axis is not None and h % axis.size == 0 and tp.sliced(mod.wuq, -1)
    if heads:
        h //= axis.size
    elif axis is not None:  # the whole attention on every rank
        w = {n: tp.whole(p, axis) for n, p in w.items()}

    # wdq and wdkv (cut along their latent columns, wdkv through its kv/rope
    # boundary) and the norms run on the replicated residual stream: gathered
    cq = mod.q_norm(x @ tp.whole(mod.wdq, axis).to(x.dtype))
    if heads:
        cq = tp.copy_to(cq, axis)
    qfull = (cq @ w["wuq"].to(x.dtype)).reshape(B, S, h, nope + rdim)
    q_nope, q_rope = qfull[..., :nope], qfull[..., nope:]

    dkv = x @ tp.whole(mod.wdkv, axis).to(x.dtype)
    # c_kv is a slice of rows R + rdim wide; the RMSNorm kernel takes contiguous rows
    c_kv = mod.kv_norm(dkv[..., :R].contiguous())
    k_rope = dkv[..., R:]

    if pos is None:
        q_pos = torch.arange(S, device=x.device)
    else:
        q_pos = torch.arange(pos, pos + 1, device=x.device)
    q_rope = apply_rope(q_rope, q_pos, cfg.rope_theta)
    k_rope = apply_rope(k_rope[..., None, :], q_pos, cfg.rope_theta)[..., 0, :]
    if heads:
        c_kv, k_rope = tp.copy_to(c_kv, axis), tp.copy_to(k_rope, axis)

    if cache is not None:
        cc, cr = cache
        start = 0 if pos is None else pos
        cc[:, start : start + S] = c_kv.to(cc.dtype)
        cr[:, start : start + S] = k_rope.to(cr.dtype)

    if pos is not None:  # decode: absorbed, over the cache's first pos+1 slots
        kv_c = cc[:, : pos + 1].to(x.dtype)
        kv_r = cr[:, : pos + 1].to(x.dtype)
        wuk = w["wuk"].to(x.dtype).reshape(R, h, nope)  # the rank's heads on a model axis
        q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, wuk)
        sc = torch.einsum("bqhr,bkr->bhqk", q_abs.float(), kv_c.float())
        sc = sc + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), kv_r.float())
        pr = torch.softmax(sc * scale, dim=-1).to(x.dtype)
        out_c = torch.einsum("bhqk,bkr->bqhr", pr, kv_c)
        wuv = w["wuv"].to(x.dtype).reshape(R, h, vdim)
        out = torch.einsum("bqhr,rhv->bqhv", out_c, wuv)
    else:  # train / prefill: expanded
        k_nope = (c_kv @ w["wuk"].to(x.dtype)).reshape(B, S, h, nope)
        v = (c_kv @ w["wuv"].to(x.dtype)).reshape(B, S, h, vdim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, rdim)], dim=-1)
        out = _sdpa_chunked(q, k, v, scale)
    out = out.reshape(B, S, h * vdim) @ w["wo"].to(x.dtype)
    return tp.reduce_from(out, axis) if heads else out


class MLAAttention(nn.Module):
    """Parameters named as JAX's ``init_mla``: ``wdq``, ``q_norm.scale``,
    ``wuq``, ``wdkv``, ``kv_norm.scale``, ``wuk``, ``wuv``, ``wo``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.wdq = _param((d, m.q_lora_rank), cfg, device)
        self.q_norm = Norm(cfg, device, width=m.q_lora_rank, kind="rmsnorm")
        self.wuq = _param((m.q_lora_rank, h * qk), cfg, device)
        self.wdkv = _param((d, m.kv_lora_rank + m.qk_rope_head_dim), cfg, device)
        self.kv_norm = Norm(cfg, device, width=m.kv_lora_rank, kind="rmsnorm")
        self.wuk = _param((m.kv_lora_rank, h * m.qk_nope_head_dim), cfg, device)
        self.wuv = _param((m.kv_lora_rank, h * m.v_head_dim), cfg, device)
        self.wo = _param((h * m.v_head_dim, d), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The projections (the two norms are reset as modules of their own)."""
        for w in (self.wdq, self.wuq, self.wdkv, self.wuk, self.wuv, self.wo):
            dense_init(w.data, gen)

    def forward(self, x, *, window=None, cache=None, pos=None):
        """``window`` is accepted for the GQA signature; MLA has none."""
        return mla_attention(self, x, self.cfg, cache=cache, pos=pos)
