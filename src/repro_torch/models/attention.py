"""GQA/MQA attention (PyTorch twin of the GQA part of ``repro.models.attention``).

Cache-polymorphic like the JAX version:

* ``cache=None``            — training / scoring over a full sequence
* ``cache=(k, v), pos=None`` — prefill: full sequence, cache slots [0:S] written
* ``cache=(k, v), pos=int``  — decode: one token at position ``pos``

Shapes: x (B, S, d); cache k/v (B, S_max, Hkv, Dh), the JAX layout.  The
cache is updated in place with index writes (JAX's cache is functional).

Train and prefill attention go through :func:`repro_torch.kernels.ops.attention`
(the CUDA flash-attention kernel on the card), where the JAX model path uses
XLA's ``sdpa_chunked``; the kernel keeps the probabilities in fp32 before
P·V, where ``sdpa_chunked`` casts them to the compute dtype.  Decode at
``pos > 0`` is outside the kernel's contract (its q and k positions both
start at 0), so it is plain torch here, as it is XLA in JAX.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels import ops
from .layers import _param, apply_rope, dense_init, softcap


def _mask_bias(q_pos, kv_pos, window, valid_len=None) -> torch.Tensor:
    """Additive fp32 mask: causal + sliding window + cache validity."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    ok = (k <= q) & (k > q - window)
    if valid_len is not None:
        ok &= k < valid_len
    return torch.where(ok, 0.0, -1e30).float()


def _decode_attention(q, ck, cv, pos: int, window: Optional[int], cap: Optional[float]):
    """q (B, 1, Hq, D) over the cache's first pos+1 slots; returns (B, 1, Hq, D).

    Slots past ``pos`` carry a -1e30 mask in JAX and so a weight of exactly
    zero; they are left out here instead of being masked, and without a
    window the remaining mask is all zeros and is left out too."""
    B, S, hq, hd = q.shape
    hkv = ck.shape[2]
    g = hq // hkv
    kv_k = ck[:, : pos + 1].to(q.dtype)
    kv_v = cv[:, : pos + 1].to(q.dtype)
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
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    pos: Optional[int] = None,
) -> torch.Tensor:
    """Returns y (B, S, d); ``cache`` is written in place.  ``window`` None
    means no sliding window."""
    B, S, d = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = x @ mod.wq.to(x.dtype)
    k = x @ mod.wk.to(x.dtype)
    v = x @ mod.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + mod.bq.to(x.dtype)
        k = k + mod.bk.to(x.dtype)
        v = v + mod.bv.to(x.dtype)
    q = q.reshape(B, S, hq, hd)
    k = k.reshape(B, S, hkv, hd)
    v = v.reshape(B, S, hkv, hd)

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
        out = ops.attention(q, k, v, causal=True, window=window, softcap=cfg.attn_softcap)
    else:
        out = _decode_attention(q, ck, cv, pos, window, cfg.attn_softcap)
    out = out.reshape(B, S, hq * hd)
    return out @ mod.wo.to(x.dtype)


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

    def forward(self, x, *, window=None, cache=None, pos=None):
        return gqa_attention(self, x, self.cfg, window=window, cache=cache, pos=pos)
