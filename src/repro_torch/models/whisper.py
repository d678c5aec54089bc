"""Whisper-style encoder-decoder (PyTorch twin of ``repro.models.whisper``).

The modality frontend is a stub, as in the JAX package: the encoder takes
precomputed frame embeddings (B, S_enc, d_model), what whisper's two conv
layers would emit.  The backbone is whole: an encoder of
``cfg.encoder_layers`` pre-norm layers (full self-attention over the frames
plus a fixed sinusoid table), a decoder of ``cfg.num_layers`` layers
(causal self-attention, cross-attention over the encoder output, MLP) with
a learned position table ``pos`` of ``cfg.max_target_positions`` rows, no
RoPE, LayerNorm, tanh-GELU MLPs and logits ``x @ tok.T`` in fp32.

Every attention of the encoder and of the decoder's prefill, and the
cross-attention of every decode step, goes through
:func:`repro_torch.kernels.ops.attention` (the flash kernel on the card);
a decode step's self-attention over the cache is plain torch, as for the
decoder-only models.  The cross K/V are recomputed from the encoder output
at every decode step, as JAX's ``decode`` does.  The LayerNorms are plain
torch (the JAX package has no Pallas LayerNorm).

The cache is ``{"pos": int, "layers": [(k, v)] * num_layers, "enc": (B,
S_enc, d)}``: the decoder's self-attention KV per layer, and the encoder
output that prefill writes and every decode step reads (JAX's registry
adds ``enc`` to ``init_whisper_cache``'s tree).  Prefill and decode write
it in place.

On a rank of a ``model`` axis (``models.registry.local_model``) the
attentions, the cross-attentions and the MLPs are head- and
column/row-parallel (``attention.py``, ``layers.py``), the LayerNorms
gather their scales, and ``tok`` and ``pos``, cut along ``d_model``, are
looked up in pieces that are gathered (B x S x d moved, not the tables).
The tied unembedding is :class:`~repro_torch.models.layers.Embed`'s: the
logits of the rank's columns summed in fp32, and in the loss the
vocabulary-parallel path where the axis divides the vocabulary, else the
table gathered whole (51865 divides neither 2 nor 4).  The rank's cache
holds the kv heads its query heads read and the whole ``enc``: every
frame feeds its heads' cross K/V (``cache_specs`` cuts ``enc`` over its
frames).

Under ZeRO-3 (``dist.fsdp``) each parameter is the rank's block, and
every module's blocks are gathered whole just before its use
(``fsdp.gathered``), as ``DecoderLM`` does: each encoder layer, then
``enc_ln``; ``tok`` and ``pos`` for the lookups, each decoder layer with
its cross-attention, ``dec_ln``, then ``tok`` again for the logits or the
fused loss.  In serving no gathered weight outlives its use; the rank's
cache, ``enc`` included, holds its rows of the batch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..dist import fsdp
from ..dist import tensor_parallel as tp
from .attention import CrossAttention, GQAAttention
from .layers import MLP, Embed, Norm, _param, cross_entropy_fused, embed_init


def _sinusoid(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) fp32 table: sin of pos / 10000^(2i/dim) in the first half,
    cos in the second, as JAX's ``_sinusoid``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncoderLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = GQAAttention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.ffn = MLP(cfg, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x), causal=False)
        return x + self.ffn(self.ln2(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = GQAAttention(cfg, device)
        self.lnx = Norm(cfg, device)
        self.xattn = CrossAttention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.ffn = MLP(cfg, device)

    def forward(self, x, enc, cache=None, pos=None):
        x = x + self.attn(self.ln1(x), cache=cache, pos=pos)
        x = x + self.xattn(self.lnx(x), enc)
        return x + self.ffn(self.ln2(x))


class Whisper(nn.Module):
    """Parameter names follow the JAX pytree: ``enc_layers.{i}.{ln1,attn,
    ln2,ffn}``, ``enc_ln``, ``tok``, ``pos``, ``dec_layers.{i}.{ln1,attn,
    lnx,xattn,ln2,ffn}``, ``dec_ln``."""

    def __init__(self, cfg, device):
        super().__init__()
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, device)
                                        for _ in range(cfg.encoder_layers))
        self.enc_ln = Norm(cfg, device)
        self.tok = _param((cfg.vocab_size, cfg.d_model), cfg, device)
        self.pos = _param((cfg.max_target_positions, cfg.d_model), cfg, device)
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device)
                                        for _ in range(cfg.num_layers))
        self.dec_ln = Norm(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX initialiser's distributions: weights normal/sqrt(in),
        ``tok`` and ``pos`` 0.02-normal, LayerNorm scale 1 and bias 0."""
        self.reset_own_parameters(gen)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def reset_own_parameters(self, gen: torch.Generator) -> None:
        """``tok`` and ``pos``, drawn before every module's parameters."""
        embed_init(self.tok.data, gen)
        embed_init(self.pos.data, gen)

    # the tied table's unembedding, (d, V) for the fused loss, and the fp32
    # logits (no softcap), as the decoder-only LM's on any model axis
    unembed_matrix = Embed.unembed_matrix
    unembed = Embed.unembed
    unembed_weight = Embed.unembed_weight

    def forward(self, tokens, frames=None, cache=None, mode: str = "train",
                last_only: bool = False, return_hidden: bool = False):
        """Returns (logits fp32 (B, S, V) or the hidden state, new_cache).

        * mode="train":   encode ``frames``, decode ``tokens``; no cache
        * mode="prefill": the same, writing ``cache["enc"]`` and the
          decoder's KV at positions [0:S]
        * mode="decode":  tokens (B, 1) at ``cache["pos"]`` against
          ``cache["enc"]``
        """
        if mode == "decode":
            return decode(self, tokens, cache["enc"], cache=cache, mode="decode")
        enc = encode(self, frames)
        if mode == "prefill":
            cache["enc"].copy_(enc)
        return decode(self, tokens, enc, cache=cache, mode=mode, last_only=last_only,
                      return_hidden=return_hidden)


def encode(model: Whisper, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, S_enc, d), the conv frontend's output (stub) -> the encoder
    output (B, S_enc, d) in the compute dtype.  The frames and the fp32
    sinusoid table are each cast to the compute dtype before the sum."""
    cfg = model.cfg
    x = frames.to(cfg.cdtype) + _sinusoid(frames.shape[1], cfg.d_model,
                                          frames.device).to(cfg.cdtype)
    for layer in model.enc_layers:
        with fsdp.gathered(layer):  # ZeRO-3: this layer's weights whole, just now
            x = layer(x)
    with fsdp.gathered(model.enc_ln):
        return model.enc_ln(x)


def decode(model: Whisper, tokens: torch.Tensor, enc: torch.Tensor,
           cache: Optional[Dict[str, Any]] = None, mode: str = "train",
           return_hidden: bool = False, last_only: bool = False):
    """The decoder over ``enc``: returns (logits fp32 (B, S, V), new_cache),
    or the hidden state after ``dec_ln`` with ``return_hidden``.  ``mode``
    is "train" (no cache), "prefill" (writes KV slots [0:S], pos := S) or
    "decode" (tokens (B, 1) at ``cache["pos"]``, reading that row of
    ``pos``)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "train":
        cache = None
    elif cache is None:
        raise ValueError(f"mode={mode!r} requires a cache")
    cfg = model.cfg
    S = tokens.shape[1]
    pos = cache["pos"] if mode == "decode" else None
    axis = tp.axis_of(model)
    with fsdp.gathered(model, ("tok", "pos")):
        x = F.embedding(tokens, model.tok)
        pe = model.pos[pos:pos + 1] if pos is not None else model.pos[:S]
        if tp.sliced(model.tok, -1):  # the looked-up rows' pieces, gathered
            x = tp.gather_whole(x, -1, axis)
        if tp.sliced(model.pos, -1):
            pe = tp.gather_whole(pe, -1, axis)
        x = x.to(cfg.cdtype) + pe.to(cfg.cdtype)[None]
    for i, layer in enumerate(model.dec_layers):
        with fsdp.gathered(layer):
            x = layer(x, enc, cache["layers"][i] if cache is not None else None, pos)
    with fsdp.gathered(model.dec_ln):
        x = model.dec_ln(x)
    new_cache = None
    if cache is not None:
        new_cache = dict(cache, pos=cache["pos"] + (1 if mode == "decode" else S))
    if not return_hidden:
        if last_only:
            x = x[:, -1:, :]
        with fsdp.gathered(model, ("tok",)):  # the tied table again, for the logits
            x = model.unembed(x)
    return x, new_cache


def init_whisper_cache(cfg, batch: int, s_max: int, device,
                       hkv: Optional[int] = None) -> Dict[str, Any]:
    """Zero-filled cache (see the module docstring): per decoder layer a
    (k, v) pair of (B, s_max, Hkv, Dh) (``hkv`` kv heads, default all), and
    ``enc`` (B, encoder_seq, d) whole, all in the compute dtype."""
    kv = (batch, s_max, cfg.num_kv_heads if hkv is None else hkv, cfg.head_dim)
    return {
        "pos": 0,
        "layers": [tuple(torch.zeros(kv, dtype=cfg.cdtype, device=device) for _ in range(2))
                   for _ in range(cfg.num_layers)],
        "enc": torch.zeros((batch, cfg.encoder_seq, cfg.d_model), dtype=cfg.cdtype,
                           device=device),
    }


def whisper_loss(model: Whisper, batch) -> torch.Tensor:
    """Mean next-token NLL of ``batch`` = {"frames" (B, S_enc, d), "tokens"
    (B, S), "targets" (B, S), optional "mask"}: the fused, chunked loss on
    the decoder's hidden state, as JAX's ``whisper_loss``."""
    enc = encode(model, batch["frames"])
    h, _ = decode(model, batch["tokens"], enc, return_hidden=True)
    with fsdp.gathered(model, ("tok",)):  # ZeRO-3: the tied table again, for the loss
        return cross_entropy_fused(h, model, batch["targets"], batch.get("mask"))
