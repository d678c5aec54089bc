"""Decoder-only LM assembly (PyTorch twin of ``repro.models.transformer``).

The layer plan is the JAX package's (a prologue plus ``n_units`` repeats of
a unit); here it is unrolled into one ``nn.ModuleList`` in place of the
``lax.scan`` over stacked layers, so layer ``i`` of the list is unit
``i // len(unit)``, element ``i % len(unit)`` (after the prologue).

Families ported so far: dense GQA/MQA decoders, including gemma2's
local/global alternation (sliding-window layers share the attention path),
and the rwkv family (``block_pattern`` of ``rwkv`` layers: RWKV-6 time mix
and channel mix).  MoE, MLA, hybrid (mamba), audio (whisper) and vlm raise
``NotImplementedError`` naming the arch.

Caches are a dict ``{"pos": int, "layers": [entry, ...]}`` with one entry
per layer, as JAX's ``_cache_shapes``: an attention layer's (k, v) pair of
(B, S_max, Hkv, Dh), an rwkv layer's (x_prev (B,1,d), wkv (B,H,K,K) fp32,
x_prev (B,1,d)).  Prefill and decode write it in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .attention import GQAAttention
from .layers import MLP, Embed, Norm, cross_entropy_fused
from .rwkv import RWKVChannelMix, RWKVTimeMix, rwkv_state_shapes


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str  # attn | mamba | rwkv
    moe: bool = False
    window: Optional[int] = None  # sliding window (gemma2 local layers)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    prologue: Tuple[LayerSpec, ...]
    unit: Tuple[LayerSpec, ...]
    n_units: int

    def layers(self) -> Tuple[LayerSpec, ...]:
        """Every layer in order: the prologue, then the unit n_units times."""
        return self.prologue + self.unit * self.n_units


def layer_plan(cfg) -> LayerPlan:
    moe = cfg.moe
    first_dense = moe.first_dense if moe else 0

    def ffn_is_moe(global_idx: int) -> bool:
        if moe is None or global_idx < first_dense:
            return False
        return (global_idx % moe.every) == (moe.every - 1) if moe.every > 1 else True

    if cfg.block_pattern:
        pattern = cfg.block_pattern
        if cfg.num_layers % len(pattern):
            raise ValueError("num_layers must be a multiple of the block pattern")
        if moe and len(pattern) % moe.every:
            raise ValueError("pattern length must be a multiple of moe.every")
        unit = tuple(
            LayerSpec(kind=k, moe=ffn_is_moe(i)) for i, k in enumerate(pattern)
        )
        return LayerPlan((), unit, cfg.num_layers // len(pattern))
    if cfg.local_global:
        if cfg.num_layers % 2:
            raise ValueError("local_global needs even num_layers")
        unit = (
            LayerSpec("attn", window=cfg.sliding_window),
            LayerSpec("attn", window=None),
        )
        return LayerPlan((), unit, cfg.num_layers // 2)
    prologue = tuple(LayerSpec("attn", moe=False) for _ in range(first_dense))
    unit = (LayerSpec("attn", moe=moe is not None),)
    return LayerPlan(prologue, unit, cfg.num_layers - first_dense)


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet."""
    missing = []
    if cfg.family in ("audio", "vlm", "hybrid"):
        missing.append(f"family {cfg.family!r}")
    kinds = {spec.kind for spec in layer_plan(cfg).layers()}
    if kinds - {"attn", "rwkv"}:
        missing.append(f"layers {sorted(kinds - {'attn', 'rwkv'})}")
    if cfg.moe is not None:
        missing.append("MoE")
    if "attn" in kinds and cfg.attn_kind != "gqa":
        missing.append(f"attention {cfg.attn_kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet"
        )


def _cache_shapes(spec: LayerSpec, cfg, batch: int, s_max: int):
    """(shape, dtype) of each tensor of one layer's cache entry."""
    dt = cfg.cdtype
    if spec.kind == "rwkv":
        s1, s2, s3 = rwkv_state_shapes(cfg, batch)
        return ((s1, dt), (s2, torch.float32), (s3, dt))
    kv = (batch, s_max, cfg.num_kv_heads, cfg.head_dim)
    return ((kv, dt), (kv, dt))


def init_cache(cfg, batch: int, s_max: int, device) -> Dict[str, Any]:
    """Zero-filled cache: one entry per layer (see the module docstring)."""
    check_supported(cfg)
    layers = [
        tuple(torch.zeros(shape, dtype=dtype, device=device)
              for shape, dtype in _cache_shapes(spec, cfg, batch, s_max))
        for spec in layer_plan(cfg).layers()
    ]
    return {"pos": 0, "layers": layers}


class Block(nn.Module):
    """Pre-norm layer: attention + MLP, or RWKV time mix + channel mix."""

    def __init__(self, spec: LayerSpec, cfg, device):
        super().__init__()
        self.kind = spec.kind
        self.window = spec.window
        self.ln1 = Norm(cfg, device)
        self.ln2 = Norm(cfg, device)
        if spec.kind == "rwkv":
            self.mix = RWKVTimeMix(cfg, device)
            self.ffn = RWKVChannelMix(cfg, device)
        else:
            self.mix = GQAAttention(cfg, device)
            self.ffn = MLP(cfg, device)

    def forward(self, x, cache=None, pos=None):
        if self.kind == "rwkv":
            x = x + self.mix(self.ln1(x), state=cache[:2] if cache is not None else None)
            return x + self.ffn(self.ln2(x), cache[2] if cache is not None else None)
        x = x + self.mix(self.ln1(x), window=self.window, cache=cache, pos=pos)
        return x + self.ffn(self.ln2(x))


class DecoderLM(nn.Module):
    """Decoder-only LM: embed, a ModuleList of blocks, final norm,
    (tied or untied) unembedding.  Parameter names follow the JAX pytree
    (``embed.tok``, ``layers.{i}.mix.wq``, ``final_norm.scale`` ...)."""

    def __init__(self, cfg, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.layers = nn.ModuleList(
            Block(spec, cfg, device) for spec in layer_plan(cfg).layers()
        )
        self.final_norm = Norm(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX initialiser's distributions (normal/sqrt(in) for weights,
        0.02 normal for embeddings, ones for norm scales) from ``gen``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def forward(self, tokens, cache=None, mode: str = "train", last_only: bool = False,
                return_hidden: bool = False):
        """Returns (logits fp32 (B, S, V), new_cache), or with
        ``return_hidden`` (the hidden state after the final norm (B, S, d),
        new_cache).

        * mode="train":   cache ignored
        * mode="prefill": cache required; writes positions [0:S], pos := S
        * mode="decode":  cache required; tokens (B, 1) at cache["pos"]
        """
        if mode == "train":
            cache = None
        elif mode not in ("prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        elif cache is None:
            raise ValueError(f"mode={mode!r} requires a cache")
        pos = cache["pos"] if mode == "decode" else None
        x = self.embed.embed(tokens)
        for i, layer in enumerate(self.layers):
            x = layer(x, cache["layers"][i] if cache is not None else None, pos)
        x = self.final_norm(x)
        new_cache = None
        if cache is not None:
            new_pos = cache["pos"] + (1 if mode == "decode" else tokens.shape[1])
            new_cache = {"pos": new_pos, "layers": cache["layers"]}
        if return_hidden:
            return x, new_cache
        if last_only:
            x = x[:, -1:, :]
        return self.embed.unembed(x), new_cache


def apply_lm(model: DecoderLM, tokens, cache=None, mode: str = "train",
             last_only: bool = False, return_hidden: bool = False):
    """Functional entry point in the JAX ``apply_lm`` argument order; returns
    (logits, new_cache), or (hidden, new_cache) with ``return_hidden`` (the
    ported families have no auxiliary loss)."""
    return model(tokens, cache=cache, mode=mode, last_only=last_only,
                 return_hidden=return_hidden)


def lm_loss(model: DecoderLM, batch) -> torch.Tensor:
    """Mean next-token NLL of ``batch`` = {"tokens" (B,S), "targets" (B,S),
    optional "mask"}: the fused, chunked loss on the hidden state after the
    final norm, as JAX's ``lm_loss``.  JAX adds 0.01 x the MoE auxiliary
    loss; the port's families have no MoE yet (it raises
    ``NotImplementedError`` at model construction), so the term does not
    arise."""
    h, _ = model(batch["tokens"], mode="train", return_hidden=True)
    return cross_entropy_fused(h, model.embed, batch["targets"], batch.get("mask"))
