"""Decoder-only LM assembly (PyTorch twin of ``repro.models.transformer``).

The layer plan is the JAX package's (a prologue plus ``n_units`` repeats of
a unit); here it is unrolled into one ``nn.ModuleList`` in place of the
``lax.scan`` over stacked layers, so layer ``i`` of the list is unit
``i // len(unit)``, element ``i % len(unit)`` (after the prologue).

The decoder-only families: dense GQA/MQA decoders, including gemma2's
local/global alternation (sliding-window layers share the attention path),
the MoE family (``models/moe.py``: grok-1's GQA + MoE, deepseek-v3's MLA +
MoE after a prologue of dense layers), the rwkv family
(``block_pattern`` of ``rwkv`` layers: RWKV-6 time mix and channel mix) and
the hybrid family (jamba: a ``block_pattern`` of one GQA layer and seven
Mamba layers, ``models/ssm.py``, with MoE on every other layer).  The vlm
family's language model is a dense :class:`DecoderLM` fed ``inputs_embeds``
(``models/vlm.py``); the audio family (whisper) is an encoder-decoder of
its own (``models/whisper.py``), which :class:`DecoderLM` refuses.

Caches are a dict ``{"pos": int, "layers": [entry, ...]}`` with one entry
per layer (and ``"dp"``, below), as JAX's ``_cache_shapes``: a GQA layer's (k, v) pair of
(B, S_max, Hkv, Dh), an MLA layer's (c_kv (B, S_max, R), k_rope (B, S_max,
Dr)), an rwkv layer's (x_prev (B,1,d), wkv (B,H,K,K) fp32, x_prev (B,1,d)),
a mamba layer's (conv_buf (B, d_conv-1, d_in), ssm_state (B, d_in, N) fp32).
Prefill and decode write it in place.

The forward sums the MoE layers' auxiliary losses (zero without MoE);
``return_aux`` returns the sum, and ``lm_loss`` adds 0.01 x it for MoE
configs, as JAX's ``lm_loss`` does.

For a rank of a ``model`` axis, :class:`DecoderLM` and its blocks are built
by ``models.registry.local_model``: the same modules, each parameter a
slice of JAX's leaf, and the layers (``layers.py``, ``attention.py``,
``moe.py``) run the axis's collectives around the replicated residual
stream.  Such a model trains and serves: with a mesh, :func:`init_cache`
gives the rank's cache (its rows of the batch over the DP axes, and the
kv heads its query heads read; where the DP axes cut the batch of an MoE
model, ``"dp"``, the ``dist.fsdp.DPAxis`` whose ranks hold the other rows,
over which the MoE layers route the whole batch), and the logits come
whole to every rank (``Embed.unembed``).  Under ZeRO-3 (``dist.fsdp``)
each parameter is the rank's block, and :class:`DecoderLM` gathers the
embedding, each layer and the final norm just before their use
(``fsdp.gathered``), and ``lm_loss`` the tied table again for the fused
loss; in serving no gathered weight outlives its use.  This holds for
every block kind alike (GQA, MLA, MoE, RWKV-6, Mamba): a block computes
from its gathered tensors exactly what it computes from whole ones, the
fp32 leaves (rwkv's ``w0`` and ``u``, Mamba's ``A_log`` and ``D``, the
router) gathered and reduced back in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..dist import fsdp
from ..dist.sharding import rows_of
from ..launch.mesh import mesh_axis_sizes
from .attention import GQAAttention, MLAAttention, kv_heads
from .layers import MLP, Embed, Norm, cross_entropy_fused
from .moe import MoE
from .rwkv import RWKVChannelMix, RWKVTimeMix, rwkv_state_shapes
from .ssm import Mamba, mamba_state_shape


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
    """Raise ``NotImplementedError`` for layers the port does not run."""
    missing = []
    kinds = {spec.kind for spec in layer_plan(cfg).layers()}
    if kinds - {"attn", "mamba", "rwkv"}:
        missing.append(f"layers {sorted(kinds - {'attn', 'mamba', 'rwkv'})}")
    if "attn" in kinds and cfg.attn_kind not in ("gqa", "mla"):
        missing.append(f"attention {cfg.attn_kind!r}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet"
        )


def _cache_shapes(spec: LayerSpec, cfg, batch: int, s_max: int, hkv: Optional[int] = None,
                  model: int = 1):
    """(shape, dtype) of each tensor of one layer's cache entry; a GQA
    layer's holds ``hkv`` kv heads (default: all), an rwkv or Mamba layer's
    the state of the heads or channels that a rank of a ``model`` axis
    computes."""
    dt = cfg.cdtype
    if spec.kind == "rwkv":
        s1, s2, s3 = rwkv_state_shapes(cfg, batch, model)
        return ((s1, dt), (s2, torch.float32), (s3, dt))
    if spec.kind == "mamba":
        s1, s2 = mamba_state_shape(cfg, batch, model)
        return ((s1, dt), (s2, torch.float32))
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return (((batch, s_max, m.kv_lora_rank), dt), ((batch, s_max, m.qk_rope_head_dim), dt))
    kv = (batch, s_max, cfg.num_kv_heads if hkv is None else hkv, cfg.head_dim)
    return ((kv, dt), (kv, dt))


def init_cache(cfg, batch: int, s_max: int, device, mesh=None) -> Dict[str, Any]:
    """Zero-filled cache: one entry per layer (see the module docstring).
    With a built ``mesh``, this rank's: its rows of the ``batch`` over the
    DP axes (``dist.sharding.rows_of``, as ``batch_specs`` cuts the batch)
    and, at ``model`` > 1, the kv heads ``kv0 .. kv1`` that its query heads
    read (``attention.kv_heads``), the WKV states of its heads and the
    Mamba states of its channels.  Where ``cache_specs`` cuts whole kv
    heads (or the Mamba channels) that is the rank's slice of JAX's cache;
    where it cuts inside a head (``head_dim``), the MLA latents' sequence
    dim, the WKV state's key dim or the token-shift states' ``d``, the rank
    keeps what it reads whole (the kv head; ``c_kv`` and ``k_rope``; its
    heads' WKV states, the same bytes as JAX's slice; ``x_prev``, which the
    token shift reads whole), as the model axis gathers a weight cut inside
    a head.  For an MoE model whose
    batch the DP axes cut, ``"dp"`` holds the DP group (the MoE layers
    route the whole batch over it); where they do not divide the batch
    every rank holds every row and routes it alone."""
    check_supported(cfg)
    hkv, dp, model = None, None, 1
    if mesh is not None:
        whole, batch = batch, rows_of(batch, mesh)[1]
        if cfg.moe is not None and batch < whole:
            dp = fsdp.DPAxis.of(mesh)
        model = mesh_axis_sizes(mesh).get("model", 1)
        if model > 1:
            kv0, kv1 = kv_heads(cfg, model, mesh.coords()["model"])
            hkv = kv1 - kv0
    layers = [
        tuple(torch.zeros(shape, dtype=dtype, device=device)
              for shape, dtype in _cache_shapes(spec, cfg, batch, s_max, hkv, model))
        for spec in layer_plan(cfg).layers()
    ]
    return {"pos": 0, "layers": layers, **({"dp": dp} if dp is not None else {})}


class Block(nn.Module):
    """Pre-norm layer: attention (GQA or MLA) or Mamba + MLP or MoE, or RWKV
    time mix + channel mix.  Returns (x, the MoE auxiliary loss or None)."""

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
            if spec.kind == "mamba":
                self.mix = Mamba(cfg, device)
            elif cfg.attn_kind == "mla":
                self.mix = MLAAttention(cfg, device)
            else:
                self.mix = GQAAttention(cfg, device)
            # prologue layers of an MoE model use the dense d_ff
            self.ffn = MoE(cfg, device) if spec.moe else MLP(cfg, device)
        self.moe = spec.moe

    def forward(self, x, cache=None, pos=None, rows_dp=None):
        if self.kind == "rwkv":
            x = x + self.mix(self.ln1(x), state=cache[:2] if cache is not None else None)
            return x + self.ffn(self.ln2(x), cache[2] if cache is not None else None), None
        if self.kind == "mamba":
            x = x + self.mix(self.ln1(x), state=cache)
        else:
            x = x + self.mix(self.ln1(x), window=self.window, cache=cache, pos=pos)
        if self.moe:
            y, aux = self.ffn(self.ln2(x), rows_dp)
            return x + y, aux
        return x + self.ffn(self.ln2(x)), None


class DecoderLM(nn.Module):
    """Decoder-only LM: embed, a ModuleList of blocks, final norm,
    (tied or untied) unembedding.  Parameter names follow the JAX pytree
    (``embed.tok``, ``layers.{i}.mix.wq``, ``final_norm.scale`` ...)."""

    def __init__(self, cfg, device):
        super().__init__()
        if cfg.family == "audio":
            raise ValueError(f"{cfg.name}: the audio family is models.whisper.Whisper, "
                             "not a decoder-only LM")
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
                return_hidden: bool = False, return_aux: bool = False, inputs_embeds=None):
        """Returns (logits fp32 (B, S, V), new_cache), or with
        ``return_hidden`` (the hidden state after the final norm (B, S, d),
        new_cache); with ``return_aux`` the summed MoE auxiliary loss (fp32
        scalar) comes second: (out, aux, new_cache).  ``inputs_embeds``
        (B, S, d) in the compute dtype takes the place of the embedded
        ``tokens`` (the VLM's projected patches and embedded text).  A
        cache's ``"dp"`` (:func:`init_cache`) has the MoE layers route the
        whole batch of its ranks (``models.moe``).

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
        rows_dp = cache.get("dp") if cache is not None else None
        if inputs_embeds is not None:
            x = inputs_embeds
        else:
            with fsdp.gathered(self.embed, ("tok",)):
                x = self.embed.embed(tokens)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            with fsdp.gathered(layer):  # ZeRO-3: this layer's weights whole, just now
                x, aux = layer(x, cache["layers"][i] if cache is not None else None, pos,
                               rows_dp)
            if aux is not None:
                aux_total = aux_total + aux
        with fsdp.gathered(self.final_norm):
            x = self.final_norm(x)
        new_cache = None
        if cache is not None:
            new_pos = cache["pos"] + (1 if mode == "decode" else x.shape[1])
            new_cache = dict(cache, pos=new_pos)
        if not return_hidden:
            if last_only:
                x = x[:, -1:, :]
            with fsdp.gathered(self.embed, self.embed.unembed_names()):
                x = self.embed.unembed(x)
        return (x, aux_total, new_cache) if return_aux else (x, new_cache)


def apply_lm(model: DecoderLM, tokens, cache=None, mode: str = "train",
             last_only: bool = False, return_hidden: bool = False, return_aux: bool = False):
    """Functional entry point in the JAX ``apply_lm`` argument order; returns
    (logits, new_cache), or (hidden, new_cache) with ``return_hidden``, and
    with ``return_aux`` JAX's triple (out, aux, new_cache)."""
    return model(tokens, cache=cache, mode=mode, last_only=last_only,
                 return_hidden=return_hidden, return_aux=return_aux)


def lm_loss(model: DecoderLM, batch) -> torch.Tensor:
    """Mean next-token NLL of ``batch`` = {"tokens" (B,S), "targets" (B,S),
    optional "mask"}: the fused, chunked loss on the hidden state after the
    final norm, plus 0.01 x the MoE auxiliary loss for an MoE config, as
    JAX's ``lm_loss``."""
    h, aux, _ = model(batch["tokens"], mode="train", return_hidden=True, return_aux=True)
    # ZeRO-3: the (tied) table again, for the loss
    with fsdp.gathered(model.embed, model.embed.unembed_names()):
        loss = cross_entropy_fused(h, model.embed, batch["targets"], batch.get("mask"))
    if model.cfg.moe is not None:
        loss = loss + 0.01 * aux
    return loss
