"""InternVL2-style VLM (PyTorch twin of ``repro.models.vlm``).

The vision frontend is a stub, as in the JAX package: the model takes
precomputed patch embeddings (B, N_patch, vision_dim), what InternViT would
emit after pixel-shuffle.  The mlp1 projector (``proj``: vision_dim -> d,
tanh-GELU, d -> d, no biases) and the language model (``lm``, a dense
:class:`~repro_torch.models.transformer.DecoderLM`) are whole.  Prefill
runs the LM over [projected patches][embedded tokens], so the vision
prefix takes the cache's first ``vision_tokens`` slots; decode is the LM's
decode.

On a rank of a ``model`` axis the projector is a Megatron pair (``w1``
column-parallel, ``w2`` row-parallel, the elementwise GELU on the rank's
columns between them) and the LM shards as any ``DecoderLM``.  Under
ZeRO-3 (``dist.fsdp``) the projector's blocks are gathered just before it
runs, and the LM's table for the text's embedding and again for the fused
loss; the LM gathers its own layers.
"""
from __future__ import annotations

import torch
from torch import nn

from ..dist import fsdp
from ..dist import tensor_parallel as tp
from .layers import _param, cross_entropy_fused, dense_init, gelu_tanh_stepwise
from .transformer import DecoderLM


class Projector(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.w1 = _param((cfg.vision_dim, cfg.d_model), cfg, device)
        self.w2 = _param((cfg.d_model, cfg.d_model), cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        dense_init(self.w1.data, gen)
        dense_init(self.w2.data, gen)


class VLM(nn.Module):
    """Parameter names follow the JAX pytree: ``proj.w1``, ``proj.w2`` and
    the LM's under ``lm.``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.proj = Projector(cfg, device)
        self.lm = DecoderLM(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX initialiser's distributions (see ``DecoderLM``)."""
        self.proj.reset_parameters(gen)
        self.lm.reset_parameters(gen)

    def forward(self, tokens, patches=None, cache=None, mode: str = "train",
                last_only: bool = False, return_hidden: bool = False):
        return apply_vlm(self, tokens, patches, cache=cache, mode=mode, last_only=last_only,
                         return_hidden=return_hidden)


def _project(proj: Projector, patches: torch.Tensor, cfg) -> torch.Tensor:
    """(B, N, vision_dim) -> (B, N, d) in the compute dtype.  The GELU
    rounds op by op as JAX's does: the projected patches are the prefix
    that every later position reads, and in bf16 ``F.gelu``'s one rounding
    moved a greedy token of the smoke model.  On a model axis the rank
    computes its columns of ``w1`` and rows of ``w2``, then the all-reduce
    (or, where the axis does not divide ``d``, the whole projector)."""
    axis = tp.axis_of(proj)
    with fsdp.gathered(proj):  # ZeRO-3: the projector whole, just now
        w1, w2 = proj.w1, proj.w2
        local = axis is not None and tp.sliced(w1, -1) and tp.sliced(w2, 0)
        x = patches.to(cfg.cdtype)
        if local:
            x = tp.copy_to(x, axis)
        elif axis is not None:
            w1, w2 = tp.whole(w1, axis), tp.whole(w2, axis)
        y = gelu_tanh_stepwise(x @ w1.to(cfg.cdtype)) @ w2.to(cfg.cdtype)
    return tp.reduce_from(y, axis) if local else y


def apply_vlm(model: VLM, tokens, patches, cache=None, mode: str = "train",
              last_only: bool = False, return_hidden: bool = False):
    """tokens (B, S_text); patches (B, N_patch, vision_dim).  Returns the
    LM's (logits fp32 (B, N_patch + S_text, V) or the hidden state,
    new_cache).  In decode mode the vision prefix is already in the cache
    and ``patches`` is unused."""
    if mode == "decode":
        return model.lm(tokens, cache=cache, mode=mode)
    vis = _project(model.proj, patches, model.cfg)
    with fsdp.gathered(model.lm.embed, ("tok",)):
        text = model.lm.embed.embed(tokens)
    x = torch.cat([vis, text], dim=1)
    return model.lm(None, cache=cache, mode=mode, last_only=last_only,
                    return_hidden=return_hidden, inputs_embeds=x)


def vlm_loss(model: VLM, batch) -> torch.Tensor:
    """Mean next-token NLL of ``batch`` = {"tokens", "targets", "patches",
    optional "mask"} over the text positions (the vision prefix is
    unsupervised), as JAX's ``vlm_loss``."""
    h, _ = apply_vlm(model, batch["tokens"], batch["patches"], return_hidden=True)
    nv = batch["patches"].shape[1]
    # ZeRO-3: the (tied) table again, for the loss
    with fsdp.gathered(model.lm.embed, model.lm.embed.unembed_names()):
        return cross_entropy_fused(h[:, nv:, :], model.lm.embed, batch["targets"],
                                   batch.get("mask"))
