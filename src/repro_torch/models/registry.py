"""Architecture registry (PyTorch twin of ``repro.models.registry``).

The reduced smoke variants of the 10 architectures, and a uniform
:class:`ModelAPI` (init / loss / prefill / decode / init_cache) for every
family:
the decoder-only ones (dense GQA/MQA, MoE with GQA or MLA, rwkv, and
jamba's hybrid of GQA and Mamba layers), whisper's encoder-decoder
(``audio``: prefill reads ``batch["frames"]``) and internvl2's VLM
(``vlm``: prefill reads ``batch["patches"]``).  Entry points run on
``cuda`` unless the caller passes another device.

With a ``mesh`` whose ``model`` axis is above 1, :func:`get_api` gives the
API of one rank of the tensor- and expert-parallel model
(``dist.tensor_parallel``): ``init(seed)`` builds the rank's modules at
their local shapes and fills them with its slices of the very weights
that ``init(seed)`` gives at ``model`` 1, drawn one module at a time on
the device, so no rank ever holds the whole model.  With ``fsdp=True``
(ZeRO-3, ``dist.fsdp``) the rank keeps only its block of each of those
slices over the mesh's DP axes, and every family gathers each module's
blocks just before it runs (the decoder's layers, whisper's encoder and
decoder layers and tables, the VLM's projector and table).
Such a model trains (``loss``) and serves: ``init_cache(batch, s_max)``
gives the rank's cache (:func:`init_cache`), and ``prefill`` and
``decode`` run on the rank's rows of the batch, the MoE layers routing the
whole batch over the DP group where it cuts the batch (``models.moe``).
Every family serves and trains over the model and the DP axes, with or
without ZeRO-3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import configs as _configs
from ..dist.fsdp import DPAxis, block, cut_of
from ..dist.sharding import rows_of
from ..dist.tensor_parallel import ModelAxis
from .attention import kv_heads
from .config import MLAConfig, MambaConfig, ModelConfig, RWKVConfig
from . import transformer, vlm, whisper


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (same values as JAX)."""
    full = _configs.get_config(name)
    kw: Dict[str, Any] = dict(
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if full.attn_kind == "mla":
        kw["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
    if full.num_kv_heads == 1:
        kw["num_kv_heads"] = 1
    if full.moe is not None:
        kw["moe"] = dataclasses.replace(
            full.moe,
            num_experts=4,
            top_k=2,
            d_expert=64,
            first_dense=min(full.moe.first_dense, 1),
            capacity_factor=2.0,
        )
        if full.moe.first_dense:
            kw["num_layers"] = 5  # 1 dense + 4 moe
    if full.block_pattern is not None:
        kw["num_layers"] = len(full.block_pattern)
    if full.mamba is not None:
        kw["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2)
    if full.rwkv is not None:
        kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, tokenshift_lora=8)
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 4
    if full.local_global:
        kw["num_layers"] = 4
        kw["sliding_window"] = 8
    if full.is_encoder_decoder:
        kw["num_layers"] = 2
        return full.replace(
            encoder_layers=2, encoder_seq=16, max_target_positions=64, **kw
        )
    if full.family == "vlm":
        kw["vision_tokens"] = 8
        kw["vision_dim"] = 32
    return full.replace(**kw)


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable  # (seed) -> model with random weights
    loss: Callable  # (model, batch) -> scalar
    prefill: Callable  # (model, batch, cache, last_only) -> (logits, cache)
    decode: Callable  # (model, tokens, cache) -> (logits, cache)
    init_cache: Callable  # (batch, s_max) -> cache
    axis: Optional[ModelAxis] = None  # the model axis of a rank (None: the whole model)
    dp: Optional[DPAxis] = None  # the DP group of a rank's ZeRO-3 blocks (None: no fsdp)


def model_class(cfg: ModelConfig):
    """The module class of ``cfg``'s family: ``Whisper``, ``VLM`` or
    ``DecoderLM``, each built as ``cls(cfg, device)``."""
    if cfg.family == "audio":
        return whisper.Whisper
    if cfg.family == "vlm":
        return vlm.VLM
    return transformer.DecoderLM


def loss_fn(cfg: ModelConfig) -> Callable:
    """The training loss of ``cfg``'s family, ``(model, batch) -> scalar``:
    ``whisper_loss`` (reads ``frames``), ``vlm_loss`` (reads ``patches``) or
    ``lm_loss`` (with 0.01 x the MoE auxiliary loss), as JAX's
    ``ModelAPI.loss``."""
    if cfg.family == "audio":
        return whisper.whisper_loss
    if cfg.family == "vlm":
        return vlm.vlm_loss
    return transformer.lm_loss


def local_model(cfg: ModelConfig, device, axis: Optional[ModelAxis],
                dp: Optional[DPAxis] = None) -> nn.Module:
    """The modules of one rank of ``axis``, parameters uninitialised at their
    local shapes on ``device``: each parameter carries ``tp_dim``, the dim
    of the slice it holds (``models.convert.model_dims``), and each module
    ``tp``, the axis.  With ``dp`` (ZeRO-3) each parameter is the rank's
    block of that slice (``models.convert.fsdp_cuts``), carrying
    ``fsdp_dim``, ``fsdp_owner`` and ``fsdp_shape`` where it is cut, and
    each module ``fsdp``, the DP group (``dist.fsdp``)."""
    from .convert import fsdp_cuts, model_dims

    size = axis.size if axis is not None else 1
    dims = model_dims(cfg, size)
    cuts = fsdp_cuts(cfg, size, dp.size) if dp is not None else {}
    model = model_class(cfg)(cfg, torch.device("meta"))
    for prefix, mod in model.named_modules():
        mod.tp = axis
        if dp is not None:
            mod.fsdp = dp
        for name, p in list(mod._parameters.items()):
            full = f"{prefix}.{name}" if prefix else name
            dim, shape = dims[full], list(p.shape)
            if dim is not None:
                shape[dim] //= size
            cut, gathered = cuts.get(full), tuple(shape)
            if cut is not None and cut[0] is not None:
                shape[cut[0]] //= dp.size
            elif cut is not None and cut[1] != dp.index:
                shape = [0]
            local = nn.Parameter(torch.empty(shape, dtype=p.dtype, device=device))
            local.tp_dim = dim
            if cut is not None:
                local.fsdp_dim, local.fsdp_owner, local.fsdp_shape = cut[0], cut[1], gathered
            mod._parameters[name] = local
    return model


@torch.no_grad()
def init_local(model: nn.Module, seed: int, device) -> nn.Module:
    """Fill a :func:`local_model` with its slices (or blocks) of
    ``init(seed)``'s weights: the whole model's modules are drawn one at a
    time on ``device`` from the same generator, in the same order, and
    dropped once their slices are kept."""
    whole = model_class(model.cfg)(model.cfg, torch.device("meta"))
    gen = torch.Generator(device=device).manual_seed(seed)
    local = dict(model.named_parameters())
    dp = getattr(model, "fsdp", None)
    for prefix, mod in whole.named_modules():
        # a container draws nothing of its own (the VLM's LM: its
        # reset_parameters draws its modules'); the root only its own
        # parameters (whisper's tables), which come first in its init
        reset = getattr(mod, "reset_own_parameters" if mod is whole else "reset_parameters",
                        None)
        if not mod._parameters or reset is None:
            continue
        mod.to_empty(device=device, recurse=False)
        reset(gen)
        for name, p in mod.named_parameters(recurse=False):
            q = local[f"{prefix}.{name}" if prefix else name]
            part = p if q.tp_dim is None else model.tp.own(p, q.tp_dim)
            q.copy_(block(part, cut_of(q), dp))
        mod.to_empty(device="meta", recurse=False)
    return model


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device, mesh=None) -> Dict[str, Any]:
    """The zero-filled serving cache of ``cfg``'s family for a batch of
    ``batch`` rows and ``s_max`` slots (the VLM's vision prefix takes
    ``vision_tokens`` more); with a built ``mesh``, this rank's part of it
    (``transformer.init_cache``; whisper's: its rows, the kv heads its
    query heads read and the whole ``enc``)."""
    if cfg.family == "audio":
        if mesh is None:
            return whisper.init_whisper_cache(cfg, batch, s_max, device)
        model = dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)
        kv0, kv1 = kv_heads(cfg, model, mesh.coords().get("model", 0))
        return whisper.init_whisper_cache(cfg, rows_of(batch, mesh)[1], s_max, device,
                                          kv1 - kv0)
    if cfg.family == "vlm":  # the vision prefix takes the first vision_tokens slots
        return transformer.init_cache(cfg, batch, s_max + cfg.vision_tokens, device, mesh)
    return transformer.init_cache(cfg, batch, s_max, device, mesh)


def get_api(cfg: ModelConfig, device="cuda", mesh=None, fsdp: bool = False) -> ModelAPI:
    """The model API of ``cfg``'s arch on ``device``; with ``mesh`` (a
    built ``launch.mesh.Mesh``), of this rank of its ``model`` axis; with
    ``fsdp`` too, of this rank's ZeRO-3 blocks over the mesh's DP axes."""
    transformer.check_supported(cfg)
    device = torch.device(device)
    cls = model_class(cfg)
    axis = dp = None
    if mesh is not None:
        axis = ModelAxis.of(mesh)
    if fsdp:
        if mesh is None:
            raise ValueError("fsdp cuts the parameters over a mesh's DP axes: pass mesh=")
        dp = DPAxis.of(mesh)

    def init(seed: int = 0):
        """Random weights from ``torch.Generator(seed)`` on ``device``, with
        the JAX initialiser's distributions (this rank's slices of them on
        a model axis, its blocks of those under ZeRO-3)."""
        if axis is not None or dp is not None:
            return init_local(local_model(cfg, device, axis, dp), seed, device)
        model = cls(cfg, device)
        model.reset_parameters(torch.Generator(device=device).manual_seed(seed))
        return model

    if cfg.family == "audio":
        def prefill(model, batch, cache, last_only=False):
            return model(batch["tokens"], batch["frames"], cache=cache, mode="prefill",
                         last_only=last_only)
    elif cfg.family == "vlm":
        def prefill(model, batch, cache, last_only=False):
            return model(batch["tokens"], batch["patches"], cache=cache, mode="prefill",
                         last_only=last_only)
    else:
        def prefill(model, batch, cache, last_only=False):
            return model(batch["tokens"], cache=cache, mode="prefill", last_only=last_only)

    def decode_step(model, tokens, cache):
        return model(tokens, cache=cache, mode="decode")

    def make_cache(batch, s_max):
        return init_cache(cfg, batch, s_max, device, mesh)

    return ModelAPI(cfg, device, init, loss_fn(cfg), prefill, decode_step, make_cache, axis,
                    dp)


def modality_inputs(cfg: ModelConfig, rng: np.random.Generator, batch: int) -> Dict[str, np.ndarray]:
    """whisper's ``frames`` (batch, encoder_seq, d_model) or the VLM's
    ``patches`` (batch, vision_tokens, vision_dim): random fp32 embeddings
    in place of the frontends, as the JAX package's stubs take them, drawn
    from ``rng`` after the tokens as JAX's ``make_smoke_batch`` and serve
    command line draw them; {} for a decoder-only model."""
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.normal(size=(batch, cfg.vision_tokens, cfg.vision_dim)).astype(
            np.float32)}
    return {}


def make_smoke_batch(cfg: ModelConfig, rng=None, batch: int = 2, seq: int = 16,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """The same draws as the JAX ``make_smoke_batch``: tokens and targets as
    int64 tensors, then ``modality_inputs`` from the same generator."""
    rng = rng or np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int64)
    tgts = np.roll(toks, -1, axis=1)
    out = {"tokens": toks, "targets": tgts, **modality_inputs(cfg, rng, batch)}
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}
