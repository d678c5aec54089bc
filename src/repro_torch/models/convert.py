"""The weight bridge between JAX parameters (as numpy arrays) and a torch
state_dict, both ways.

``params_from_jax`` takes the JAX package's parameter pytree with numpy
leaves, or the same tree flattened under the ``"/"``-joined keys that the
JAX checkpoint manager writes (``ckpt/manager.py:_flatten``, where bf16 is
stored as f32).  It

* unstacks the leading layer axis of ``params["pro"]`` (the prologue, e.g.
  deepseek-v3's leading dense layers: its layer ``p`` becomes ``layers.{p}``)
  and of ``params["units"]["l{j}"]``: unit ``u``, element ``j`` becomes
  ``layers.{i}`` with ``i = len(prologue) + u * len(unit) + j``, the order
  of :meth:`repro_torch.models.transformer.LayerPlan.layers`;
* keeps every weight's (in, out) orientation, because the port's layers
  compute ``x @ W`` as JAX does (no transpose, no ``nn.Linear``);
* gives each leaf the dtype of the port's parameter of that name: the
  config's param dtype, except where the model keeps a parameter in fp32
  whatever ``param_dtype`` is (RWKV's decay base ``w0`` and bonus ``u``, the
  MoE ``router``, and Mamba's ``A_log`` and ``D``, as the JAX initialisers
  do).  A checkpoint stores bf16 as f32, so the
  leaf's own dtype cannot say which parameters are bf16.  Widening bf16 to
  f32 and back is exact, so every value arrives bit for bit.  With
  ``dtype`` given, every leaf gets that dtype instead: the AdamW moments
  share the parameters' names and stay fp32 whatever the param dtype.

The other families' trees (``cfg.family``): whisper's (``audio``) stacks
``enc_layers/*`` along ``encoder_layers`` and ``dec_layers/*`` along
``num_layers`` (``enc_layers.{i}``, ``dec_layers.{i}`` in the port), with
``tok``, ``pos``, ``enc_ln`` and ``dec_ln`` unstacked; the VLM's holds the
projector ``proj/w1``, ``proj/w2`` and, under ``lm/``, a decoder-only tree
as above (``lm.layers.{i}`` in the port).

At a ``model`` axis above 1 (``model``, ``index``), ``params_from_jax``
keeps only the slice of each leaf that the rank at ``model`` coordinate
``index`` holds (``dist.sharding.model_slice`` on JAX's stacked shape),
before it unstacks the layers: the state dict of that rank's model
(:func:`model_dims` names the dim of each port tensor that is cut).  The
train step joins the slices back over ``model`` before ``params_to_jax``.

``params_to_jax`` is its inverse: named tensors (parameters or moments) to
the ``"/"``-keyed flat tree, ``layers.{i}`` restacked into ``pro`` and
``units/l{j}`` with the leading layer or unit axis (whisper's
``enc_layers.{i}`` and ``dec_layers.{i}`` along theirs), each leaf a numpy
array of the tensor's dtype (bf16 as f32, which numpy can hold).  The
checkpoint manager writes it under ``params/`` and ``opt/{m,v}/``.

The serving cache has a map of its own (:func:`cache_leaves`): the port's
per-layer cache (``{"pos", "layers": [entry, ...]}``, whisper's ``enc``
too) against JAX's stacked cache tree (``pos``, ``pro/{j}`` and
``units/l{e}/{j}``; whisper's ``kv/{j}`` and ``enc``), on which
``dist.sharding.cache_specs`` runs.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..dist.fsdp import Cut
from ..dist.sharding import fsdp_dim, model_dim, model_slice
from .registry import model_class
from .transformer import _cache_shapes, layer_plan


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def _decoder_names(parts, plan) -> Tuple[Any, Optional[int]]:
    """A decoder-only tree's key (split on "/"): (port name of stacked
    element u, the stack's length) or (port name, None)."""
    n_pro, unit_len = len(plan.prologue), len(plan.unit)
    if parts[0] == "pro":
        rest = ".".join(parts[1:])
        return (lambda u: f"layers.{u}.{rest}"), n_pro
    if parts[0] == "units":
        j = int(parts[1].removeprefix("l"))
        rest = ".".join(parts[2:])
        return (lambda u: f"layers.{n_pro + u * unit_len + j}.{rest}"), plan.n_units
    return ".".join(parts), None


def _port_names(key: str, cfg) -> Tuple[Any, Optional[int]]:
    """How the JAX leaf at ``key`` lands in the port: (a function of the
    stacked index u giving the port name, the stack's length) for a leaf
    stacked along a leading layer or unit axis, else (port name, None)."""
    parts = key.split("/")
    if cfg.family == "audio":
        if parts[0] in ("enc_layers", "dec_layers"):
            rest = ".".join(parts[1:])
            n = cfg.encoder_layers if parts[0] == "enc_layers" else cfg.num_layers
            return (lambda u: f"{parts[0]}.{u}.{rest}"), n
        return ".".join(parts), None
    if cfg.family == "vlm":
        if parts[0] != "lm":
            return ".".join(parts), None
        name, n = _decoder_names(parts[1:], layer_plan(cfg))
        return (f"lm.{name}", None) if n is None else ((lambda u: f"lm.{name(u)}"), n)
    return _decoder_names(parts, layer_plan(cfg))


def params_from_jax(params: Mapping[str, Any], cfg, dtype=None, model: int = 1,
                    index: int = 0) -> Dict[str, torch.Tensor]:
    """State dict of the port's model of ``cfg`` (CPU tensors in the dtypes
    of its parameters, or all in ``dtype``) from JAX params, nested or
    "/"-flattened; at a ``model`` axis above 1, of the rank at ``model``
    coordinate ``index``."""
    flat = _flatten(params)
    if model > 1:
        is_moe = cfg.moe is not None
        flat = {k: a[model_slice(k, a.shape, model, index, is_moe)] for k, a in flat.items()}
    dtypes = {name: dtype if dtype is not None else t.dtype
              for name, t in model_class(cfg)(cfg, torch.device("meta")).state_dict().items()}
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        if name not in dtypes:
            raise KeyError(f"{name}: no parameter of that name in the port's {cfg.name}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtypes[name])

    for key, arr in flat.items():
        name, n = _port_names(key, cfg)
        if n is None:
            put(name, arr)
            continue
        if arr.shape[0] != n:
            raise ValueError(f"{key}: leading axis {arr.shape[0]} != the {n} stacked")
        for u in range(n):
            put(name(u), arr[u])
    return out


def _decoder_key(parts, plan) -> Tuple[str, Optional[int], Optional[int]]:
    """Inverse of :func:`_decoder_names`: (JAX key, stacked index, stack
    length), the last two None for an unstacked leaf."""
    n_pro, unit_len = len(plan.prologue), len(plan.unit)
    if parts[0] != "layers":
        return "/".join(parts), None, None
    i, rest = int(parts[1]), "/".join(parts[2:])
    if i < n_pro:
        return f"pro/{rest}", i, n_pro
    u, j = divmod(i - n_pro, unit_len)
    return f"units/l{j}/{rest}", u, plan.n_units


def _jax_key(name: str, cfg) -> Tuple[str, Optional[int], Optional[int]]:
    """The JAX place of the port's tensor ``name``: (key, stacked index,
    stack length), the last two None for an unstacked leaf."""
    parts = name.split(".")
    if cfg.family == "audio":
        if parts[0] in ("enc_layers", "dec_layers"):
            n = cfg.encoder_layers if parts[0] == "enc_layers" else cfg.num_layers
            return f"{parts[0]}/{'/'.join(parts[2:])}", int(parts[1]), n
        return "/".join(parts), None, None
    if cfg.family == "vlm":
        if parts[0] == "lm":
            key, u, n = _decoder_key(parts[1:], layer_plan(cfg))
            return f"lm/{key}", u, n
        return "/".join(parts), None, None
    return _decoder_key(parts, layer_plan(cfg))


def jax_leaves(names, cfg) -> Dict[str, Any]:
    """JAX's leaves of the port's tensor ``names`` of ``cfg``'s model, in
    JAX's flattening order (keys sorted at every level): each ``"/"``-joined
    key maps to the tuple of port names stacked along its leading layer or
    unit axis, in stack order, or to the one port name of an unstacked leaf."""
    stacks: Dict[str, list] = {}
    out: Dict[str, Any] = {}
    for name in names:
        key, u, n = _jax_key(name, cfg)
        if u is None:
            out[key] = name
        else:
            stacks.setdefault(key, [None] * n)[u] = name
    for key, per_layer in stacks.items():
        if any(x is None for x in per_layer):
            raise ValueError(f"{key}: a layer of the {len(per_layer)} stacked is missing")
        out[key] = tuple(per_layer)
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def stacked_shapes(cfg):
    """(``jax_leaves`` of the port's model of ``cfg``, JAX's global stacked
    shape of each leaf), from the model built on the meta device."""
    named = dict(model_class(cfg)(cfg, torch.device("meta")).named_parameters())
    leaves = jax_leaves(named, cfg)
    shapes = {k: (len(n),) + tuple(named[n[0]].shape) if isinstance(n, tuple)
              else tuple(named[n].shape) for k, n in leaves.items()}
    return leaves, shapes


def model_dims(cfg, model: int) -> Dict[str, Optional[int]]:
    """For each parameter name of the port's model of ``cfg``, the dim of
    its (per-layer) tensor that a ``model`` axis of that size cuts
    (``dist.sharding.model_dim`` on JAX's stacked leaf), or None."""
    leaves, shapes = stacked_shapes(cfg)
    is_moe = cfg.moe is not None
    out: Dict[str, Optional[int]] = {}
    for key, names in leaves.items():
        d = model_dim(key, shapes[key], model, is_moe)
        if isinstance(names, tuple):
            if d == 0:
                raise NotImplementedError(f"{key}: cut along its stacked layer axis over model")
            d = None if d is None else d - 1
        else:
            names = (names,)
        out.update((n, d) for n in names)
    return out


def fsdp_cuts(cfg, model: int, n_dp: int) -> Dict[str, Optional[Cut]]:
    """For each parameter name of the port's model of ``cfg``, how ZeRO-3
    over ``n_dp`` DP ranks cuts its (per-layer) tensor
    (``dist.sharding.fsdp_dim`` on JAX's stacked leaf at a ``model`` axis
    of that size): ``(dim, None)`` for a cut along the tensor's ``dim``,
    ``(None, owner)`` for a layer that DP index ``owner`` holds whole (the
    stacked layer axis cut), or None for a tensor whole on every DP rank."""
    leaves, shapes = stacked_shapes(cfg)
    is_moe = cfg.moe is not None
    out = {}
    for key, names in leaves.items():
        d = fsdp_dim(key, shapes[key], model, n_dp, is_moe)
        if not isinstance(names, tuple):
            out[names] = None if d is None else (d, None)
        elif d == 0:
            per = len(names) // n_dp
            out.update((n, (None, u // per)) for u, n in enumerate(names))
        else:
            out.update((n, None if d is None else (d - 1, None)) for n in names)
    return out


def params_to_jax(tensors: Mapping[str, torch.Tensor], cfg) -> Dict[str, np.ndarray]:
    """The ``"/"``-keyed flat JAX tree of named tensors of the port's model
    of ``cfg`` (its parameters, or AdamW moments under the same names):
    numpy leaves, bf16 widened to f32, each stacked group of layers or units
    along its leading axis.  A leaf of an fp32 CPU tensor outside the
    stacks shares its memory."""
    flat: Dict[str, np.ndarray] = {}
    stacks: Dict[str, list] = {}
    for name, t in tensors.items():
        t = t.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        key, u, n = _jax_key(name, cfg)
        if u is None:
            flat[key] = arr
        else:
            stacks.setdefault(key, [None] * n)[u] = arr
    for key, per_layer in stacks.items():
        if any(a is None for a in per_layer):
            raise ValueError(f"{key}: a layer of the {len(per_layer)} stacked is missing")
        flat[key] = np.stack(per_layer)
    return flat


def cache_leaves(cfg) -> Dict[str, Any]:
    """JAX's serving-cache leaves of ``cfg``'s model against the port's
    cache, in JAX's flattening order: each ``"/"``-joined key maps to the
    tuple of port places ``(i, j)`` (tensor ``j`` of ``cache["layers"][i]``)
    stacked along its leading layer or unit axis, or to the port's key of
    an unstacked entry (``"pos"``, a Python int in the port; whisper's
    ``"enc"``)."""
    out: Dict[str, Any] = {"pos": "pos"}
    if cfg.family == "audio":
        out["enc"] = "enc"
        for j in range(2):
            out[f"kv/{j}"] = tuple((i, j) for i in range(cfg.num_layers))
    else:
        plan = layer_plan(cfg)
        n_pro, unit = len(plan.prologue), len(plan.unit)
        if n_pro:
            for j in range(len(_cache_shapes(plan.prologue[0], cfg, 1, 1))):
                out[f"pro/{j}"] = tuple((p, j) for p in range(n_pro))
        for e, spec in enumerate(plan.unit if plan.n_units else ()):
            for j in range(len(_cache_shapes(spec, cfg, 1, 1))):
                out[f"units/l{e}/{j}"] = tuple((n_pro + u * unit + e, j)
                                               for u in range(plan.n_units))
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def cache_shapes(cfg, batch: int, s_max: int) -> Dict[str, Tuple[int, ...]]:
    """JAX's stacked shape of each leaf of :func:`cache_leaves` for a batch
    of ``batch`` rows and ``s_max`` slots (the VLM's cache has
    ``vision_tokens`` more, as its ``init_cache`` makes it)."""
    if cfg.family == "vlm":
        s_max += cfg.vision_tokens
    plan = layer_plan(cfg).layers()
    out: Dict[str, Tuple[int, ...]] = {}
    for key, places in cache_leaves(cfg).items():
        if key == "pos":
            out[key] = ()
        elif key == "enc":
            out[key] = (batch, cfg.encoder_seq, cfg.d_model)
        elif cfg.family == "audio":
            out[key] = (len(places), batch, s_max, cfg.num_kv_heads, cfg.head_dim)
        else:
            i, j = places[0]
            out[key] = (len(places),) + tuple(_cache_shapes(plan[i], cfg, batch, s_max)[j][0])
    return out
