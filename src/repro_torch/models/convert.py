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

``params_to_jax`` is its inverse: named tensors (parameters or moments) to
the ``"/"``-keyed flat tree, ``layers.{i}`` restacked into ``pro`` and
``units/l{j}`` with the leading layer or unit axis, each leaf a numpy array of the tensor's dtype
(bf16 as f32, which numpy can hold).  The checkpoint manager writes it
under ``params/`` and ``opt/{m,v}/``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .transformer import DecoderLM, layer_plan


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val)
    return flat


def params_from_jax(params: Mapping[str, Any], cfg, dtype=None) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~repro_torch.models.transformer.DecoderLM` (CPU
    tensors in the dtypes of its parameters, or all in ``dtype``) from JAX
    params, nested or "/"-flattened."""
    flat = _flatten(params)
    plan = layer_plan(cfg)
    n_pro, unit_len = len(plan.prologue), len(plan.unit)
    dtypes = {name: dtype if dtype is not None else t.dtype
              for name, t in DecoderLM(cfg, torch.device("meta")).state_dict().items()}
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        if name not in dtypes:
            raise KeyError(f"{name}: no parameter of that name in the port's {cfg.name}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtypes[name])

    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "pro":
            rest = ".".join(parts[1:])
            if arr.shape[0] != n_pro:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} != {n_pro} prologue layers")
            for p in range(n_pro):
                put(f"layers.{p}.{rest}", arr[p])
        elif parts[0] == "units":
            j = int(parts[1].removeprefix("l"))
            rest = ".".join(parts[2:])
            if arr.shape[0] != plan.n_units:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} != {plan.n_units} units")
            for u in range(plan.n_units):
                put(f"layers.{n_pro + u * unit_len + j}.{rest}", arr[u])
        else:
            put(".".join(parts), arr)
    return out


def params_to_jax(tensors: Mapping[str, torch.Tensor], cfg) -> Dict[str, np.ndarray]:
    """The ``"/"``-keyed flat JAX tree of named tensors of the port's
    :class:`~repro_torch.models.transformer.DecoderLM` (its parameters, or
    AdamW moments under the same names): numpy leaves, bf16 widened to f32,
    the prologue's layers stacked along a leading layer axis and the units'
    per unit element along a leading unit axis.  A leaf of an fp32 CPU
    tensor outside the layers shares its memory."""
    plan = layer_plan(cfg)
    n_pro, unit_len = len(plan.prologue), len(plan.unit)
    flat: Dict[str, np.ndarray] = {}
    stacks: Dict[str, list] = {}
    for name, t in tensors.items():
        t = t.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            i, rest = int(parts[1]), "/".join(parts[2:])
            if i < n_pro:
                stacks.setdefault(f"pro/{rest}", [None] * n_pro)[i] = arr
            else:
                u, j = divmod(i - n_pro, unit_len)
                stacks.setdefault(f"units/l{j}/{rest}", [None] * plan.n_units)[u] = arr
        else:
            flat["/".join(parts)] = arr
    for key, per_layer in stacks.items():
        if any(a is None for a in per_layer):
            raise ValueError(f"{key}: a layer of the {len(per_layer)} stacked is missing")
        flat[key] = np.stack(per_layer)
    return flat
