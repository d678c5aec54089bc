"""The weight bridge: JAX parameters (as numpy arrays) -> a torch state_dict.

``params_from_jax`` takes the JAX package's parameter pytree with numpy
leaves, or the same tree flattened under the ``"/"``-joined keys that the
JAX checkpoint manager writes (``ckpt/manager.py:_flatten``, where bf16 is
stored as f32).  It

* unstacks the leading layer axis of ``params["units"]["l{j}"]``: unit
  ``u``, element ``j`` becomes ``layers.{i}`` with ``i = u * len(unit) + j``,
  the order of :meth:`repro_torch.models.transformer.LayerPlan.layers` (the
  dense family has no prologue);
* keeps every weight's (in, out) orientation, because the port's layers
  compute ``x @ W`` as JAX does (no transpose, no ``nn.Linear``);
* gives each leaf the dtype of the port's parameter of that name: the
  config's param dtype, except where the model keeps a parameter in fp32
  whatever ``param_dtype`` is (RWKV's decay base ``w0`` and bonus ``u``, as
  the JAX initialiser does).  A checkpoint stores bf16 as f32, so the
  leaf's own dtype cannot say which parameters are bf16.  Widening bf16 to
  f32 and back is exact, so every value arrives bit for bit.
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


def params_from_jax(params: Mapping[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~repro_torch.models.transformer.DecoderLM` (CPU
    tensors in the dtypes of its parameters) from JAX params, nested or
    "/"-flattened."""
    flat = _flatten(params)
    plan = layer_plan(cfg)
    unit_len = len(plan.unit)
    dtypes = {name: t.dtype
              for name, t in DecoderLM(cfg, torch.device("meta")).state_dict().items()}
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, arr: np.ndarray) -> None:
        if name not in dtypes:
            raise KeyError(f"{name}: no parameter of that name in the port's {cfg.name}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtypes[name])

    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "units":
            j = int(parts[1].removeprefix("l"))
            rest = ".".join(parts[2:])
            if arr.shape[0] != plan.n_units:
                raise ValueError(f"{key}: leading axis {arr.shape[0]} != {plan.n_units} units")
            for u in range(plan.n_units):
                put(f"layers.{u * unit_len + j}.{rest}", arr[u])
        else:
            put(".".join(parts), arr)
    return out
