"""Checkpoints of the port's train state, in the JAX package's on-disk format.

Format (``repro.ckpt.manager``'s): one ``step_{n}.npz`` per checkpoint
holding every leaf of JAX's train state ``{"params", "opt": {"m", "v",
"step"}}`` under its ``"/"``-joined pytree path (``params/units/l0/mix/wq``,
``opt/m/...``, ``opt/v/...``, ``opt/step``), plus a ``step_{n}.json``
manifest ``{"step", "leaves": {key: [shape, dtype]}}``.  bf16 is stored as
f32 (lossless; restore casts back to the live tensor's dtype) and the step
as int32.  Both files are written under a ``.tmp_`` name and moved into
place with ``os.replace``, so a checkpoint is whole or absent.  A checkpoint
written by either package restores into the other bit for bit; the port's
``layers.{i}`` go through the weight bridge (``models.convert``) to and
from JAX's stacked ``units/l{j}``.

The port's state is ``{"model": DecoderLM, "opt": {"m", "v", "step"}}``
(``train.trainstep.make_train_state``), and its AdamW changes the
parameters and moments in place, where JAX's state is immutable.  So
:func:`save_checkpoint` copies every leaf to the host before it returns,
and a background write works on that copy while training goes on.  From
the card the copies go to pinned memory, which PyTorch's host allocator
keeps for the next save.
Restoring with other shardings (JAX's elastic restore) waits for the
distributed steps (ROADMAP A.7).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.convert import params_from_jax, params_to_jax

_GROUPS = (("params", None), ("opt/m", torch.float32), ("opt/v", torch.float32))


class Writer(threading.Thread):
    """A background write.  :meth:`join` re-raises what the write raised;
    ``seconds`` is how long it took."""

    def __init__(self, write):
        super().__init__(daemon=True)
        self._write = write
        self.error: Optional[BaseException] = None
        self.seconds: Optional[float] = None

    def run(self) -> None:
        t0 = time.perf_counter()
        try:
            self._write()
        except BaseException as e:  # handed to the joining thread
            self.error = e
        finally:
            self._write = None  # frees the host copy while the caller keeps the thread
        self.seconds = time.perf_counter() - t0

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.error is not None:
            raise RuntimeError("background checkpoint write failed") from self.error


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory.  From the card it goes into pinned
    memory without waiting; :func:`_snapshot` waits for all of them."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()  # ``.numpy()`` of the live tensor would alias it
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _snapshot(state: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """Host copies of every leaf as they are now, complete when this returns:
    the live tensors change in place on the next step, and the writer
    thread reads the copies."""
    opt = state["opt"]
    snap = {
        "params": {n: _host_copy(p) for n, p in state["model"].named_parameters()},
        "opt/m": {n: _host_copy(t) for n, t in opt["m"].items()},
        "opt/v": {n: _host_copy(t) for n, t in opt["v"].items()},
        "opt/step": _host_copy(opt["step"]),
    }
    if opt["step"].device.type == "cuda":
        torch.cuda.current_stream(opt["step"].device).synchronize()
    return snap


def _flatten(snap: dict, cfg) -> Dict[str, np.ndarray]:
    """JAX's keys and leaves, in JAX's flattening order (keys sorted at
    every level)."""
    flat = {f"{prefix}/{k}": a
            for prefix, _ in _GROUPS for k, a in params_to_jax(snap[prefix], cfg).items()}
    flat["opt/step"] = snap["opt/step"].numpy().astype(np.int32)
    return dict(sorted(flat.items(), key=lambda kv: kv[0].split("/")))


def save_checkpoint(
    ckpt_dir: str, step: int, state: dict, *, background: bool = False
) -> Optional[Writer]:
    """Write ``state`` as checkpoint ``step``.  With ``background``, return
    the started :class:`Writer` once the host copy is taken; else write and
    return None."""
    os.makedirs(ckpt_dir, exist_ok=True)
    snap = _snapshot(state)
    cfg = state["model"].cfg

    def write():
        flat = _flatten(snap, cfg)
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
        np.savez(tmp, **flat)
        os.replace(tmp, os.path.join(ckpt_dir, f"step_{step}.npz"))
        manifest = {
            "step": step,
            "leaves": {k: [list(v.shape), str(v.dtype)] for k, v in flat.items()},
        }
        mtmp = os.path.join(ckpt_dir, f".tmp_step_{step}.json")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(ckpt_dir, f"step_{step}.json"))

    if background:
        writer = Writer(write)
        writer.start()
        return writer
    write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step with a manifest in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for fn in os.listdir(ckpt_dir):
        if fn.startswith("step_") and fn.endswith(".json"):
            try:
                steps.append(int(fn[5:-5]))
            except ValueError:
                pass
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state: dict, step: Optional[int] = None) -> int:
    """Copy checkpoint ``step`` (default: the latest) into the live model
    and optimizer state of ``state``, in place; returns the step.  Every
    leaf must be present with the live tensor's shape."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    model, opt = state["model"], state["opt"]
    live = {"params": dict(model.named_parameters()), "opt/m": opt["m"], "opt/v": opt["v"]}
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as data:
        got = {prefix: params_from_jax({k[len(prefix) + 1:]: data[k] for k in data.files
                                        if k.startswith(prefix + "/")}, model.cfg, dtype)
               for prefix, dtype in _GROUPS}
        saved_step = data["opt/step"]
    for prefix, tensors in got.items():  # check everything before writing anything
        if tensors.keys() != live[prefix].keys():
            raise KeyError(f"{prefix}: checkpoint {step} lacks "
                           f"{sorted(live[prefix].keys() - tensors.keys())[:3]}")
        for name, t in tensors.items():
            if t.shape != live[prefix][name].shape:
                raise ValueError(f"shape mismatch for {prefix}/{name}: "
                                 f"{tuple(t.shape)} vs {tuple(live[prefix][name].shape)}")
    if saved_step.shape != ():
        raise ValueError(f"shape mismatch for opt/step: {saved_step.shape} vs ()")
    for prefix, tensors in got.items():
        for name, t in tensors.items():
            live[prefix][name].copy_(t)
    opt["step"].copy_(torch.from_numpy(saved_step.astype(np.int32)))
    return step
