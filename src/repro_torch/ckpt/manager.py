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

The state of a distributed step (``train.trainstep.MeshStep``) holds each
rank's ZeRO-1 slice of the moments under JAX's keys, and on a ``model``
axis above 1 each rank's ``model`` slice of every parameter; under ZeRO-3
(``fsdp``) its blocks of the parameters and the moments over pod x data.
Saving it gathers the parameters and the moments whole over ``model`` and
the DP axes and rank 0 writes the same file as a single-device save;
restoring it, every rank reads the file and keeps its slices (or blocks)
under the target mesh (JAX's elastic restore), so a checkpoint moves
between meshes, with and without ZeRO-3, and between the port and JAX.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

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


def _snapshot(state: dict, mesh_step=None) -> Optional[Dict[str, Dict[str, torch.Tensor]]]:
    """Host copies of every leaf as they are now, complete when this returns:
    the live tensors change in place on the next step, and the writer
    thread reads the copies.  With ``mesh_step`` (a sharded state) the
    parameters and the moments are gathered whole under JAX's keys, a
    collective every rank joins, and only rank 0 gets the copies (None
    elsewhere)."""
    opt = state["opt"]
    writes = mesh_step is None or dist.get_rank() == 0

    def gathered(tensors, whole):
        out = {}
        for k, t in tensors.items():
            t = whole(k, t)  # every rank joins
            if writes:
                out[k] = _host_copy(t)
        return out

    named = {n: p.detach() for n, p in state["model"].named_parameters()}
    if mesh_step is None:
        snap = {"params": {n: _host_copy(p) for n, p in named.items()},
                "opt/m": {n: _host_copy(t) for n, t in opt["m"].items()},
                "opt/v": {n: _host_copy(t) for n, t in opt["v"].items()}}
    else:
        stacked = {k: mesh_step.param(named, k) for k in mesh_step.leaves}
        snap = {"params": gathered(stacked, mesh_step.whole_param),
                "opt/m": gathered(opt["m"], mesh_step.gather),
                "opt/v": gathered(opt["v"], mesh_step.gather)}
        del stacked
    if not writes:
        return None
    snap["opt/step"] = _host_copy(opt["step"])
    if opt["step"].device.type == "cuda":
        torch.cuda.current_stream(opt["step"].device).synchronize()
    return snap


def _flatten(snap: dict, cfg, jax_keys: bool = False) -> Dict[str, np.ndarray]:
    """JAX's keys and leaves, in JAX's flattening order (keys sorted at
    every level); ``jax_keys``: the snapshot is under JAX's keys already."""
    flat = {}
    for prefix, _ in _GROUPS:
        leaves = ({k: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                   for k, t in snap[prefix].items()}
                  if jax_keys else params_to_jax(snap[prefix], cfg))
        flat.update({f"{prefix}/{k}": a for k, a in leaves.items()})
    flat["opt/step"] = snap["opt/step"].numpy().astype(np.int32)
    return dict(sorted(flat.items(), key=lambda kv: kv[0].split("/")))


def save_checkpoint(
    ckpt_dir: str, step: int, state: dict, *, background: bool = False, mesh_step=None
) -> Optional[Writer]:
    """Write ``state`` as checkpoint ``step``.  With ``background``, return
    the started :class:`Writer` once the host copy is taken; else write and
    return None.  A state of a distributed step (``mesh_step``, the
    :class:`~repro_torch.train.trainstep.MeshStep` it trains with) is saved
    by every rank together: its moments are gathered and rank 0 writes the
    same file as a single-device save (the other ranks return None)."""
    snap = _snapshot(state, mesh_step)
    if snap is None:
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    cfg = state["model"].cfg

    def write():
        flat = _flatten(snap, cfg, jax_keys=mesh_step is not None)
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
def restore_checkpoint(ckpt_dir: str, state: dict, step: Optional[int] = None,
                       mesh_step=None) -> int:
    """Copy checkpoint ``step`` (default: the latest) into the live model
    and optimizer state of ``state``, in place; returns the step.  Every
    leaf must be present with the live tensor's shape.  With ``mesh_step``
    (JAX's elastic restore, ``restore_checkpoint(shardings=)``), every rank
    reads the file and keeps its slice of each parameter and moment under
    that step's mesh, whatever mesh wrote it."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    model, opt = state["model"], state["opt"]
    live = {"params": dict(model.named_parameters()), "opt/m": opt["m"], "opt/v": opt["v"]}
    with np.load(os.path.join(ckpt_dir, f"step_{step}.npz")) as data:
        def group(prefix, dtype):
            tree = {k[len(prefix) + 1:]: data[k] for k in data.files if k.startswith(prefix + "/")}
            if mesh_step is None:
                return params_from_jax(tree, model.cfg, dtype)
            if prefix == "params":
                return mesh_step.param_state(tree, dtype)
            return {k: torch.from_numpy(np.asarray(a, dtype=np.float32)) for k, a in tree.items()}
        got = {prefix: group(prefix, dtype) for prefix, dtype in _GROUPS}
        saved_step = data["opt/step"]
    for prefix, tensors in got.items():  # check everything before writing anything
        if tensors.keys() != live[prefix].keys():
            raise KeyError(f"{prefix}: checkpoint {step} lacks "
                           f"{sorted(live[prefix].keys() - tensors.keys())[:3]}")
        for name, t in tensors.items():
            if mesh_step is not None and prefix != "params":
                if tuple(t.shape) != mesh_step.shapes[name]:
                    raise ValueError(f"shape mismatch for {prefix}/{name}: {tuple(t.shape)} "
                                     f"vs {mesh_step.shapes[name]}")
                tensors[name] = t = mesh_step.shard(name, t)
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
