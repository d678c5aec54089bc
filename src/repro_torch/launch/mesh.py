"""Device meshes over ``torch.distributed`` (the PyTorch twin of
``repro.launch.mesh``).

The mesh mirrors the paper's cluster architecture (§3.1): the ``model`` axis
is the intra-pod electrical domain (TP/EP traffic confined in-pod), the
``data`` axis spans a pod's DP groups, and the ``pod`` axis crosses the OCS
optical core — the traffic Cross Wiring engineers.

A :class:`Mesh` holds the axis names and the shape.  Built over the process
group (:func:`make_mesh`), it also holds a ``DeviceMesh``
(``torch.distributed.device_mesh.init_device_mesh``) with one process group
per axis, and the device of this rank.  Rank r sits at the coordinates
``np.unravel_index(r, shape)``: row-major, as ``jax.make_mesh`` lays out
host devices.  The backend follows the device: NCCL for ``cuda``, one card a
rank (``cuda:LOCAL_RANK``), gloo for ``cpu``.  There is no fallback: a
``cuda`` mesh without NCCL, or with fewer cards than ranks on the host,
raises.

The process group is joined once per process (:func:`init_world`): from the
``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment that
``python -m torch.distributed.run`` sets, from an explicit ``init_method``
(tests use ``file://``), or, for a world of one, on a free port of
localhost.  :func:`shutdown` leaves it.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and shape; with ``device_mesh``, the process groups of a
    built mesh and this rank's ``device``.  Without them it is a layout
    only, which the sharding rules take (``mesh_layout``)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    device: torch.device = torch.device("cpu")
    device_mesh: Optional[object] = None

    def group(self, axis: str):
        """The process group of this rank along ``axis``; its group ranks
        follow the axis's coordinate."""
        if self.device_mesh is None:
            raise RuntimeError("a mesh layout has no process groups: build it with make_mesh")
        return self.device_mesh.get_group(axis)

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """{axis: index} of ``rank`` (default: this process's)."""
        rank = dist.get_rank() if rank is None else rank
        return dict(zip(self.axis_names, (int(i) for i in np.unravel_index(rank, self.shape))))


def mesh_layout(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh's layout without process groups (for the sharding rules)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device(device, local_world: int) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for ``cuda``; raises
    without NCCL or with fewer cards than the ``local_world`` ranks of the
    host."""
    device = torch.device(device)
    if device.type not in _BACKEND:
        raise ValueError(f"no process-group backend for device type {device.type!r}")
    if device.type == "cpu":
        return torch.device("cpu")
    if not dist.is_nccl_available():
        raise RuntimeError("a cuda mesh needs NCCL, and this torch has none")
    local = device.index if device.index is not None else int(os.environ.get("LOCAL_RANK", 0))
    cards = torch.cuda.device_count()
    if max(local + 1, local_world) > cards:
        raise RuntimeError(f"{local_world} ranks on this host (this one on cuda:{local}), and "
                           f"the host shows {cards} cards: NCCL takes one card a rank")
    return torch.device("cuda", local)


def init_world(device="cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> torch.device:
    """Join the default process group with ``device``'s backend, unless this
    process has joined it already (then the backend must match); returns
    this rank's device."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     world_size or os.environ.get("WORLD_SIZE", 1)))
    dev = _device(device, local_world)
    backend = _BACKEND[dev.type]
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}; a "
                               f"{dev.type} mesh needs {backend}")
        return dev
    if init_method is None:
        if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
            init_method = "env://"
        elif world_size in (None, 1):
            init_method, world_size, rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0
        else:
            raise RuntimeError(f"a world of {world_size} needs an init_method or the "
                               "environment of torch.distributed.run")
    kw = {} if init_method == "env://" else {"world_size": world_size, "rank": rank}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, **kw)
    return dev


def shutdown() -> None:
    """Leave the default process group (and every mesh's groups)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device="cuda", **init) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the whole world (joined with
    :func:`init_world` and ``init`` if this process has not yet)."""
    from torch.distributed.device_mesh import init_device_mesh

    layout = mesh_layout(shape, axes)
    dev = init_world(device, **init)
    world = dist.get_world_size()
    if math.prod(layout.shape) != world:
        raise ValueError(f"a mesh of shape {layout.shape} needs {math.prod(layout.shape)} "
                         f"ranks; the world has {world}")
    dm = init_device_mesh(dev.type, layout.shape, mesh_dim_names=layout.axis_names)
    return dataclasses.replace(layout, device=dev, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False, device="cuda", **init) -> Mesh:
    """(16, 16) single-pod or (2, 16, 16) two-pod production mesh: raises
    unless the world has 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device, **init)


def make_host_mesh(model: Optional[int] = None, device="cuda", **init) -> Mesh:
    """(world // model, model) over ("data", "model") on every rank."""
    init_world(device, **init)
    model = model or 1
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"model axis {model} does not divide the world of {world}")
    return make_mesh((world // model, model), ("data", "model"), device)


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Axes that carry data parallelism (pod × data when multi-pod)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
