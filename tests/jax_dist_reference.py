"""JAX's distributed train steps on a forced host mesh: the references of the
port's distributed steps in the CPU tests.

    python tests/jax_dist_reference.py JOB.json

sets ``XLA_FLAGS=--xla_force_host_platform_device_count=job["devices"]``
before it imports jax (a process that has imported jax keeps its one
device), then runs each case of ``job["cases"]``:

``{"name", "arch", "cfg", "mesh": [shape, axes], "hp", "opt", "init",
"batches", "steps", "ckpt": dir or absent}``: ``make_train_step`` of the
smoke config, from the weights of ``init`` (JAX's flat ``params/...``
leaves), on the global batches ``batches/{i}/...``; with ``ckpt``, JAX's
``save_checkpoint`` after every step.  It writes ``{out}/{name}.jax.npz``:
``loss``, ``grad_norm``, ``lr`` per step, ``params/{key}`` whole,
``m/{r}/{key}`` and ``v/{r}/{key}`` the moment shards of the device at the
mesh coordinates ``np.unravel_index(r, shape)`` (read from
``mesh.devices``), and ``device_ids``, ``mesh.devices`` in row-major order.

The mesh is ``jax.make_mesh`` with Auto axes: jax 0.9.0's default Explicit
axes make the pjit step fail (ROADMAP C.1).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np


def main(path: str) -> None:
    with open(path) as f:
        job = json.load(f)
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={job['devices']}"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.ckpt.manager import save_checkpoint
    from repro.dist.sharding import _path_str
    from repro.models import get_api, smoke_config
    from repro.train.optimizer import OptConfig
    from repro.train.trainstep import TrainHparams, make_train_state, make_train_step

    for case in job["cases"]:
        cfg = smoke_config(case["arch"]).replace(**case.get("cfg", {}))
        api = get_api(cfg)
        shape, axes = tuple(case["mesh"][0]), tuple(case["mesh"][1])
        mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
        with np.load(case["batches"]) as f:
            batches = [{k.split("/")[2]: f[k] for k in f.files if k.startswith(f"batches/{i}/")}
                       for i in range(case["steps"])]
        sds = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batches[0].items()}
        step, s_shard, _ = make_train_step(api, cfg, OptConfig(**case["opt"]), mesh,
                                           TrainHparams(**case["hp"]), sds)
        state = make_train_state(api, jax.random.PRNGKey(0))
        with np.load(case["init"]) as f:
            state["params"] = jax.tree_util.tree_map_with_path(
                lambda p, leaf: jnp.asarray(f["params/" + _path_str(p)], leaf.dtype),
                state["params"])
        state = jax.device_put(state, s_shard)
        position = {d.id: np.ravel_multi_index(idx, shape)
                    for idx, d in np.ndenumerate(mesh.devices)}

        def dump(prefix=""):
            out = {}
            for p, leaf in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
                out[f"{prefix}params/{_path_str(p)}"] = np.asarray(leaf, np.float32)
            for g in ("m", "v"):
                for p, leaf in jax.tree_util.tree_flatten_with_path(state["opt"][g])[0]:
                    for shard in leaf.addressable_shards:
                        r = position[shard.device.id]
                        out[f"{prefix}{g}/{r}/{_path_str(p)}"] = np.asarray(shard.data)
            return out

        res = {"loss": [], "grad_norm": [], "lr": []}
        kept = {}
        for i in range(case["steps"]):
            state, metrics = step(state, {k: jnp.asarray(v) for k, v in batches[i].items()})
            for k in res:
                res[k].append(float(metrics[k]))
            if case.get("ckpt"):
                save_checkpoint(case["ckpt"], i, state)
            if i in case.get("keep", ()):
                kept.update(dump(f"after{i}/"))
        arrays = {k: np.asarray(v) for k, v in res.items()}
        arrays["device_ids"] = np.asarray([d.id for d in mesh.devices.flat])
        arrays.update(dump(), **kept)
        np.savez(os.path.join(job["out"], f"{case['name']}.jax.npz"), **arrays)


if __name__ == "__main__":
    main(sys.argv[1])
