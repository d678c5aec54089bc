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

A case with ``"serve"`` is JAX's sharded serving instead:
``{"name", "arch", "cfg", "mesh", "serve": {"fsdp", "max_new", "s_max"},
"init", "inputs"}`` jits ``api.prefill`` (``last_only``) and
``api.decode`` with ``in_shardings`` from ``param_specs`` (``fsdp``),
``batch_specs`` and ``cache_specs``, as ``launch/dryrun.py`` builds them,
and decodes greedily from the prompts ``inputs`` (``tokens`` and the
arch's ``frames`` or ``patches``), the decode tokens handed in as host
numpy and the cache put back in ``cache_specs``' layout before each step.  It writes ``logits/{i}`` (call ``i``'s last-position logits: the
prefill, then each decode step), ``tokens``, the whole cache after the
prefill and after the last step (``cache/prefill/{key}``,
``cache/last/{key}``), and, for an MoE model, each MoE layer's top-k
experts of every token (``routing/{i}``, in call and layer order) and the
picks each expert kept (``kept/{i}``).

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
        if "serve" in case:
            serve_case(case, job["out"])
            continue
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


def serve_case(case: dict, out: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.dist.sharding import _path_str, batch_specs, cache_specs, param_specs, \
        to_shardings
    from repro.models import get_api, moe, smoke_config

    cfg = smoke_config(case["arch"])
    if case.get("cfg"):
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
                             else v for k, v in case["cfg"].items()})
    api, sv = get_api(cfg), case["serve"]
    shape, axes = tuple(case["mesh"][0]), tuple(case["mesh"][1])
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
    with np.load(case["inputs"]) as f:
        inputs = {k: f[k] for k in f.files}
    B = inputs["tokens"].shape[0]
    abstract = jax.eval_shape(api.init, jax.random.PRNGKey(0))
    with np.load(case["init"]) as f:
        params = jax.tree_util.tree_map_with_path(
            lambda p, leaf: jnp.asarray(f["params/" + _path_str(p)], leaf.dtype), abstract)
    cache = api.init_cache(B, sv["s_max"])
    p_shard = to_shardings(param_specs(abstract, mesh, cfg, fsdp=sv["fsdp"]), mesh)
    c_shard = to_shardings(cache_specs(cache, mesh, cfg), mesh)
    b_shard = to_shardings(batch_specs(inputs, mesh), mesh)
    t_shard = to_shardings(batch_specs({"t": np.zeros((B, 1), np.int32)}, mesh), mesh)["t"]
    prefill = jax.jit(lambda p, b, c: api.prefill(p, b, c, last_only=True),
                      in_shardings=(p_shard, b_shard, c_shard))
    decode = jax.jit(api.decode, in_shardings=(p_shard, t_shard, c_shard))

    # each MoE layer's routing, in call and layer order: the top-k experts
    # and the picks each expert kept (rows of its input that are not the
    # zero pad row)
    seen = {"routing": [], "kept": []}
    top_k, expert_ffn = jax.lax.top_k, moe._expert_ffn

    def spy_top_k(scores, k):
        gates, idx = top_k(scores, k)
        jax.debug.callback(lambda a: seen["routing"].append(np.asarray(a)), idx)
        return gates, idx

    def spy_ffn(p, x, c):
        jax.debug.callback(lambda a: seen["kept"].append(np.asarray(a)),
                           (x != 0).any(-1).sum(-1))
        return expert_ffn(p, x, c)

    jax.lax.top_k, moe._expert_ffn = spy_top_k, spy_ffn
    arrays = {}

    def dump(tag, tree):
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            arrays[f"cache/{tag}/{_path_str(p)}"] = np.asarray(leaf, np.float32)

    try:
        params = jax.device_put(params, p_shard)
        cache = jax.device_put(cache, c_shard)
        batch = {k: jnp.asarray(v) for k, v in inputs.items()}
        logits, cache = prefill(params, batch, cache)
        dump("prefill", cache)
        steps = [np.asarray(logits[:, -1], np.float32)]
        toks = [np.argmax(steps[-1], axis=-1).astype(np.int32)]
        for _ in range(sv["max_new"] - 1):
            jax.effects_barrier()  # a call's routing before the next call's
            # the prefill's output layout is not cache_specs' everywhere (whisper's
            # enc at model > 1), and the jitted decode refuses it: put it back
            cache = jax.device_put(cache, c_shard)
            logits, cache = decode(params, toks[-1][:, None], cache)  # host numpy tokens
            steps.append(np.asarray(logits[:, -1], np.float32))
            toks.append(np.argmax(steps[-1], axis=-1).astype(np.int32))
        dump("last", cache)
        jax.effects_barrier()
    finally:
        jax.lax.top_k, moe._expert_ffn = top_k, expert_ffn
    arrays.update({f"logits/{i}": a for i, a in enumerate(steps)})
    arrays["tokens"] = np.stack(toks, axis=1)
    for what in ("routing", "kept"):
        arrays.update({f"{what}/{i}": a for i, a in enumerate(seen[what])})
    np.savez(os.path.join(out, f"{case['name']}.jax.npz"), **arrays)


if __name__ == "__main__":
    main(sys.argv[1])
