"""Ranks of the port's distributed train steps for the CPU tests (gloo).

    python tests/torch_dist_ranks.py JOB.json RANK

runs the tasks of ``JOB.json`` as rank RANK of ``job["world"]``, joined
through ``file://job["store"]``, and writes ``{out}/{task}.rank{RANK}.npz``
for each task.  It imports no JAX (the JAX references run in
``tests/jax_dist_reference.py``).  :func:`run_ranks` starts the ranks from a
test and brings every one down if any fails or the time runs out.

A task ``{"name", "arch", "mesh": [shape, axes], "hp", "opt", "init",
"batches", "steps"}``, with optional ``"ties": margin``, ``"ckpt": {"dir",
"after": [steps]}``, ``"keep": [steps]``, ``"restore": dir`` and
``"restore_step"``, builds
``make_train_step`` on the mesh for the smoke config of ``arch``, loads the
weights of ``init`` (an ``.npz`` of JAX's flat ``params/...`` leaves) or
restores the checkpoint ``restore`` (its latest, or ``restore_step``), and
takes the steps after the restored one (or from 0) up to ``steps`` on the
global batches ``batches/{i}/...`` of the ``.npz``, saving a checkpoint
after each step of ``ckpt["after"]``.  It writes ``loss``, ``grad_norm``
and ``lr`` per step, ``coords``, the state after the last step as this rank
holds it (``params/{key}`` gathered whole over ``model`` and, under
``fsdp``, the DP axes, ``m/{key}`` and ``v/{key}`` the rank's slices,
``step``), the shape of the rank's slice (or ZeRO-3 block) of each
parameter (``local/{key}``) and their elements (``numel``), the
moments gathered whole (``full_m/{key}``, ``full_v/{key}``), the last
step's ``comm`` (``comm/{axis}``: calls, bytes), with ``keep`` the state
after each of those steps as above under ``after{i}/`` and, with ``ties``, per
leaf the entries of this rank's shard that the int8 quantizer met within
``margin`` of a rounding tie (``ties/{key}``) and its scale
(``scale/{key}``) in the first step.

A task with ``"serve": {"fsdp", "max_new", "s_max"}`` serves instead
(:func:`_serve_task`): the smoke model of ``arch`` (``cfg`` overrides,
a dict for a nested config) on the mesh from ``api.init(0)``, each rank its
slices of the single-device weights, greedy from the prompts of
``inputs``.  It writes the rank's ``logits/{i}`` (its rows of call ``i``'s
last-position logits), ``tokens`` (``ServeEngine.generate``'s, the whole
batch's), its cache after the prefill and after the last step
(``cache/{prefill,last}/{layer}/{j}``), its MoE layers' routing
(``routing/{i}``: the top-k experts of its tokens, ``kept/{i}``: the picks
each expert kept), whisper's ``cache/{prefill,last}/enc``, ``comm/prefill``
and ``comm/decode`` (the model axis's
calls and bytes of the prefill and of one decode step), ``profile``
(``comm_profile``'s values) and ``coords``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(job: dict, path: str, timeout: float = 300.0) -> None:
    """Write ``job`` to ``path`` and run its ``world`` ranks to the end;
    raises with the failing ranks' errors if any fails or times out."""
    with open(path, "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    wait_all([start([sys.executable, os.path.abspath(__file__), path, str(r)], env,
                    f"{path}.rank{r}.log") for r in range(job["world"])], timeout)


def write_inputs(d, arch, steps=1, batch=8, seq=16):
    """The smoke model's weights (the port's ``api.init(0)`` as JAX's flat
    leaves) and ``steps`` global batches, in ``{d}/{arch}.npz``."""
    from repro_torch.models import get_api, smoke_config
    from repro_torch.models.convert import params_to_jax
    from repro_torch.train.data import DataConfig, SyntheticData

    cfg = smoke_config(arch)
    model = get_api(cfg, device="cpu").init(0)
    data = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=batch, seq=seq),
                         model_cfg=cfg)
    arrays = {f"params/{k}": a for k, a in params_to_jax(model.state_dict(), cfg).items()}
    for i in range(steps):
        arrays.update({f"batches/{i}/{k}": v for k, v in data.batch_at(i).items()})
    path = os.path.join(d, f"{arch}.npz")
    np.savez(path, **arrays)
    return path


def jax_process(job: dict, path: str):
    """Start ``tests/jax_dist_reference.py`` on ``job``."""
    with open(path, "w") as f:
        json.dump(job, f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    return start([sys.executable, os.path.join(REPO, "tests", "jax_dist_reference.py"), path],
                 env, path + ".log")


def start(argv, env: dict, log: str):
    """A process of ``argv`` whose output goes to the file ``log``."""
    with open(log, "w") as f:
        proc = subprocess.Popen(argv, env=env, cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def wait_all(procs, timeout: float) -> None:
    """Wait for every process of :func:`start`; kill the rest as soon as one
    fails or the time runs out, then raise with the end of the output of
    those that did not exit 0."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [p for p in procs if p.returncode != 0]
    if bad:
        def tail(p):
            with open(p.log) as f:
                return f.read()[-4000:]
        raise RuntimeError("\n".join(f"{' '.join(p.args[1:3])} exited {p.returncode}:\n"
                                     f"{tail(p)}" for p in bad))


def _step_task(task: dict, rank: int, out: str) -> None:
    import torch

    from repro_torch.ckpt.manager import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_api, smoke_config
    from repro_torch.train import trainstep
    from repro_torch.train.optimizer import OptConfig

    cfg = smoke_config(task["arch"]).replace(**task.get("cfg", {}))
    shape, axes = task["mesh"]
    mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
    with np.load(task["batches"]) as f:
        batches = [{k.split("/")[2]: f[k] for k in f.files if k.startswith(f"batches/{i}/")}
                   for i in range(task["steps"])]
    hp = trainstep.TrainHparams(**task["hp"])
    api = get_api(cfg, device="cpu", mesh=mesh, fsdp=hp.fsdp)
    step = trainstep.make_train_step(api, cfg, OptConfig(**task["opt"]), mesh, hp, batches[0])
    state = step.init_state(seed=0)
    first = 0
    if task.get("restore"):
        first = restore_checkpoint(task["restore"], state, step=task.get("restore_step"),
                                   mesh_step=step) + 1
    else:
        with np.load(task["init"]) as f:
            flat = {k[len("params/"):]: f[k] for k in f.files if k.startswith("params/")}
        state["model"].load_state_dict(step.param_state(flat))

    ties, scales = [], []
    margin = task.get("ties")
    quantize = trainstep.quantize_int8
    if margin is not None:
        def recorded(gs, scale):
            x = (gs / scale * 127.0).abs()
            ties.append((x - torch.floor(x) - 0.5).abs() < margin)
            scales.append(scale.clone())
            return quantize(gs, scale)

        trainstep.quantize_int8 = recorded
    def dump(prefix=""):
        out = {}
        named = dict(state["model"].named_parameters())
        for key in step.leaves:
            p = step.param(named, key).detach()
            out[f"{prefix}local/{key}"] = np.asarray(p.shape)
            out[f"{prefix}params/{key}"] = step.whole_param(key, p).numpy().copy()
            for g in ("m", "v"):
                out[f"{prefix}{g}/{key}"] = state["opt"][g][key].numpy().copy()
                out[f"{prefix}full_{g}/{key}"] = step.gather(
                    key, state["opt"][g][key]).numpy().copy()
        return out

    res = {"loss": [], "grad_norm": [], "lr": []}
    kept = {}
    try:
        for i in range(first, task["steps"]):
            metrics = step(state, trainstep.batch_to_torch(batches[i], "cpu"))
            for k in res:
                res[k].append(metrics[k].item())
            if i in task.get("ckpt", {}).get("after", ()):
                save_checkpoint(task["ckpt"]["dir"], i, state, mesh_step=step)
            if i in task.get("keep", ()):
                kept.update(dump(f"after{i}/"))
    finally:
        trainstep.quantize_int8 = quantize
    arrays = {k: np.asarray(v) for k, v in res.items()}
    arrays["coords"] = np.asarray([mesh.coords()[a] for a in axes])
    arrays["numel"] = np.asarray(sum(p.numel() for p in state["model"].parameters()))
    for axis, c in step.comm.items():
        arrays[f"comm/{axis}"] = np.asarray([c["calls"], c["bytes"]])
    arrays.update(dump(), **kept)
    arrays["step"] = state["opt"]["step"].numpy()
    keys = list(step.dims)
    for j, (mask, scale) in enumerate(zip(ties[:len(keys)], scales)):
        arrays[f"ties/{keys[j]}"] = mask.numpy()
        arrays[f"scale/{keys[j]}"] = scale.numpy()
    np.savez(os.path.join(out, f"{task['name']}.rank{rank}.npz"), **arrays)


def _serve_task(task: dict, rank: int, out: str) -> None:
    import dataclasses

    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_api, smoke_config
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine

    cfg = smoke_config(task["arch"])
    if task.get("cfg"):
        cfg = cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
                             else v for k, v in task["cfg"].items()})
    shape, axes = task["mesh"]
    sv = task["serve"]
    mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
    api = get_api(cfg, device="cpu", mesh=mesh, fsdp=sv["fsdp"])
    model = api.init(seed=0)
    with np.load(task["inputs"]) as f:
        inputs = {k: f[k] for k in f.files}
    B = inputs["tokens"].shape[0]
    eng = ServeEngine(api, model, batch=B, s_max=sv["s_max"], mesh=mesh)
    local = {k: torch.as_tensor(v) for k, v in eng.local_inputs(inputs).items()}

    arrays, seen = {}, {"routing": [], "kept": []}
    route = moe.route

    def recorded(mod, xt, c, capacity=None, rows_dp=None):
        r = route(mod, xt, c, capacity, rows_dp)
        seen["routing"].append(r.expert_idx.numpy().copy())
        seen["kept"].append((r.dispatch != xt.shape[0]).sum(1).numpy())
        return r

    def dump(tag, cache):
        for i, entry in enumerate(cache["layers"]):
            for j, t in enumerate(entry):
                arrays[f"cache/{tag}/{i}/{j}"] = t.float().numpy().copy()
        if "enc" in cache:  # whisper's encoder output
            arrays[f"cache/{tag}/enc"] = cache["enc"].float().numpy().copy()

    def comm():
        c = api.axis.comm.get("model", {}) if api.axis is not None else {}
        return np.asarray([c.get("calls", 0), c.get("bytes", 0)])

    moe.route = recorded
    try:
        with torch.inference_mode():
            cache = api.init_cache(B, sv["s_max"])
            logits, cache = api.prefill(model, local, cache, last_only=True)
            arrays["comm/prefill"] = comm()
            dump("prefill", cache)
            steps = [logits[:, -1]]
            for i in range(sv["max_new"] - 1):
                if api.axis is not None:
                    api.axis.comm = {}
                logits, cache = api.decode(model, steps[-1].argmax(-1)[:, None], cache)
                if i == 0:
                    arrays["comm/decode"] = comm()
                steps.append(logits[:, -1])
            dump("last", cache)
    finally:
        moe.route = route
    arrays.update({f"logits/{i}": t.numpy().copy() for i, t in enumerate(steps)})
    for what in ("routing", "kept"):
        arrays.update({f"{what}/{i}": a for i, a in enumerate(seen[what])})
    arrays["tokens"] = eng.generate(inputs, max_new_tokens=sv["max_new"])
    prof = eng.comm_profile()
    arrays["profile"] = np.asarray([prof[k] for k in sorted(prof)])
    arrays["coords"] = np.asarray([mesh.coords()[a] for a in axes])
    np.savez(os.path.join(out, f"{task['name']}.rank{rank}.npz"), **arrays)


def _contiguous_only(collective):
    """``collective`` refusing a strided tensor, as NCCL does (gloo takes
    one): the CPU ranks then catch what would fail on the cards."""
    def call(tensor, *args, **kwargs):
        if not tensor.is_contiguous():
            raise ValueError(f"{collective.__name__}: tensors must be contiguous (NCCL)")
        return collective(tensor, *args, **kwargs)
    return call


def main(path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, shutdown

    dist.all_reduce, dist.broadcast = (_contiguous_only(f) for f in (dist.all_reduce,
                                                                      dist.broadcast))
    torch.set_num_threads(1)
    with open(path) as f:
        job = json.load(f)
    init_world("cpu", init_method=f"file://{job['store']}", world_size=job["world"], rank=rank)
    try:
        for task in job["tasks"]:
            (_serve_task if "serve" in task else _step_task)(task, rank, job["out"])
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
