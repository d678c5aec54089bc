"""Ranks of the port's distributed train steps for the CPU tests (gloo).

    python tests/torch_dist_ranks.py JOB.json RANK

runs the tasks of ``JOB.json`` as rank RANK of ``job["world"]``, joined
through ``file://job["store"]``, and writes ``{out}/{task}.rank{RANK}.npz``
for each task.  It imports no JAX (the JAX references run in
``tests/jax_dist_reference.py``).  :func:`run_ranks` starts the ranks from a
test and brings every one down if any fails or the time runs out.

A task ``{"name", "arch", "mesh": [shape, axes], "hp", "opt", "init",
"batches", "steps"}``, with optional ``"ties": margin``, ``"ckpt": {"dir",
"after": [steps]}``, ``"restore": dir`` and ``"restore_step"``, builds
``make_train_step`` on the mesh for the smoke config of ``arch``, loads the
weights of ``init`` (an ``.npz`` of JAX's flat ``params/...`` leaves) or
restores the checkpoint ``restore`` (its latest, or ``restore_step``), and
takes the steps after the restored one (or from 0) up to ``steps`` on the
global batches ``batches/{i}/...`` of the ``.npz``, saving a checkpoint
after each step of ``ckpt["after"]``.  It writes ``loss``, ``grad_norm``
and ``lr`` per step, ``coords``, the state after the last step as this rank
holds it (``params/{key}`` whole, ``m/{key}`` and ``v/{key}`` the rank's
slices, ``step``), the moments gathered whole (``full_m/{key}``,
``full_v/{key}``) and, with ``ties``, per leaf the entries of this rank's
shard that the int8 quantizer met within ``margin`` of a rounding tie
(``ties/{key}``) and its scale (``scale/{key}``) in the first step.
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
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train import trainstep
    from repro_torch.train.optimizer import OptConfig

    cfg = smoke_config(task["arch"]).replace(**task.get("cfg", {}))
    shape, axes = task["mesh"]
    mesh = make_mesh(tuple(shape), tuple(axes), device="cpu")
    with np.load(task["batches"]) as f:
        batches = [{k.split("/")[2]: f[k] for k in f.files if k.startswith(f"batches/{i}/")}
                   for i in range(task["steps"])]
    api = get_api(cfg, device="cpu")
    hp = trainstep.TrainHparams(**task["hp"])
    step = trainstep.make_train_step(api, cfg, OptConfig(**task["opt"]), mesh, hp, batches[0])
    state = step.init_state(seed=0)
    first = 0
    if task.get("restore"):
        first = restore_checkpoint(task["restore"], state, step=task.get("restore_step"),
                                   mesh_step=step) + 1
    else:
        with np.load(task["init"]) as f:
            flat = {k[len("params/"):]: f[k] for k in f.files if k.startswith("params/")}
        state["model"].load_state_dict(params_from_jax(flat, cfg))

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
    res = {"loss": [], "grad_norm": [], "lr": []}
    try:
        for i in range(first, task["steps"]):
            metrics = step(state, trainstep.batch_to_torch(batches[i], "cpu"))
            for k in res:
                res[k].append(metrics[k].item())
            if i in task.get("ckpt", {}).get("after", ()):
                save_checkpoint(task["ckpt"]["dir"], i, state, mesh_step=step)
    finally:
        trainstep.quantize_int8 = quantize
    arrays = {k: np.asarray(v) for k, v in res.items()}
    arrays["coords"] = np.asarray([mesh.coords()[a] for a in axes])
    named = dict(state["model"].named_parameters())
    for key, names in step.leaves.items():
        p = (torch.stack([named[n] for n in names]) if isinstance(names, tuple) else named[names])
        arrays[f"params/{key}"] = p.detach().numpy()
        for g in ("m", "v"):
            arrays[f"{g}/{key}"] = state["opt"][g][key].numpy()
            arrays[f"full_{g}/{key}"] = step.gather(key, state["opt"][g][key]).numpy()
    arrays["step"] = state["opt"]["step"].numpy()
    keys = list(step.dims)
    for j, (mask, scale) in enumerate(zip(ties[:len(keys)], scales)):
        arrays[f"ties/{keys[j]}"] = mask.numpy()
        arrays[f"scale/{keys[j]}"] = scale.numpy()
    np.savez(os.path.join(out, f"{task['name']}.rank{rank}.npz"), **arrays)


def main(path: str, rank: int) -> None:
    import torch

    from repro_torch.launch.mesh import init_world, shutdown

    torch.set_num_threads(1)
    with open(path) as f:
        job = json.load(f)
    init_world("cpu", init_method=f"file://{job['store']}", world_size=job["world"], rank=rank)
    try:
        for task in job["tasks"]:
            _step_task(task, rank, job["out"])
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
