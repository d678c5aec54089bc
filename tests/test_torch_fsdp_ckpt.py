"""Checkpoints of the port's ZeRO-3 (``fsdp``) step, across meshes, into the
single-device step and from JAX, and the train command line's ``--fsdp``
under ``torch.distributed.run``, on the CPU (gloo).

* The port at (pod, data, model) = (1, 4, 1) with ``fsdp`` takes 4 flat
  steps of gemma2-9b's smoke config and saves after steps 1 and 3 (the
  blocks of the parameters and the moments gathered whole).  Step 1
  restores at (2, 2, 1) with ``fsdp``, at (1, 1, 4) without it (tensor
  parallel, ZeRO-1) and into ``train_step`` on one device: every rank's
  blocks or slices, and the single-device state, equal the file's bit for
  bit.  The steps after it: at (2, 2, 1), whose DP group and blocks are
  those of (1, 4, 1), bit for bit equal to the uninterrupted run; at
  (1, 1, 4) and on one device, whose sums run in another order, within
  ``rel=1e-4`` (losses) and ``atol=3e-5`` (parameters).
* JAX's flat step with ``fsdp`` at (1, 4, 1) writes a checkpoint
  (``tests/jax_dist_reference.py``); the port restores it at (1, 4, 1)
  with ``fsdp``: its blocks of the parameters and the moments and the step
  equal the file's bit for bit.
* ``--fsdp`` under ``python -m torch.distributed.run --nproc-per-node 4``
  prints one ``[control-plane]`` line and rank 0's step lines; a rerun on
  2 ranks without ``--fsdp`` resumes from its checkpoint.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.ckpt.manager import restore_checkpoint  # noqa: E402
from repro_torch.dist.sharding import dp_index  # noqa: E402
from repro_torch.models import get_api, smoke_config  # noqa: E402
from repro_torch.models.convert import params_to_jax  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainstep import (TrainHparams, batch_to_torch,  # noqa: E402
                                         make_train_state, train_step)
from tests.test_torch_dist import OPT  # noqa: E402
from tests.test_torch_fsdp import AXES, GEMMA2, M141, M221, _index  # noqa: E402
from tests.test_torch_tp_ckpt import _free_port  # noqa: E402
from tests.torch_dist_ranks import REPO, jax_process, run_ranks, wait_all, write_inputs  # noqa: E402

FSDP = dict(fsdp=True)
M114 = [(1, 1, 4), AXES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    inputs = write_inputs(d, GEMMA2, steps=4)
    jdir, pdir = os.path.join(d, "jax_ckpt"), os.path.join(d, "port_ckpt")
    task = dict(arch=GEMMA2, opt=OPT, init=inputs, batches=inputs)
    proc = jax_process({"devices": 4, "out": d, "cases": [dict(
        task, name="jax", mesh=M141, hp=FSDP, steps=1, ckpt=jdir)]}, os.path.join(d, "jax.json"))
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store1"), "out": d, "tasks": [
            dict(task, name="w141", mesh=M141, hp=FSDP, steps=4,
                 ckpt={"dir": pdir, "after": [1, 3]}),
            # steps=2 after the restored step 1: the restored state itself
            dict(task, name="w221-restored", mesh=M221, hp=FSDP, steps=2, restore=pdir,
                 restore_step=1),
            dict(task, name="w114-restored", mesh=M114, hp=dict(zero1=True), steps=2,
                 restore=pdir, restore_step=1),
            dict(task, name="w221-resume", mesh=M221, hp=FSDP, steps=4, restore=pdir,
                 restore_step=1),
            dict(task, name="w114-resume", mesh=M114, hp=dict(zero1=True), steps=4,
                 restore=pdir, restore_step=1)]},
            os.path.join(d, "job1.json"))
    finally:
        wait_all([proc], 300)
    run_ranks({"world": 4, "store": os.path.join(d, "store2"), "out": d, "tasks": [
        dict(task, name="w141-jax", mesh=M141, hp=FSDP, steps=1, restore=jdir)]},
        os.path.join(d, "job2.json"))
    return {"dir": d, "jax": jdir, "port": pdir, "inputs": inputs}


def _load(runs, name):
    return [np.load(os.path.join(runs["dir"], f"{name}.rank{r}.npz")) for r in range(4)]


def restored_equals_file(ranks, path, mesh_shape, fsdp, arch=GEMMA2):
    """Every rank's restored state equals the checkpoint at ``path``: the
    parameters and moments whole, and under ``fsdp`` the rank's blocks."""
    with np.load(path) as f:
        keys = [k[len("params/"):] for k in f.files if k.startswith("params/")]
        assert keys and keys == [k[len("params/"):] for k in ranks[0].files
                                 if k.startswith("params/")]
        for res in ranks:
            assert int(res["step"]) == int(f["opt/step"])
            pod_i, data_i, _ = res["coords"]
            block = dp_index(pod_i, data_i, mesh_shape[1])
            for key in keys:
                whole = f[f"params/{key}"]
                np.testing.assert_array_equal(res[f"params/{key}"], whole)
                if fsdp:
                    index = _index(key, whole.shape, res["coords"], mesh_shape, arch, block)
                    assert tuple(res[f"local/{key}"]) == whole[index].shape, key
                for g in ("m", "v"):
                    np.testing.assert_array_equal(res[f"full_{g}/{key}"], f[f"opt/{g}/{key}"])
                    if fsdp:
                        np.testing.assert_array_equal(res[f"{g}/{key}"],
                                                      f[f"opt/{g}/{key}"][index])


def test_fsdp_checkpoint_restores_across_meshes(runs):
    path = os.path.join(runs["port"], "step_1.npz")
    restored_equals_file(_load(runs, "w221-restored"), path, M221[0], fsdp=True)
    restored_equals_file(_load(runs, "w114-restored"), path, M114[0], fsdp=False)
    # and the restored run goes on: at (2, 2, 1) as the uninterrupted one
    w141, w221 = _load(runs, "w141")[0], _load(runs, "w221-resume")
    w114 = _load(runs, "w114-resume")
    assert len(w141["loss"]) == 4 and len(w221[0]["loss"]) == len(w114[0]["loss"]) == 2
    np.testing.assert_array_equal(w221[0]["loss"], w141["loss"][2:])
    np.testing.assert_array_equal(w221[0]["grad_norm"], w141["grad_norm"][2:])
    np.testing.assert_allclose(w114[0]["loss"], w141["loss"][2:], rtol=1e-4)
    for key in (k for k in w141.files if k.startswith("params/") or k.startswith("full_")):
        np.testing.assert_array_equal(w221[0][key], w141[key], err_msg=key)
        if key.startswith("params/"):
            np.testing.assert_allclose(w114[0][key], w141[key], atol=3e-5, rtol=0, err_msg=key)


def test_fsdp_checkpoint_restores_into_train_step(runs):
    cfg = smoke_config(GEMMA2)
    state = make_train_state(get_api(cfg, device="cpu"), seed=1)
    assert restore_checkpoint(runs["port"], state, step=1) == 1
    with np.load(os.path.join(runs["port"], "step_1.npz")) as f:
        for key, a in params_to_jax(dict(state["model"].named_parameters()), cfg).items():
            np.testing.assert_array_equal(a, f[f"params/{key}"], err_msg=key)
        for g in ("m", "v"):
            for key, a in params_to_jax(state["opt"][g], cfg).items():
                np.testing.assert_array_equal(a, f[f"opt/{g}/{key}"], err_msg=key)
    with np.load(runs["inputs"]) as f:
        losses = []
        for i in (2, 3):
            batch = {k.split("/")[2]: f[k] for k in f.files if k.startswith(f"batches/{i}/")}
            metrics = train_step(state["model"], state["opt"], batch_to_torch(batch, "cpu"),
                                 OptConfig(**OPT), TrainHparams())
            losses.append(metrics["loss"].item())
    w141 = _load(runs, "w141")[0]
    np.testing.assert_allclose(losses, w141["loss"][2:], rtol=1e-4)
    for key, a in params_to_jax(dict(state["model"].named_parameters()), cfg).items():
        np.testing.assert_allclose(a, w141[f"params/{key}"], atol=3e-5, rtol=0, err_msg=key)


def test_jax_fsdp_checkpoint_restores_in_the_port(runs):
    restored_equals_file(_load(runs, "w141-jax"), os.path.join(runs["jax"], "step_0.npz"),
                          M141[0], fsdp=True)


def test_train_cli_fsdp_under_torchrun_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")

    def cli(ranks, steps, *flags):
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--master-port", str(_free_port()),
             "--nproc-per-node", str(ranks), "-m", "repro_torch.launch.train", "--arch",
             GEMMA2, "--smoke", "--device", "cpu", *flags, "--steps", str(steps),
             "--log-every", "1", "--ckpt-dir", ckpt],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
        assert res.returncode == 0, res.stderr[-4000:]
        return res.stdout.strip().splitlines()

    def check(lines, first, steps):
        assert re.fullmatch(r"\[control-plane\] arch=gemma2-9b pods=\(0, 1\) .* LTRR=1\.000 "
                            r"mdmcf=\d+\.\d ms", lines[0]), lines
        step_lines = lines[1 + (first > 0):-1]
        assert [int(re.fullmatch(r"step +(\d+)  loss (\d+\.\d+)  lr (\S+)  ([\d,]+) tok/s",
                                 line).group(1)) for line in step_lines] == list(range(first,
                                                                                       steps))
        assert lines[-1] == f"[ckpt] final at step {steps - 1}"

    lines = cli(4, 2, "--fsdp")
    assert len(lines) == 4, lines  # ranks 1-3 print nothing
    check(lines, 0, 2)
    lines = cli(2, 3)
    assert len(lines) == 4 and lines[1] == "[resume] from step 1", lines
    check(lines, 2, 3)
