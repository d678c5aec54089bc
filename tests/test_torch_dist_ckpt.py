"""Checkpoints of the port's distributed steps across world sizes, and the
train command line under ``torch.distributed.run``, on the CPU (gloo).

* JAX's hierarchical step (ZeRO-1, ``compress``) on a forced 4-device mesh
  (2, 2, 1) writes a checkpoint (``tests/jax_dist_reference.py``); the port
  at world 2, mesh (data 2, model 1), restores it: every rank's parameters,
  its slices of the moments and the step equal the file's bit for bit.
* The port at world 4, mesh (data 4, model 1), takes 4 hierarchical steps
  with ZeRO-1 and saves after steps 1 and 3; JAX's ``restore_checkpoint``
  reads step 3 on one device bit for bit equal to the port's state, the
  moments gathered whole.
* The port at world 2 resumes from step 1 and takes steps 2 and 3: its
  losses equal the uninterrupted world-4 run's within ``rel=1e-4``, its
  parameters within ``atol=3e-5``.
* The train CLI under ``python -m torch.distributed.run --nproc-per-node 2``
  with ``--hierarchical --zero1 --compress`` prints one ``[control-plane]``
  line and rank 0's step lines; a rerun with ``--ckpt-dir`` resumes.
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.ckpt.manager import restore_checkpoint as jrestore  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from tests.test_torch_dist import OPT, _block  # noqa: E402
from tests.torch_dist_ranks import REPO, jax_process, run_ranks, wait_all, write_inputs  # noqa: E402

ARCH = "olmo-1b"
HIER = dict(hierarchical=True, zero1=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_ckpt"))
    inputs = write_inputs(d, ARCH, steps=4)
    jdir, pdir = os.path.join(d, "jax_ckpt"), os.path.join(d, "port_ckpt")
    task = dict(arch=ARCH, opt=OPT, init=inputs, batches=inputs)
    jax_job = {"devices": 4, "out": d, "cases": [dict(
        task, name="jax", mesh=[(2, 2, 1), ("pod", "data", "model")],
        hp=dict(HIER, compress=True), steps=1, ckpt=jdir)]}
    proc = jax_process(jax_job, os.path.join(d, "jax.json"))
    data4, data2 = [(4, 1), ("data", "model")], [(2, 1), ("data", "model")]
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store4"), "out": d, "tasks": [dict(
            task, name="w4", mesh=data4, hp=HIER, steps=4, ckpt={"dir": pdir, "after": [1, 3]})]},
            os.path.join(d, "w4.json"))
    finally:
        wait_all([proc], 300)
    run_ranks({"world": 2, "store": os.path.join(d, "store2"), "out": d, "tasks": [
        dict(task, name="w2-jax", mesh=data2, hp=dict(HIER, compress=True), steps=1,
             restore=jdir),
        dict(task, name="w2-resume", mesh=data2, hp=HIER, steps=4, restore=pdir,
             restore_step=1)]}, os.path.join(d, "w2.json"))
    return {"dir": d, "jax": jdir, "port": pdir}


def _load(runs, name, world):
    return [np.load(os.path.join(runs["dir"], f"{name}.rank{r}.npz")) for r in range(world)]


def test_jax_checkpoint_restores_at_world_2(runs):
    ranks = _load(runs, "w2-jax", 2)
    with np.load(os.path.join(runs["jax"], "step_0.npz")) as f:
        keys = [k[len("params/"):] for k in f.files if k.startswith("params/")]
        assert keys and keys == [k[len("params/"):] for k in ranks[0].files
                                 if k.startswith("params/")]
        cut = 0
        for r, res in enumerate(ranks):
            assert int(res["step"]) == int(f["opt/step"]) == 1
            for key in keys:
                np.testing.assert_array_equal(res[f"params/{key}"], f[f"params/{key}"])
                for g in ("m", "v"):
                    whole, mine = f[f"opt/{g}/{key}"], res[f"{g}/{key}"]
                    cut += mine.shape != whole.shape
                    np.testing.assert_array_equal(mine, whole[_block(mine.shape, whole.shape, r)],
                                                  err_msg=f"{g}/{key}")
        assert cut == 2 * 2 * len(keys)  # at data 2 every leaf of the smoke model is cut


def test_port_checkpoint_at_world_4_reads_in_jax(runs):
    jcfg = jsmoke(ARCH)
    like = jax.eval_shape(lambda k: jtrainstep.make_train_state(jget_api(jcfg), k),
                          jax.random.PRNGKey(0))
    state = jrestore(runs["port"], like, step=3)
    rank0 = _load(runs, "w4", 4)[0]
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
    assert int(flat.pop("opt/step")) == int(rank0["step"]) == 4
    assert len(flat) == 3 * len([k for k in rank0.files if k.startswith("params/")])
    for key, leaf in flat.items():
        group, name = key.split("/", 1) if key.startswith("params/") else key[4:].split("/", 1)
        want = rank0[f"params/{name}"] if group == "params" else rank0[f"full_{group}/{name}"]
        assert leaf.dtype == want.dtype, key
        np.testing.assert_array_equal(leaf, want, err_msg=key)


def test_resumed_world_2_equals_uninterrupted_world_4(runs):
    w4, w2 = _load(runs, "w4", 4)[0], _load(runs, "w2-resume", 2)
    assert len(w4["loss"]) == 4 and len(w2[0]["loss"]) == 2
    np.testing.assert_allclose(w2[0]["loss"], w4["loss"][2:], rtol=1e-4)
    np.testing.assert_array_equal(w2[1]["loss"], w2[0]["loss"])
    for key in (k for k in w4.files if k.startswith("params/")):
        np.testing.assert_allclose(w2[0][key], w4[key], atol=3e-5, rtol=0, err_msg=key)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_under_torchrun_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def cli(steps):
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--master-port", str(_free_port()),
             "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch", ARCH,
             "--smoke", "--device", "cpu", "--hierarchical", "--zero1", "--compress",
             "--steps", str(steps), "--log-every", "1", "--ckpt-dir", ckpt],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
        assert res.returncode == 0, res.stderr[-4000:]
        return res.stdout.strip().splitlines()

    def check(lines, first, steps):
        assert re.fullmatch(r"\[control-plane\] arch=olmo-1b pods=\(0, 1\) .* LTRR=1\.000 "
                            r"mdmcf=\d+\.\d ms", lines[0]), lines
        step_lines = lines[1 + (first > 0):-1]
        assert [int(re.fullmatch(r"step +(\d+)  loss (\d+\.\d+)  lr (\S+)  ([\d,]+) tok/s",
                                 line).group(1)) for line in step_lines] == list(range(first,
                                                                                       steps))
        assert lines[-1] == f"[ckpt] final at step {steps - 1}"

    lines = cli(4)
    assert len(lines) == 6, lines  # rank 1 prints nothing
    check(lines, 0, 4)
    lines = cli(6)
    assert len(lines) == 5 and lines[1] == "[resume] from step 3", lines
    check(lines, 4, 6)
