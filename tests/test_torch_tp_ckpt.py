"""Checkpoints of the port's distributed steps at a ``model`` axis above 1,
across meshes and into JAX, and the train command line's ``--model`` under
``torch.distributed.run``, on the CPU (gloo).

* JAX's hierarchical step (ZeRO-1) at (pod, data, model) = (1, 2, 2) on a
  forced 4-device mesh writes a checkpoint (``tests/jax_dist_reference.py``);
  the port at (1, 1, 4) restores it: every rank's parameter slices, its
  slices of the moments and the step equal the file's bit for bit.
* The port at (1, 1, 4) takes 4 hierarchical steps with ZeRO-1 and saves
  after steps 1 and 3 (the parameters and moments gathered over ``model``
  and ``data``); JAX's ``restore_checkpoint`` reads step 3 on one device
  bit for bit equal to the port's state gathered whole.
* The port at (1, 2, 2) resumes from step 1 and takes steps 2 and 3: its
  losses equal the uninterrupted (1, 1, 4) run's within ``rel=1e-4``, its
  parameters within ``atol=3e-5``.
* The train CLI under ``python -m torch.distributed.run --nproc-per-node 4``
  with ``--model 2 --hierarchical --zero1`` prints one ``[control-plane]``
  line and rank 0's step lines; a rerun at ``--model 4`` resumes.
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
from tests.test_torch_dist import OPT  # noqa: E402
from tests.test_torch_tp import AXES, QWEN, _index  # noqa: E402
from tests.torch_dist_ranks import REPO, jax_process, run_ranks, wait_all, write_inputs  # noqa: E402

HIER = dict(hierarchical=True, zero1=True)
M114, M122 = [(1, 1, 4), AXES], [(1, 2, 2), AXES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp_ckpt"))
    inputs = write_inputs(d, QWEN, steps=4)
    jdir, pdir = os.path.join(d, "jax_ckpt"), os.path.join(d, "port_ckpt")
    task = dict(arch=QWEN, opt=OPT, init=inputs, batches=inputs, hp=HIER)
    proc = jax_process({"devices": 4, "out": d, "cases": [dict(
        task, name="jax", mesh=M122, steps=1, ckpt=jdir)]}, os.path.join(d, "jax.json"))
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store1"), "out": d, "tasks": [
            dict(task, name="w114", mesh=M114, steps=4, ckpt={"dir": pdir, "after": [1, 3]}),
            dict(task, name="w122-resume", mesh=M122, steps=4, restore=pdir, restore_step=1)]},
            os.path.join(d, "job1.json"))
    finally:
        wait_all([proc], 300)
    run_ranks({"world": 4, "store": os.path.join(d, "store2"), "out": d, "tasks": [
        dict(task, name="w114-jax", mesh=M114, steps=1, restore=jdir)]},
        os.path.join(d, "job2.json"))
    return {"dir": d, "jax": jdir, "port": pdir}


def _load(runs, name):
    return [np.load(os.path.join(runs["dir"], f"{name}.rank{r}.npz")) for r in range(4)]


def test_jax_checkpoint_restores_at_model_4(runs):
    ranks = _load(runs, "w114-jax")
    with np.load(os.path.join(runs["jax"], "step_0.npz")) as f:
        keys = [k[len("params/"):] for k in f.files if k.startswith("params/")]
        assert keys and keys == [k[len("params/"):] for k in ranks[0].files
                                 if k.startswith("params/")]
        cut = 0
        for res in ranks:
            assert int(res["step"]) == int(f["opt/step"]) == 1
            for key in keys:
                whole = f[f"params/{key}"]
                np.testing.assert_array_equal(res[f"params/{key}"], whole)
                index = _index(key, whole.shape, (tuple(res["coords"]), M114[0]), QWEN, True)
                assert tuple(res[f"local/{key}"]) == whole[index].shape, key
                for g in ("m", "v"):
                    mine = res[f"{g}/{key}"]
                    cut += mine.shape != whole.shape
                    np.testing.assert_array_equal(mine, f[f"opt/{g}/{key}"][index],
                                                  err_msg=f"{g}/{key}")
        assert cut > len(keys)  # most leaves are cut over model at 4


def test_port_checkpoint_at_model_4_reads_in_jax(runs):
    jcfg = jsmoke(QWEN)
    like = jax.eval_shape(lambda k: jtrainstep.make_train_state(jget_api(jcfg), k),
                          jax.random.PRNGKey(0))
    state = jrestore(runs["port"], like, step=3)
    rank0 = _load(runs, "w114")[0]
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
    assert int(flat.pop("opt/step")) == int(rank0["step"]) == 4
    assert len(flat) == 3 * len([k for k in rank0.files if k.startswith("params/")])
    for key, leaf in flat.items():
        group, name = key.split("/", 1) if key.startswith("params/") else key[4:].split("/", 1)
        want = rank0[f"params/{name}"] if group == "params" else rank0[f"full_{group}/{name}"]
        assert leaf.dtype == want.dtype, key
        np.testing.assert_array_equal(leaf, want, err_msg=key)


def test_resumed_at_122_equals_uninterrupted_114(runs):
    w114, w122 = _load(runs, "w114")[0], _load(runs, "w122-resume")
    assert len(w114["loss"]) == 4 and len(w122[0]["loss"]) == 2
    np.testing.assert_allclose(w122[0]["loss"], w114["loss"][2:], rtol=1e-4)
    for res in w122[1:]:
        np.testing.assert_array_equal(res["loss"], w122[0]["loss"])
    for key in (k for k in w114.files if k.startswith("params/")):
        np.testing.assert_allclose(w122[0][key], w114[key], atol=3e-5, rtol=0, err_msg=key)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_model_axis_under_torchrun_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")

    def cli(model, steps, *flags):
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--master-port", str(_free_port()),
             "--nproc-per-node", "4", "-m", "repro_torch.launch.train", "--arch", QWEN,
             "--smoke", "--device", "cpu", "--model", str(model), *flags,
             "--steps", str(steps), "--log-every", "1", "--ckpt-dir", ckpt],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
        assert res.returncode == 0, res.stderr[-4000:]
        return res.stdout.strip().splitlines()

    def check(lines, first, steps):
        assert re.fullmatch(r"\[control-plane\] arch=qwen2\.5-14b pods=\(0, 1\) .* LTRR=1\.000 "
                            r"mdmcf=\d+\.\d ms", lines[0]), lines
        step_lines = lines[1 + (first > 0):-1]
        assert [int(re.fullmatch(r"step +(\d+)  loss (\d+\.\d+)  lr (\S+)  ([\d,]+) tok/s",
                                 line).group(1)) for line in step_lines] == list(range(first,
                                                                                       steps))
        assert lines[-1] == f"[ckpt] final at step {steps - 1}"

    lines = cli(2, 2, "--hierarchical", "--zero1")
    assert len(lines) == 4, lines  # ranks 1-3 print nothing
    check(lines, 0, 2)
    lines = cli(4, 3)
    assert len(lines) == 4 and lines[1] == "[resume] from step 1", lines
    check(lines, 2, 3)
