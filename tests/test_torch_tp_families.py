"""The port's distributed train steps of rwkv6, jamba, whisper and internvl2
at a ``model`` axis above 1 against JAX's, on the CPU.

* One step of the flat step at (pod, data, model) = (1, 1, 4) and (1, 2, 2)
  and of the hierarchical step at (1, 2, 2), with ZeRO-1, on 4 gloo ranks
  (``tests/torch_dist_ranks.py``) against JAX's ``make_train_step`` on a
  forced 4-device host mesh (``tests/jax_dist_reference.py``), from the
  same weights and the same global batch (whisper's frames and internvl2's
  patches too), at the bounds of ``tests/test_torch_tp.py``
  (``check_step``).  JAX's hierarchical step fails at (1, 1, 4) (ROADMAP
  C.8).  rwkv6's time mix runs head-parallel with its token shift and
  decay LoRA gathered and its channel mix's receptance reduce-scattered;
  whisper's attentions, cross-attentions and MLPs are head- and
  column/row-parallel, its ``tok`` and ``pos`` looked up in pieces;
  internvl2's projector is a Megatron pair and its LM falls back to
  gathered attention weights where the axis does not divide its heads.
  jamba (its Mamba mixers channel-parallel, the selective scan's plain
  backward on the rank's channels, its GQA layer and experts over the
  axis) takes the flat step at (1, 1, 4) and the hierarchical at (1, 2, 2),
  both routing as JAX's step at that mesh does.
* Each rank holds exactly its ``param_pspec`` slices (``check_slices``).
* The step's ``comm`` counts the model axis's traffic, the hierarchical
  step's the ``pod`` axis's too.
* jamba's serving at ``model`` > 1 is in
  ``tests/test_torch_serve_mesh_tp_families.py``.
* The train CLI under ``torch.distributed.run`` with ``--model 2`` trains
  rwkv6 through the hierarchical step.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.test_torch_tp import check_slices, check_step, run_steps  # noqa: E402
from tests.torch_dist_ranks import REPO  # noqa: E402

AXES = ("pod", "data", "model")
M114, M122 = [(1, 1, 4), AXES], [(1, 2, 2), AXES]
ARCHS = {"rwkv": "rwkv6-1.6b", "whisper": "whisper-small", "internvl2": "internvl2-1b"}
JAMBA = "jamba-1.5-large-398b"
# name -> (arch, mesh, hierarchical, compress, grad_accum), as tests/test_torch_tp.py's
CASES = {f"{short}-{kind}-{''.join(map(str, m[0]))}": (arch, m, kind == "hier", False, 1)
         for short, arch in ARCHS.items()
         for kind, m in (("flat", M114), ("flat", M122), ("hier", M122))}
# jamba: the flat step at data 1, where the port's per-rank routing is JAX's
# global routing, and the hierarchical step, which routes each rank's tokens
# apart in both
CASES.update({"jamba-flat-114": (JAMBA, M114, False, False, 1),
              "jamba-hier-122": (JAMBA, M122, True, False, 1)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_steps(str(tmp_path_factory.mktemp("tp_families")), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax(runs, name):
    check_step(runs, name, CASES[name])


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("-flat-114")])
def test_rank_holds_its_pspec_slices(runs, name):
    check_slices(runs, name, CASES[name])


def test_comm_counts_the_model_axis(runs):
    for name, (_, _, hier, *_) in CASES.items():
        res = np.load(os.path.join(runs, f"{name}.rank0.npz"))
        calls, nbytes = res["comm/model"]
        assert calls > 0 and nbytes > 0, name
        assert ("comm/pod" in res.files) == hier, name


def test_train_cli_model_axis_under_torchrun():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
         "--model", "2", "--hierarchical", "--zero1", "--steps", "3", "--log-every", "1"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\d+\.\d+)", res.stdout, re.M)]
    assert len(losses) == 3 and all(np.isfinite(losses)), res.stdout[-2000:]
    assert "[control-plane]" in res.stdout
