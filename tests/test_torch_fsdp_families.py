"""The port's ZeRO-3 (``fsdp``) train steps of rwkv6, jamba, whisper and
internvl2 against JAX's, on the CPU.

* Two steps with ``fsdp`` on 4 gloo ranks (``tests/torch_dist_ranks.py``)
  against JAX's ``make_train_step`` with ``TrainHparams(fsdp=True)`` on a
  forced 4-device host mesh (``tests/jax_dist_reference.py``), from the
  same weights and global batches (whisper's frames and internvl2's
  patches too), at the bounds of ``tests/test_torch_fsdp.py``
  (``check_fsdp_step``: the first step at the bounds of
  ``tests/test_torch_tp.py``, the parameters after the second within
  ``AFTER_SECOND``, each rank's moment blocks against JAX's shards): the
  flat step of each family's smoke config at (pod, data, model) =
  (1, 4, 1) and (1, 2, 2), and rwkv6's hierarchical step at (1, 2, 2).
  jamba's flat step is held against JAX's hierarchical step, which routes
  each rank's tokens apart as the port does (JAX's flat step routes the
  global batch as one under GSPMD).  rwkv6's fp32 ``w0`` and ``u`` and
  jamba's ``A_log``, ``D`` and router are gathered and reduced in fp32;
  the Mamba mixers run the selective scan's plain forward and backward
  (the CPU's versions of the kernels).
* A rank holds only its blocks (``check_blocks``), and the step's ``comm``
  counts ZeRO-3's collectives with the bytes the leaves imply
  (``check_comm``: whisper's ``tok`` and the VLM's ``lm/embed/tok`` are
  gathered twice a pass, for the embedding and the loss).
* A checkpoint of jamba's FSDP state saved at (1, 4, 1) restores at
  (1, 2, 2): every rank's blocks of the parameters and the moments equal
  the file's bit for bit.
* The train command line's ``--fsdp`` trains whisper under
  ``torch.distributed.run``.
* Every one of the ten archs builds a rank's blocks of the single-device
  weights (``get_api(cfg, mesh=, fsdp=True)``'s ``init``).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.test_torch_dist import OPT  # noqa: E402
from tests.test_torch_fsdp import (M122, M141, STEPS, _hp, check_blocks,  # noqa: E402
                                   check_comm, check_fsdp_step)
from tests.test_torch_fsdp_ckpt import restored_equals_file  # noqa: E402
from tests.torch_dist_ranks import REPO, jax_process, run_ranks, wait_all, write_inputs  # noqa: E402

RWKV, JAMBA, WHISPER, VLM = ("rwkv6-1.6b", "jamba-1.5-large-398b", "whisper-small",
                             "internvl2-1b")
ARCHS = {"rwkv": RWKV, "jamba": JAMBA, "whisper": WHISPER, "internvl2": VLM}
# JAX cases: name -> (arch, mesh, hierarchical, grad_accum)
JAX_CASES = {f"{short}-{'hier' if short == 'jamba' else 'flat'}-{''.join(map(str, m[0]))}":
             (arch, m, short == "jamba", 1)
             for short, arch in ARCHS.items() for m in (M141, M122)}
JAX_CASES["rwkv-hier-122"] = (RWKV, M122, True, 1)
# the port's cases: name -> (arch, mesh, hierarchical, grad_accum, JAX case)
CASES = {n.replace("jamba-hier", "jamba-flat"): (a, m, False if a == JAMBA else h, ga, n)
         for n, (a, m, h, ga) in JAX_CASES.items()}
CKPT_CASE = "jamba-flat-141"  # saves after step 1; restored at (1, 2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fsdp_families"))
    inputs = {a: write_inputs(d, a, steps=STEPS) for a in ARCHS.values()}
    cases = [dict(name=n, arch=a, mesh=m, hp=_hp(h, ga), opt=OPT, init=inputs[a],
                  batches=inputs[a], steps=STEPS, keep=[0])
             for n, (a, m, h, ga) in JAX_CASES.items()]
    procs = [jax_process({"devices": 4, "out": d, "cases": cases[i::2]},
                         os.path.join(d, f"jax{i}.json")) for i in range(2)]
    ckpt = os.path.join(d, "ckpt")
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store"), "out": d, "tasks": [
            dict(name=n, arch=a, mesh=m, hp=_hp(h, ga), opt=OPT, init=inputs[a],
                 batches=inputs[a], steps=STEPS, keep=[0],
                 **({"ckpt": {"dir": ckpt, "after": [STEPS - 1]}} if n == CKPT_CASE else {}))
            for n, (a, m, h, ga, _) in CASES.items()]}, os.path.join(d, "ranks.json"),
            timeout=600)
        # steps=STEPS after the restored last step: the restored state itself
        run_ranks({"world": 4, "store": os.path.join(d, "store2"), "out": d, "tasks": [
            dict(name="jamba-restored-122", arch=JAMBA, mesh=M122, hp=_hp(False, 1), opt=OPT,
                 init=inputs[JAMBA], batches=inputs[JAMBA], steps=STEPS, restore=ckpt)]},
            os.path.join(d, "restore.json"))
    finally:
        wait_all(procs, 600)
    return d


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_step_matches_jax(runs, name):
    check_fsdp_step(runs, name, CASES[name])


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("-flat-141")])
def test_rank_holds_only_its_blocks(runs, name):
    check_blocks(runs, name, CASES[name])


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("-flat-141")])
def test_comm_counts_fsdp_collectives_under_the_dp_group(runs, name):
    check_comm(runs, name, CASES[name])


def test_jamba_checkpoint_restores_across_meshes(runs):
    ranks = [np.load(os.path.join(runs, f"jamba-restored-122.rank{r}.npz")) for r in range(4)]
    restored_equals_file(ranks, os.path.join(runs, "ckpt", f"step_{STEPS - 1}.npz"), M122[0],
                         fsdp=True, arch=JAMBA)
    saved = np.load(os.path.join(runs, f"{CKPT_CASE}.rank0.npz"))
    for key in (k for k in saved.files if k.startswith("params/")):
        np.testing.assert_array_equal(ranks[0][key], saved[key], err_msg=key)


def test_train_cli_fsdp_trains_whisper_under_torchrun():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", WHISPER, "--smoke", "--device", "cpu",
         "--fsdp", "--steps", "2", "--log-every", "1"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    losses = [float(x) for x in re.findall(r"^step +\d+  loss (\d+\.\d+)", res.stdout, re.M)]
    assert len(losses) == 2 and all(np.isfinite(losses)), res.stdout[-2000:]
    assert "[control-plane]" in res.stdout


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", "gemma2-9b", "qwen2.5-14b",
                                  "deepseek-v3-671b", "grok-1-314b", RWKV, JAMBA, WHISPER, VLM])
def test_every_arch_builds_its_fsdp_blocks(arch):
    """Every arch builds a rank's ZeRO-3 blocks (``registry.local_model``
    and ``init_local`` with a DP group of 4): each rank's blocks are its
    blocks of the single-device ``init(0)`` weights, and the four ranks'
    blocks together hold every element of the cut leaves once."""
    from repro_torch.dist.fsdp import DPAxis, block, cut_of
    from repro_torch.models import get_api, smoke_config
    from repro_torch.models.registry import init_local, local_model

    cfg = smoke_config(arch)
    whole = dict(get_api(cfg, device="cpu").init(0).named_parameters())
    cut = uncut = 0
    for index in range(4):
        dp = DPAxis(4, index, None, [0, 1, 2, 3], "data")
        model = init_local(local_model(cfg, torch.device("cpu"), None, dp), 0, "cpu")
        for name, p in model.named_parameters():
            assert torch.equal(p, block(whole[name].detach(), cut_of(p), dp)), (arch, name)
            if hasattr(p, "fsdp_shape"):
                assert tuple(p.fsdp_shape) == tuple(whole[name].shape), (arch, name)
                cut += p.numel()
            elif index == 0:
                uncut += p.numel()
    assert cut + uncut == sum(p.numel() for p in whole.values()) and cut > 0.9 * (cut + uncut)
