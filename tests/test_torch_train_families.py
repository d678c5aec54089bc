"""Training the encoder-decoder, the VLM, the MoE and the hybrid families on
the port, against the JAX package on the CPU: one ``train_step`` of the
fp32 smoke configs of whisper-small, internvl2-1b, deepseek-v3-671b (MLA, 1
dense + 4 MoE layers), grok-1-314b (4 MoE layers) and jamba-1.5-large-398b
(one unit: 1 GQA + 7 Mamba layers, MoE on every other, its loss with 0.01 x
the auxiliary loss; the selective scan's plain forward and backward, which
the CPU runs in place of the kernels) against JAX's
``_accum_grads(api.loss, ...)`` and ``adamw_update``, at ``grad_accum`` 1 and
2; ``batch_to_torch``'s dtypes; the train command line on whisper-small,
internvl2-1b and jamba, with a resume for the first two.

Weights go from JAX into the port through the weight bridge, and the batch
is one numpy batch of ``SyntheticData`` (frames or patches included) handed
to both.  Tolerances, fp32 on both sides: the loss 1e-5 relative, every
gradient 1e-4 (absolute and relative), as the models' own loss-gradient
tests hold them (sums over d and the vocabulary in another order); the
update where |g| > 1e-3 max|g| of its leaf within 1e-6 + 1e-4 relative (at
step 0 AdamW's update is close to lr sign(g), so a gradient entry near zero
that rounds the other way flips a whole update), and JAX's gradients
through the port's update give JAX's parameters within 1e-6.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import get_api as jget_api  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.trainstep import _accum_grads as jaccum_grads  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import get_api, smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import model_class  # noqa: E402
from repro_torch.train import data, optimizer  # noqa: E402
from repro_torch.train.trainstep import (  # noqa: E402
    TrainHparams, _accum_grads, batch_to_torch, make_train_state, train_step)

ARCHS = ["whisper-small", "internvl2-1b", "deepseek-v3-671b", "grok-1-314b",
         "jamba-1.5-large-398b"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _bridged(arch):
    """(JAX api, JAX params, port cfg, port model on the CPU), one set of weights."""
    japi = jget_api(jsmoke(arch))
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch)
    model = model_class(cfg)(cfg, torch.device("cpu"))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg),
                          strict=True)
    return japi, jparams, cfg, model


def _batch(cfg, B=4, S=16, seed=1):
    """One numpy batch of the synthetic data, with the model's frames or patches."""
    d = data.SyntheticData(data.DataConfig(vocab_size=cfg.vocab_size, batch=B, seq=S,
                                           seed=seed, mode="uniform"), model_cfg=cfg)
    return d.batch_at(0)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, grad_accum):
    """The loss, every gradient (at ``grad_accum`` 2 the two microbatches'
    sum into fp32, every entry of the batch split by rows) and the updated
    parameters."""
    japi, jparams, cfg, model = _bridged(arch)
    batch = _batch(cfg)
    assert ("frames" in batch) == (cfg.family == "audio")
    assert ("patches" in batch) == (cfg.family == "vlm")
    tbatch, hp, opt = batch_to_torch(batch, "cpu"), TrainHparams(grad_accum=grad_accum), \
        optimizer.OptConfig(**OPT)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = train_step(model, optimizer.adamw_init(model), tbatch, opt, hp)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    jloss, jgrads = jaccum_grads(japi.loss, jparams,
                                 {k: jnp.asarray(v) for k, v in batch.items()}, grad_accum)
    jnew, _, jmetrics = jopt.adamw_update(jgrads, jopt.adamw_init(jparams), jparams,
                                          jopt.OptConfig(**OPT))
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["lr"].item(), float(jmetrics["lr"]), rtol=1e-7)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=GRAD_TOL)

    as_np = lambda tree: params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg)  # noqa
    g, new = as_np(jgrads), as_np(jnew)
    model.load_state_dict(before)
    loss, grads = _accum_grads(model, tbatch, grad_accum)  # the step's own gradients
    assert loss.item() == metrics["loss"].item() and set(grads) == set(g)
    for name, got in grads.items():
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), g[name].numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)
    for name in before:
        big = g[name].abs() > 1e-3 * g[name].abs().max()
        if not big.any():  # a leaf the loss does not read: a zero gradient, as in JAX
            continue
        delta, want = after[name] - before[name], new[name] - before[name]
        torch.testing.assert_close(delta[big], want[big], atol=1e-6, rtol=1e-4)

    # JAX's gradients through the port's update
    model.load_state_dict(before)
    optimizer.adamw_update(model, g, optimizer.adamw_init(model), opt)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), new[name], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_batch_to_torch_keeps_float_inputs_float(arch):
    cfg = smoke_config(arch)
    batch = _batch(cfg, B=2)
    batch["mask"] = (np.arange(2 * 16).reshape(2, 16) % 3 > 0).astype(np.int32)
    got = batch_to_torch(batch, "cpu")
    key = "frames" if arch == "whisper-small" else "patches"
    assert got[key].dtype == torch.float32
    np.testing.assert_array_equal(got[key].numpy(), batch[key])
    for k in ("tokens", "targets", "mask"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), batch[k])
    as_f64 = batch_to_torch({key: batch[key].astype(np.float64)}, "cpu")[key]
    assert as_f64.dtype == torch.float32


def test_every_family_has_its_loss():
    from repro_torch.models import transformer, vlm, whisper

    want = {"whisper-small": whisper.whisper_loss, "internvl2-1b": vlm.vlm_loss,
            "deepseek-v3-671b": transformer.lm_loss, "grok-1-314b": transformer.lm_loss,
            "jamba-1.5-large-398b": transformer.lm_loss, "gemma-2b": transformer.lm_loss}
    for arch, fn in want.items():
        assert get_api(smoke_config(arch), device="cpu").loss is fn, arch


def _step_lines(lines):
    out = []
    for line in lines:
        m = re.fullmatch(r"step +(\d+)  loss (\d+\.\d+)  lr (\S+)  ([\d,]+) tok/s", line)
        assert m and np.isfinite(float(m.group(2))), line
        out.append(line.rsplit("  ", 1)[0])  # without the rate
    return out


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b", "jamba-1.5-large-398b"])
def test_train_cli_trains(arch, capsys):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--log-every", "1", "--batch", "2", "--seq", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3, lines
    assert lines[0].startswith(f"[control-plane] arch={arch} pods=(0, 1) "), lines[0]
    assert [x.split()[1] for x in _step_lines(lines[1:])] == ["0", "1"]


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_train_cli_resumes_to_the_uninterrupted_parameters(arch, tmp_path, capsys):
    """Two steps with a checkpoint, then a rerun to four that resumes from it:
    the losses of steps 2-3 and the final checkpoint (parameters, moments,
    step) equal an uninterrupted four-step run's bit for bit."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--log-every", "1",
            "--batch", "2", "--seq", "16", "--lr", "3e-3"]
    resumed, whole = str(tmp_path / "resumed"), str(tmp_path / "whole")
    train_cli.main(args + ["--ckpt-dir", resumed, "--steps", "2"])
    capsys.readouterr()
    train_cli.main(args + ["--ckpt-dir", resumed, "--steps", "4"])
    second = capsys.readouterr().out.strip().splitlines()
    assert second[1] == "[resume] from step 1" and second[-1] == "[ckpt] final at step 3"
    train_cli.main(args + ["--ckpt-dir", whole, "--steps", "4"])
    first = capsys.readouterr().out.strip().splitlines()
    assert _step_lines(second[2:4]) == _step_lines(first[3:5])
    with np.load(os.path.join(resumed, "step_3.npz")) as a, \
            np.load(os.path.join(whole, "step_3.npz")) as b:
        assert sorted(a.files) == sorted(b.files) and any(k.startswith("opt/m/") for k in a.files)
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
