"""The port's checkpoints against the JAX package's, on the CPU: a JAX
checkpoint restores into the port and a port checkpoint into JAX, bit for
bit, in the same on-disk format; a background save keeps the state as it
was when it was called; a resumed run equals an uninterrupted one bit for
bit; the train command line resumes.

Smoke configs of gemma-2b and rwkv6-1.6b with 2 layers, in fp32 and in
bf16 (where rwkv6 keeps ``w0`` and ``u`` in fp32).  The JAX state after one
AdamW step (non-zero moments, step 1) is composed by hand from
``jax.value_and_grad(lm_loss)`` and ``adamw_update``, as
``tests/test_torch_train.py`` does: JAX's ``make_train_step`` fails on this
JAX version (ROADMAP C.1).
"""
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import manager as jmanager  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainstep as jtrainstep  # noqa: E402
from repro_torch.ckpt import latest_step, manager, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import get_api, smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticData  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainstep import batch_to_torch, make_train_state, train_step  # noqa: E402

CASES = [(a, d) for a in ("gemma-2b", "rwkv6-1.6b") for d in ("float32", "bfloat16")]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


def _cfgs(arch, dtype):
    kw = dict(num_layers=2, param_dtype=dtype, compute_dtype=dtype)
    return jsmoke(arch).replace(**kw), smoke_config(arch).replace(**kw)


def _batch(cfg, step=0):
    d = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=2, seq=16, seed=1))
    return d.batch_at(step)


def _port_state(cfg, seed=0, steps=1):
    state = make_train_state(get_api(cfg, device="cpu"), seed=seed)
    for i in range(steps):
        train_step(state["model"], state["opt"], batch_to_torch(_batch(cfg, i), "cpu"),
                   OptConfig(**OPT))
    return state


def _leaves(state):
    """The port's state as the file's keys and arrays (host copies)."""
    return manager._flatten(manager._snapshot(state), state["model"].cfg)


def _assert_same_leaves(got, want):
    assert list(got) == list(want)  # the same keys in the same order
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_jax_checkpoint_restores_into_the_port(arch, dtype, tmp_path):
    jcfg, cfg = _cfgs(arch, dtype)
    jstate = jtrainstep.make_train_state(jget_api(jcfg), jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    _, grads = jax.value_and_grad(jtransformer.lm_loss)(jstate["params"], batch, jcfg)
    params, opt, _ = jopt.adamw_update(grads, jstate["opt"], jstate["params"],
                                       jopt.OptConfig(**OPT))
    jstate = {"params": params, "opt": opt}
    assert int(opt["step"]) == 1
    jmanager.save_checkpoint(str(tmp_path), 1, jstate)

    state = make_train_state(get_api(cfg, device="cpu"), seed=7)
    assert restore_checkpoint(str(tmp_path), state) == 1
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    want_params = params_from_jax(as_np(params), cfg)
    for name, p in state["model"].named_parameters():
        assert p.dtype == want_params[name].dtype, name
        assert torch.equal(p.detach(), want_params[name]), name
    for key in ("m", "v"):
        want = params_from_jax(as_np(opt[key]), cfg, torch.float32)
        assert any(bool(t.any()) for t in want.values())
        for name, t in state["opt"][key].items():
            assert t.dtype == torch.float32 and torch.equal(t, want[name]), (key, name)
    assert state["opt"]["step"].dtype == torch.int32 and int(state["opt"]["step"]) == 1
    _assert_same_leaves(_leaves(state), jmanager._flatten(jstate))


@pytest.mark.parametrize("arch,dtype", CASES)
def test_port_checkpoint_restores_into_jax(arch, dtype, tmp_path):
    jcfg, cfg = _cfgs(arch, dtype)
    state = _port_state(cfg)
    save_checkpoint(str(tmp_path / "port"), 1, state)
    like = jax.eval_shape(lambda: jtrainstep.make_train_state(jget_api(jcfg),
                                                               jax.random.PRNGKey(0)))
    restored = jmanager.restore_checkpoint(str(tmp_path / "port"), like)
    for leaf, want in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(like)):
        assert leaf.dtype == want.dtype and leaf.shape == want.shape
    if dtype == "bfloat16" and arch == "rwkv6-1.6b":  # w0 and u stay fp32
        assert restored["params"]["units"]["l0"]["mix"]["w0"].dtype == jnp.float32
        assert restored["params"]["units"]["l0"]["mix"]["wr"].dtype == jnp.bfloat16
    _assert_same_leaves(jmanager._flatten(restored), _leaves(state))
    # JAX writing the restored state gives the port's manifest and keys
    jmanager.save_checkpoint(str(tmp_path / "jax"), 1, restored)
    read = lambda d, f: open(os.path.join(tmp_path, d, f)).read()  # noqa: E731
    assert json.loads(read("port", "step_1.json")) == json.loads(read("jax", "step_1.json"))
    with np.load(tmp_path / "port" / "step_1.npz") as a, np.load(tmp_path / "jax" / "step_1.npz") as b:
        assert a.files == b.files
    assert sorted(os.listdir(tmp_path / "port")) == ["step_1.json", "step_1.npz"]


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_background_save_keeps_the_state_of_its_call(arch, tmp_path):
    """A step in place right after a background save does not reach the
    checkpoint: the save took a host copy before it returned."""
    _, cfg = _cfgs(arch, "float32")
    state = _port_state(cfg)
    want = _leaves(state)
    writer = save_checkpoint(str(tmp_path), 1, state, background=True)
    train_step(state["model"], state["opt"], batch_to_torch(_batch(cfg, 1), "cpu"),
               OptConfig(**OPT))
    writer.join(timeout=120)
    assert not writer.is_alive() and writer.seconds is not None
    moved = _leaves(state)
    assert all(not np.array_equal(moved[k], want[k]) for k in want if "/units/" in k)
    fresh = make_train_state(get_api(cfg, device="cpu"), seed=3)
    assert restore_checkpoint(str(tmp_path), fresh, step=1) == 1
    _assert_same_leaves(_leaves(fresh), want)


def test_failed_writes_and_restores_raise(tmp_path, monkeypatch):
    _, cfg = _cfgs("gemma-2b", "float32")
    state = _port_state(cfg)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), state)

    def full(*_, **__):
        raise OSError("no space left on device")
    with monkeypatch.context() as m:
        m.setattr(manager.np, "savez", full)
        writer = save_checkpoint(str(tmp_path), 1, state, background=True)
        with pytest.raises(RuntimeError, match="background") as info:
            writer.join(timeout=60)
        assert isinstance(info.value.__cause__, OSError)
        with pytest.raises(OSError):
            save_checkpoint(str(tmp_path), 1, state)
    assert latest_step(str(tmp_path)) is None  # nothing half-written took the name

    save_checkpoint(str(tmp_path), 1, state)
    before = _leaves(state)
    wider = make_train_state(get_api(cfg.replace(d_model=2 * cfg.d_model), device="cpu"))
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), wider)
    other = make_train_state(get_api(smoke_config("olmo-1b").replace(num_layers=2),
                                     device="cpu"))
    with pytest.raises((KeyError, ValueError)):
        restore_checkpoint(str(tmp_path), other)
    _assert_same_leaves(_leaves(state), before)


@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-1.6b"])
def test_resumed_run_equals_uninterrupted(arch, tmp_path):
    """The launcher's loop, as chip_smoke.py drives it on the card: steps
    0-3 with a background save after step 1 and the final one after step 3;
    then a state of another seed restored from step 1 and stepped twice."""
    _, cfg = _cfgs(arch, "float32")
    kw = dict(steps=4, batch=2, seq=16, lr=3e-3, log_every=1, device="cpu")
    ckpt = str(tmp_path)
    a = train_cli.train_loop(cfg, ckpt_dir=ckpt, ckpt_every=2, **kw)
    assert [s["step"] for s in a["saves"]] == [1, 3]
    assert a["saves"][0]["writer"].seconds is not None and a["saves"][1]["writer"] is None
    for ext in ("npz", "json"):
        os.remove(os.path.join(ckpt, f"step_3.{ext}"))
    fresh = make_train_state(get_api(cfg, device="cpu"), seed=1)
    first = next(iter(fresh["model"].parameters()))
    assert not torch.equal(first, next(iter(a["state"]["model"].parameters())))

    b = train_cli.train_loop(cfg, ckpt_dir=ckpt, ckpt_every=2, seed=1, **kw)
    assert b["restore_s"] is not None and [s["step"] for s in b["saves"]] == [3]
    assert [r["step"] for r in b["log"]] == [2, 3]
    assert [(r["loss"], r["lr"]) for r in b["log"]] == [(r["loss"], r["lr"])
                                                         for r in a["log"][2:]]
    _assert_same_leaves(_leaves(b["state"]), _leaves(a["state"]))


def test_train_cli_resumes(tmp_path, capsys):
    args = ["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu", "--log-every", "1",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    train_cli.main(args + ["--steps", "2"])
    first = capsys.readouterr().out.strip().splitlines()
    assert first[0].startswith("[control-plane] arch=rwkv6-1.6b pods=(0, 1)")
    assert first[-1] == "[ckpt] final at step 1" and latest_step(str(tmp_path)) == 1
    train_cli.main(args + ["--steps", "4"])
    second = capsys.readouterr().out.strip().splitlines()
    assert second[1] == "[resume] from step 1" and second[-1] == "[ckpt] final at step 3"
    train_cli.main(args[:-2] + ["--steps", "4"])
    whole = capsys.readouterr().out.strip().splitlines()
    no_rate = lambda line: re.sub(r"  [\d,]+ tok/s$", "", line)  # noqa: E731
    assert [no_rate(x) for x in second[2:4]] == [no_rate(x) for x in whole[3:5]]
    assert [no_rate(x) for x in first[1:3]] == [no_rate(x) for x in whole[1:3]]
    assert all(re.fullmatch(r"step +\d+  loss \d+\.\d+  lr \S+", no_rate(x)) for x in whole[1:])
