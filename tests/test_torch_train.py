"""The port's training path against the JAX package's on the CPU: the
synthetic data, the schedule, global-norm clipping and AdamW, the fused
cross-entropy loss, ``lm_loss`` with every parameter's gradient, one train
step, gradient accumulation, and the train command line.

Both stacks run in float32 on smoke configs (2 layers, narrow widths);
weights go from JAX into the port through the weight bridge, and every other
input is drawn with numpy from a fixed seed and handed to both.  JAX's
``make_train_step`` is not used as an oracle: it fails on this JAX version
(ROADMAP C.1), so the JAX step is composed by hand from
``jax.value_and_grad(lm_loss)`` and ``adamw_update``.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import get_api as jget_api  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import get_api, smoke_config, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import Embed, cross_entropy, cross_entropy_fused  # noqa: E402
from repro_torch.train import data, optimizer  # noqa: E402
from repro_torch.train.trainstep import (  # noqa: E402
    TrainHparams, _accum_grads, batch_to_torch, make_train_state, train_step)

LOSS_TOL = 1e-5
MODEL_TOL = 1e-4


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["affine", "uniform"])
@pytest.mark.parametrize("step,lo,hi", [(0, 0, None), (7, 0, None), (3, 2, 5)])
def test_synthetic_data_equals_jax(mode, step, lo, hi):
    kw = dict(vocab_size=512, batch=6, seq=24, seed=3, mode=mode)
    got = data.SyntheticData(data.DataConfig(**kw)).batch_at(step, lo, hi)
    want = jdata.SyntheticData(jdata.DataConfig(**kw)).batch_at(step, lo, hi)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

OPT = dict(lr=3e-4, warmup_steps=10, total_steps=100)


@pytest.mark.parametrize("step", [0, 1, 10, 55, 100, 250])  # 0, 1, warmup, mid, total, beyond
def test_schedule_matches_jax(step):
    got = optimizer.schedule(optimizer.OptConfig(**OPT), torch.tensor(step, dtype=torch.int32))
    want = jopt.schedule(jopt.OptConfig(**OPT), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-7, atol=0)


SHAPES = {"a": (4, 8), "b": (8,), "c.d": (3, 5, 2)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.standard_normal(s)).astype(np.float32) for n, s in SHAPES.items()}


def _jax_tree(flat):
    """The flat names as a nested dict (a pytree whose leaves are in sorted
    order, as the port's named parameters here)."""
    return {"a": jnp.asarray(flat["a"]), "b": jnp.asarray(flat["b"]),
            "c": {"d": jnp.asarray(flat["c.d"])}}


def _jax_flat(tree):
    return {"a": tree["a"], "b": tree["b"], "c.d": tree["c"]["d"]}


class _Params(torch.nn.Module):
    def __init__(self, flat):
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(flat["a"].copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(flat["b"].copy()))
        self.c = torch.nn.Module()
        self.c.d = torch.nn.Parameter(torch.from_numpy(flat["c.d"].copy()))


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_global_norm_matches_jax(scale):
    g = _tree(0, scale)
    got = optimizer.global_norm(torch.from_numpy(a) for a in g.values())
    want = jopt.global_norm(_jax_tree(g))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(scale):
    """Three steps on one random tree, each with new random gradients."""
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    params = _tree(1)
    model = _Params(params)
    state = optimizer.adamw_init(model)
    jparams = _jax_tree(params)
    jstate = jopt.adamw_init(jparams)
    for step in range(3):
        g = _tree(10 + step, scale)
        metrics = optimizer.adamw_update(model, {n: torch.from_numpy(a) for n, a in g.items()},
                                         state, optimizer.OptConfig(**opt))
        jparams, jstate, jmetrics = jopt.adamw_update(_jax_tree(g), jstate, jparams,
                                                      jopt.OptConfig(**opt))
        np.testing.assert_allclose(metrics["lr"].item(), float(jmetrics["lr"]), rtol=1e-7)
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                                   rtol=1e-6)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        got = dict(model.named_parameters())
        for name, want in _jax_flat(jparams).items():
            np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-6, err_msg=name)
        for key in ("m", "v"):
            for name, want in _jax_flat(jstate[key]).items():
                np.testing.assert_allclose(state[key][name].numpy(), np.asarray(want),
                                           atol=1e-6, rtol=1e-6, err_msg=f"{key} {name}")


def test_adamw_state_is_fp32_for_bf16_params():
    cfg = smoke_config("gemma-2b").replace(num_layers=2, param_dtype="bfloat16",
                                           compute_dtype="bfloat16")
    state = make_train_state(get_api(cfg, device="cpu"), seed=0)
    assert state["opt"]["step"].dtype == torch.int32 and int(state["opt"]["step"]) == 0
    names = [n for n, _ in state["model"].named_parameters()]
    assert list(state["opt"]["m"]) == names == list(state["opt"]["v"])
    for n, p in state["model"].named_parameters():
        assert p.dtype == torch.bfloat16
        assert state["opt"]["m"][n].dtype == state["opt"]["v"][n].dtype == torch.float32
        assert not state["opt"]["m"][n].any() and not state["opt"]["v"][n].any()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32)
    targets = rng.integers(0, 40, (2, 9))
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                        None if mask is None else torch.from_numpy(mask))
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                 None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)


def _embed_pair(arch):
    """(JAX cfg, JAX embed params, port Embed) with one set of weights."""
    jcfg = jsmoke(arch)
    jparams = jlayers.init_embed(jax.random.PRNGKey(0), jcfg)
    emb = Embed(smoke_config(arch), torch.device("cpu"))
    emb.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jparams.items()})
    return jcfg, jparams, emb


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2.5-14b", "gemma2-9b"],
                         ids=["tied-scaled", "untied", "logit-softcap"])
@pytest.mark.parametrize("S", [24, 1024, 768], ids=["S<512", "S=2x512", "S=3x256"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_fused_value_and_grads_match_jax(arch, S, masked):
    """Value and gradients w.r.t. h and the embedding, chunk rule included
    (S < 512: one chunk of S; 1024: chunks of 512; 768: gcd(768, 512) = 256)."""
    jcfg, jparams, emb = _embed_pair(arch)
    rng = np.random.default_rng(1)
    B = 2 if S < 512 else 1
    h = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, jcfg.vocab_size, (B, S))
    mask = (rng.random((B, S)) > 0.25).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, (want_dh, want_de) = jax.value_and_grad(
        lambda hh, ep: jlayers.cross_entropy_fused(hh, ep, jnp.asarray(targets), jcfg, jm),
        argnums=(0, 1))(jnp.asarray(h), jparams)
    ht = torch.from_numpy(h).requires_grad_()
    got = cross_entropy_fused(ht, emb, torch.from_numpy(targets),
                              None if mask is None else torch.from_numpy(mask))
    names, params = zip(*emb.named_parameters())
    # an untied model's loss does not read embed.tok: its gradient is zero, as in JAX
    dh, *de = torch.autograd.grad(got, (ht, *params), materialize_grads=True)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), atol=LOSS_TOL, rtol=LOSS_TOL)
    assert sorted(names) == sorted(want_de)
    for name, g in zip(names, de):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_de[name]), atol=LOSS_TOL,
                                   rtol=LOSS_TOL, err_msg=name)


def test_cross_entropy_fused_keeps_no_full_logits():
    """Each chunk's logits are recomputed in the backward pass, so the graph
    holds no tensor of the full (B, S, V) logits."""
    _, _, emb = _embed_pair("gemma-2b")
    V = emb.tok.shape[0]
    h = torch.randn(1, 1024, emb.tok.shape[1], requires_grad=True)
    targets = torch.randint(0, V, (1, 1024))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                                                  lambda t: t):
        cross_entropy_fused(h, emb, targets)
    assert saved and all(s.numel() < 512 * V for s in saved), saved


# ---------------------------------------------------------------------------
# the model's loss and gradients
# ---------------------------------------------------------------------------

def _bridged(arch, **replace):
    jcfg = jsmoke(arch).replace(num_layers=2, **replace)
    jparams = jget_api(jcfg).init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(num_layers=2, **replace)
    model = transformer.DecoderLM(cfg, torch.device("cpu"))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg))
    return jcfg, jparams, cfg, model


def _batch(cfg, B=2, S=24, seed=0):
    d = data.SyntheticData(data.DataConfig(vocab_size=cfg.vocab_size, batch=B, seq=S,
                                           seed=seed, mode="uniform"))
    return d.batch_at(0)


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", "gemma2-9b", "qwen2.5-14b", "rwkv6-1.6b"])
def test_lm_loss_and_every_gradient_match_jax(arch):
    """rwkv6's WKV6 gradient comes from the backward plain version,
    ``ref.wkv6_backward_reference`` (the wrapper's autograd function on the
    CPU); JAX's from XLA's gradient of its chunked scan."""
    jcfg, jparams, cfg, model = _bridged(arch)
    batch = _batch(cfg)
    want, jgrads = jax.value_and_grad(jtransformer.lm_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss = model_loss = transformer.lm_loss(model, batch_to_torch(batch, "cpu"))
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(model_loss, params)
    np.testing.assert_allclose(loss.item(), float(want), rtol=MODEL_TOL)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want_grads) == set(names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=MODEL_TOL,
                                   rtol=MODEL_TOL, err_msg=name)


def test_return_hidden_matches_jax():
    jcfg, jparams, cfg, model = _bridged("gemma-2b")
    tokens = _batch(cfg)["tokens"]
    want, _, _ = jtransformer.apply_lm(jparams, jnp.asarray(tokens), jcfg, return_hidden=True)
    with torch.no_grad():
        got, cache = transformer.apply_lm(model, torch.from_numpy(tokens.astype(np.int64)),
                                          return_hidden=True)
    assert cache is None and got.shape == (2, 24, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL, rtol=0)


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", "rwkv6-1.6b"])
def test_train_step_matches_jax(arch):
    """One AdamW step.  At step 0 AdamW's update is close to lr sign(g), so a
    gradient entry near zero on which the two stacks round differently flips
    a whole update: the delta is compared where |g| > 1e-3 max|g| of its
    leaf, and JAX's own gradients through the port's adamw_update must give
    JAX's update at 1e-6."""
    jcfg, jparams, cfg, model = _bridged(arch)
    batch = _batch(cfg, seed=1)
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = optimizer.adamw_init(model)
    metrics = train_step(model, state, batch_to_torch(batch, "cpu"),
                         optimizer.OptConfig(**opt_kw), TrainHparams())
    jloss, jgrads = jax.value_and_grad(jtransformer.lm_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    jnew, _, jmetrics = jopt.adamw_update(jgrads, jopt.adamw_init(jparams), jparams,
                                          jopt.OptConfig(**opt_kw))
    np.testing.assert_allclose(metrics["loss"].item(), float(jloss), rtol=MODEL_TOL)
    np.testing.assert_allclose(metrics["lr"].item(), float(jmetrics["lr"]), rtol=1e-7)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=MODEL_TOL)
    as_np = lambda tree: params_from_jax(jax.tree_util.tree_map(np.asarray, tree), cfg)  # noqa
    g, new = as_np(jgrads), as_np(jnew)
    for name, p in model.named_parameters():
        big = g[name].abs() > 1e-3 * g[name].abs().max()
        assert big.any(), name
        delta, want = p.detach() - before[name], new[name] - before[name]
        torch.testing.assert_close(delta[big], want[big], atol=1e-6, rtol=1e-4)

    # JAX's gradients through the port's update
    model.load_state_dict(before)
    optimizer.adamw_update(model, g, optimizer.adamw_init(model), optimizer.OptConfig(**opt_kw))
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), new[name], atol=1e-6, rtol=1e-6)


def test_grad_accum_two_equals_one():
    cfg = smoke_config("olmo-1b").replace(num_layers=2)
    api = get_api(cfg, device="cpu")
    batch = batch_to_torch(_batch(cfg, B=4, S=16, seed=2), "cpu")
    model = api.init(seed=0)
    out = [_accum_grads(model, batch, n) for n in (1, 2)]
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-5, rtol=1e-5)
    for name, g in out[0][1].items():
        assert out[1][1][name].dtype == torch.float32
        torch.testing.assert_close(out[1][1][name], g, atol=1e-5, rtol=1e-5)
    # and the step: the same parameters after one update each
    models = [api.init(seed=0) for _ in range(2)]
    for m, n in zip(models, (1, 2)):
        train_step(m, optimizer.adamw_init(m), batch, optimizer.OptConfig(warmup_steps=1),
                   TrainHparams(grad_accum=n))
    for (name, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        big = out[0][1][name].abs() > 1e-3 * out[0][1][name].abs().max()
        torch.testing.assert_close(a.detach()[big], b.detach()[big], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("flag", ["hierarchical", "compress", "zero1", "fsdp"])
def test_distributed_hparams_are_not_ported(flag):
    cfg = smoke_config("olmo-1b").replace(num_layers=2)
    state = make_train_state(get_api(cfg, device="cpu"))
    batch = batch_to_torch(_batch(cfg), "cpu")
    # the data-axes flags, ZeRO-3's too, need a mesh (make_train_step, A.7)
    with pytest.raises(NotImplementedError, match=r"needs a mesh.*A\.7"):
        train_step(state["model"], state["opt"], batch, optimizer.OptConfig(),
                   TrainHparams(**{flag: True}))


@pytest.mark.parametrize("arch", ["whisper-small", "internvl2-1b"])
def test_encoder_decoder_and_vlm_do_not_train_yet(arch):
    """They used to be refused here; now their losses (``whisper_loss``,
    ``vlm_loss``) are wired to the step, so the step's state is built for
    them, AdamW's moments beside every parameter (the step itself is held
    against JAX in ``test_torch_train_families.py``)."""
    state = make_train_state(get_api(smoke_config(arch), device="cpu"))
    names = [n for n, _ in state["model"].named_parameters()]
    assert names and list(state["opt"]["m"]) == names == list(state["opt"]["v"])


def test_loss_decreases():
    """The port alone, as tests/test_trainstep.py asks of JAX: 30 steps of the
    olmo-1b smoke config on the learnable affine data."""
    cfg = smoke_config("olmo-1b")
    state = make_train_state(get_api(cfg, device="cpu"), seed=0)
    d = data.SyntheticData(data.DataConfig(vocab_size=cfg.vocab_size, batch=8, seq=32, seed=0))
    opt = optimizer.OptConfig(lr=5e-3, warmup_steps=5, total_steps=200, weight_decay=0.0)
    losses = []
    for i in range(30):
        m = train_step(state["model"], state["opt"], batch_to_torch(d.batch_at(i), "cpu"), opt)
        losses.append(m["loss"].item())
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses


def test_train_cli_smoke(capsys):
    train_cli.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps", "3",
                    "--log-every", "1", "--batch", "2", "--seq", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4, lines
    assert re.fullmatch(r"\[control-plane\] arch=gemma-2b pods=\(0, 1\) plan\(tp=8, ep=1\) "
                        r"demand=128 links  LTRR=1\.000 mdmcf=\d+\.\d ms", lines[0]), lines[0]
    for i, line in enumerate(lines[1:]):
        m = re.fullmatch(r"step +(\d+)  loss (\d+\.\d+)  lr (\S+)  ([\d,]+) tok/s", line)
        assert m and int(m.group(1)) == i and np.isfinite(float(m.group(2))), line


def test_train_cli_smoke_rwkv6(capsys):
    """rwkv6-1.6b through the train CLI on the CPU: its WKV6 gradient goes
    through the backward plain version."""
    train_cli.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu", "--steps", "2",
                    "--log-every", "1", "--batch", "2", "--seq", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3, lines
    assert lines[0].startswith("[control-plane] arch=rwkv6-1.6b pods=(0, 1) "), lines[0]
    for i, line in enumerate(lines[1:]):
        m = re.fullmatch(r"step +(\d+)  loss (\d+\.\d+)  lr (\S+)  ([\d,]+) tok/s", line)
        assert m and int(m.group(1)) == i and np.isfinite(float(m.group(2))), line
