"""The port's VLM against the JAX package's, on the CPU in float32.

One set of weights (``api.init(PRNGKey(0))`` of JAX's smoke config: the
projector 32 -> 64 -> 64 and a 4-layer GQA 4/2 language model with qkv
bias, 8 patches) is carried into the port by the weight bridge, and the
inputs are ``make_smoke_batch``'s numpy draws on both sides.  Held at atol
1e-4 (``test_torch_models.py``'s tolerance): the projector, ``apply_vlm``
in train, prefill and decode modes with the cache after every step (the
vision prefix in its first slots), ``vlm_loss`` and its gradients; the
bridge round trip bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.ckpt.manager import _flatten as ckpt_flatten  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro.models import make_smoke_batch as jbatch  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro_torch.models import get_api, make_smoke_batch, smoke_config, vlm  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402

ARCH = "internvl2-1b"
ATOL = 1e-4


def _bridged(**replace):
    jcfg = jsmoke(ARCH).replace(**replace)
    japi = jget_api(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = smoke_config(ARCH).replace(**replace)
    model = vlm.VLM(cfg, torch.device("cpu"))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg),
                          strict=True)
    return jcfg, japi, jparams, cfg, model


def _batches(jcfg, cfg, seq=16):
    jb = jbatch(jcfg, batch=2, seq=seq)
    tb = make_smoke_batch(cfg, batch=2, seq=seq, device="cpu")
    for key in ("tokens", "targets", "patches"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    return jb, tb


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL, rtol=0)


def test_project_matches_jax():
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    with torch.no_grad():
        got = vlm._project(model.proj, tb["patches"], cfg)
    assert got.shape == (2, cfg.vision_tokens, cfg.d_model)
    _close(got, jvlm._project(jparams["proj"], jb["patches"], jcfg))


def test_train_logits_match_jax():
    """[projected patches][embedded tokens] through the LM: logits at every
    position, the vision prefix's included."""
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    want, _, _ = jvlm.apply_vlm(jparams, jb["tokens"], jb["patches"], jcfg)
    with torch.no_grad():
        got, cache = vlm.apply_vlm(model, tb["tokens"], tb["patches"])
    assert cache is None and got.shape == (2, cfg.vision_tokens + 16, cfg.vocab_size)
    _close(got, want)


def test_prefill_and_decode_match_jax():
    """Prefill 8 patches + 4 tokens through the API, then 12 decode steps:
    the logits and every layer's KV after every step; the cache holds
    s_max + vision_tokens slots, the prefix in the first ones."""
    jcfg, japi, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    api = get_api(cfg, device="cpu")
    s_max, s0, nv = 20, 4, cfg.vision_tokens
    jcache = japi.init_cache(2, s_max)
    cache = api.init_cache(2, s_max)
    assert cache["layers"][0][0].shape[1] == jcache["units"]["l0"][0].shape[2] == s_max + nv
    jl, jcache = japi.prefill(
        jparams, {"tokens": jb["tokens"][:, :s0], "patches": jb["patches"]}, jcache)
    jdecode = jax.jit(japi.decode)

    def close_cache():
        assert cache["pos"] == int(jcache["pos"])
        for i, entry in enumerate(cache["layers"]):
            for t, j in zip(entry, jcache["units"]["l0"]):
                _close(t, j[i])

    with torch.no_grad():
        tl, cache = api.prefill(
            model, {"tokens": tb["tokens"][:, :s0], "patches": tb["patches"]}, cache)
        assert tl.shape == (2, nv + s0, cfg.vocab_size) and cache["pos"] == nv + s0
        _close(tl, jl)
        close_cache()
        k = cache["layers"][0][0]
        assert k[:, :nv + s0].abs().sum(-1).min() > 0 and not k[:, nv + s0:].any()
        last, _ = api.prefill(model, {"tokens": tb["tokens"][:, :s0], "patches": tb["patches"]},
                              api.init_cache(2, s_max), last_only=True)
        _close(last, jl[:, -1:])
        for t in range(s0, 16):
            jl, jcache = jdecode(jparams, jb["tokens"][:, t:t + 1], jcache)
            tl, cache = api.decode(model, tb["tokens"][:, t:t + 1], cache)
            _close(tl, jl)
            close_cache()
    assert cache["pos"] == nv + 16


def test_vlm_loss_matches_jax():
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    with torch.no_grad():
        got = vlm.vlm_loss(model, tb)
    np.testing.assert_allclose(got.item(), float(jvlm.vlm_loss(jparams, jb, jcfg)),
                               atol=1e-5, rtol=0)


def test_vlm_loss_gradients_match_jax():
    """Every parameter's gradient, the projector's through the text
    positions' attention to the prefix."""
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    want, jgrads = jax.value_and_grad(jvlm.vlm_loss)(jparams, jb, jcfg)
    loss = vlm.vlm_loss(model, tb)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5, rtol=0)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want_grads) == set(names) and "proj.w1" in names
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=ATOL, rtol=ATOL,
                                   err_msg=name)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips(dtype):
    """JAX's checkpoint layout -> the port -> back, every leaf bit for bit:
    ``proj/*`` to ``proj.*``, the LM's stacked units under ``lm/`` to
    ``lm.layers.{i}``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jparams = jget_api(jsmoke(ARCH).replace(**kw)).init(jax.random.PRNGKey(0))
    cfg = smoke_config(ARCH).replace(**kw)
    flat = ckpt_flatten(jparams)
    assert {"proj/w1", "proj/w2", "lm/units/l0/mix/bq"} <= set(flat)
    model = vlm.VLM(cfg, torch.device("cpu"))
    model.load_state_dict(params_from_jax(flat, cfg), strict=True)
    back = params_to_jax(model.state_dict(), cfg)
    assert back.keys() == flat.keys()
    for key, want in flat.items():
        assert back[key].shape == want.shape, key
        np.testing.assert_array_equal(_bits(back[key]), _bits(want.astype(back[key].dtype)))
    w = np.asarray(jparams["lm"]["units"]["l0"]["mix"]["wq"], dtype=np.float32)
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(model.lm.layers[i].mix.wq.float().detach().numpy(), w[i])


def test_torch_init_distributions():
    """The projector's weights normal/sqrt(in), the LM's as ``DecoderLM``'s;
    the same seed gives the same weights."""
    cfg = smoke_config(ARCH).replace(vision_dim=1024, d_model=256, d_ff=512, vocab_size=4096)
    api = get_api(cfg, device="cpu")
    a, b = api.init(seed=5), api.init(seed=5)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, atol=0, rtol=0, msg=name)
    assert abs(a.proj.w1.std().item() * cfg.vision_dim ** 0.5 - 1.0) < 0.02
    assert abs(a.proj.w2.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.03
    assert abs(a.lm.embed.tok.std().item() - 0.02) < 1e-3
    assert not a.lm.layers[0].mix.bq.any()
