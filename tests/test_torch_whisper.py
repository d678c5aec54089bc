"""The port's whisper against the JAX package's, on the CPU in float32.

One set of weights (``api.init(PRNGKey(0))`` of JAX's smoke config: 2
encoder and 2 decoder layers, d_model 64, GQA 4/2, 16 frames) is carried
into the port by the weight bridge, and the inputs are
``make_smoke_batch``'s numpy draws on both sides.  Held at atol 1e-4
(``test_torch_models.py``'s tolerance: sums in another order, the port's
attention keeps its probabilities in fp32): the sinusoid table, the
encoder, the decoder in train, prefill and decode modes with the cache
after every step, the non-causal self-attention and the cross-attention
alone, ``whisper_loss`` and its gradients; the bridge round trip bit for
bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import _flatten as ckpt_flatten  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro.models import make_smoke_batch as jbatch  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.models import get_api, make_smoke_batch, smoke_config, whisper  # noqa: E402
from repro_torch.models.attention import cross_attention, gqa_attention  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

ARCH = "whisper-small"
ATOL = 1e-4


def _bridged(**replace):
    """(JAX cfg, JAX api, JAX params, port cfg, port model on the CPU) with
    one set of weights."""
    jcfg = jsmoke(ARCH).replace(**replace)
    japi = jget_api(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = smoke_config(ARCH).replace(**replace)
    model = whisper.Whisper(cfg, torch.device("cpu"))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg),
                          strict=True)
    return jcfg, japi, jparams, cfg, model


def _batches(jcfg, cfg, seq=16):
    jb = jbatch(jcfg, batch=2, seq=seq)
    tb = make_smoke_batch(cfg, batch=2, seq=seq, device="cpu")
    for key in ("tokens", "targets", "frames"):
        np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    return jb, tb


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _layer(tree, i):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


@pytest.mark.parametrize("seq,dim", [(16, 64), (1500, 768)])
def test_sinusoid_matches_jax(seq, dim):
    got = whisper._sinusoid(seq, dim)
    assert got.dtype == torch.float32 and got.shape == (seq, dim)
    _close(got, jwhisper._sinusoid(seq, dim))


def test_encode_matches_jax():
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    with torch.no_grad():
        got = whisper.encode(model, tb["frames"])
    assert got.shape == (2, cfg.encoder_seq, cfg.d_model)
    _close(got, jwhisper.encode(jparams, jb["frames"], jcfg))


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_attention_matches_jax(causal):
    """The encoder's self-attention (``causal=False``: full attention) and
    the causal default, layer 0's weights, on one random input."""
    jcfg, _, jparams, cfg, model = _bridged()
    x = np.random.default_rng(5).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    want, _ = jattention.gqa_attention(_layer(jparams["enc_layers"]["attn"], 0),
                                       jnp.asarray(x), jcfg, causal=causal)
    with torch.no_grad():
        got = gqa_attention(model.enc_layers[0].attn, torch.from_numpy(x), cfg, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("sq,se", [(16, 16), (5, 24), (1, 24)])
def test_cross_attention_matches_jax(sq, se):
    """Decoder queries over an encoder output of another length: a prefill
    (Sq = 16 or 5) and a decode step (Sq = 1)."""
    jcfg, _, jparams, cfg, model = _bridged()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, sq, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, se, cfg.d_model)).astype(np.float32)
    want = jattention.cross_attention(_layer(jparams["dec_layers"]["xattn"], 1),
                                      jnp.asarray(x), jnp.asarray(enc), jcfg)
    with torch.no_grad():
        got = cross_attention(model.dec_layers[1].xattn, torch.from_numpy(x),
                              torch.from_numpy(enc), cfg)
    assert got.shape == (2, sq, cfg.d_model)
    _close(got, want)


def test_train_logits_match_jax():
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    enc = jwhisper.encode(jparams, jb["frames"], jcfg)
    want, _ = jwhisper.decode(jparams, jb["tokens"], enc, jcfg)
    with torch.no_grad():
        got, cache = model(tb["tokens"], tb["frames"])
        hidden, _ = model(tb["tokens"], tb["frames"], return_hidden=True)
    assert cache is None and got.dtype == torch.float32
    assert got.shape == (2, 16, cfg.vocab_size) and hidden.shape == (2, 16, cfg.d_model)
    _close(got, want)


def _close_cache(cache, jcache):
    assert cache["pos"] == int(jcache["pos"])
    _close(cache["enc"], jcache["enc"])
    jk, jv = jcache["kv"]
    for i, (k, v) in enumerate(cache["layers"]):
        _close(k, jk[i])
        _close(v, jv[i])


def test_prefill_and_decode_match_jax():
    """Prefill 4 tokens through the API, then a 12-step decode loop: the
    logits and the whole cache (KV of every layer, ``enc``, ``pos``) after
    every step."""
    jcfg, japi, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    api = get_api(cfg, device="cpu")
    s_max, s0 = 20, 4
    jcache = japi.init_cache(2, s_max)
    cache = api.init_cache(2, s_max)
    jl, jcache = japi.prefill(jparams, {"tokens": jb["tokens"][:, :s0], "frames": jb["frames"]},
                              jcache)
    jdecode = jax.jit(japi.decode)
    with torch.no_grad():
        tl, cache = api.prefill(model, {"tokens": tb["tokens"][:, :s0], "frames": tb["frames"]},
                                cache)
        _close(tl, jl)
        _close_cache(cache, jcache)
        last, _ = api.prefill(model, {"tokens": tb["tokens"][:, :s0], "frames": tb["frames"]},
                              api.init_cache(2, s_max), last_only=True)
        _close(last, jl[:, -1:])
        for t in range(s0, 16):
            jl, jcache = jdecode(jparams, jb["tokens"][:, t:t + 1], jcache)
            tl, cache = api.decode(model, tb["tokens"][:, t:t + 1], cache)
            assert tl.shape == (2, 1, cfg.vocab_size)
            _close(tl, jl)
            _close_cache(cache, jcache)
    assert cache["pos"] == 16


def test_cache_shapes_match_jax():
    cfg = smoke_config(ARCH)
    jcache = jget_api(jsmoke(ARCH)).init_cache(3, 24)
    cache = get_api(cfg, device="cpu").init_cache(3, 24)
    assert set(cache) == set(jcache) - {"kv"} | {"layers"} and len(cache["layers"]) == 2
    for k, v in cache["layers"]:
        assert k.shape == v.shape == jcache["kv"][0].shape[1:]
    assert cache["enc"].shape == jcache["enc"].shape == (3, cfg.encoder_seq, cfg.d_model)
    assert cache["enc"].dtype == cfg.cdtype


def test_whisper_loss_matches_jax():
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    with torch.no_grad():
        got = whisper.whisper_loss(model, tb)
    np.testing.assert_allclose(got.item(), float(jwhisper.whisper_loss(jparams, jb, jcfg)),
                               atol=1e-5, rtol=0)


def test_whisper_loss_gradients_match_jax():
    """Every parameter's gradient, the encoder's through the
    cross-attention's K and V."""
    jcfg, _, jparams, cfg, model = _bridged()
    jb, tb = _batches(jcfg, cfg)
    want, jgrads = jax.value_and_grad(jwhisper.whisper_loss)(jparams, jb, jcfg)
    loss = whisper.whisper_loss(model, tb)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5, rtol=0)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want_grads) == set(names)
    assert any(n.startswith("enc_layers.") for n in names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=ATOL, rtol=ATOL,
                                   err_msg=name)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips(dtype):
    """JAX's checkpoint layout -> the port -> back, every leaf bit for bit;
    layer i of the port is element i of JAX's stacked ``enc_layers`` and
    ``dec_layers``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jparams = jget_api(jsmoke(ARCH).replace(**kw)).init(jax.random.PRNGKey(0))
    cfg = smoke_config(ARCH).replace(**kw)
    flat = ckpt_flatten(jparams)
    model = whisper.Whisper(cfg, torch.device("cpu"))
    model.load_state_dict(params_from_jax(flat, cfg), strict=True)
    assert model.tok.dtype == getattr(torch, dtype)
    back = params_to_jax(model.state_dict(), cfg)
    assert back.keys() == flat.keys()
    for key, want in flat.items():
        assert back[key].shape == want.shape, key
        np.testing.assert_array_equal(_bits(back[key]), _bits(want.astype(back[key].dtype)))
    w = np.asarray(jparams["dec_layers"]["xattn"]["wk"], dtype=np.float32)
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(model.dec_layers[i].xattn.wk.float().detach().numpy(), w[i])


def test_bridge_rejects_a_stack_of_the_wrong_depth():
    jcfg, _, jparams, cfg, _ = _bridged()
    flat = ckpt_flatten(jparams)
    flat["enc_layers/ln1/scale"] = flat["enc_layers/ln1/scale"][:1]
    with pytest.raises(ValueError, match="enc_layers/ln1/scale"):
        params_from_jax(flat, cfg)


def test_torch_init_distributions():
    """``tok`` and ``pos`` 0.02-normal, weights normal/sqrt(in), LayerNorm
    scale 1 and bias 0; the same seed gives the same weights."""
    cfg = smoke_config(ARCH).replace(d_model=256, d_ff=512, vocab_size=4096,
                                     max_target_positions=512)
    api = get_api(cfg, device="cpu")
    a, b = api.init(seed=5), api.init(seed=5)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, atol=0, rtol=0, msg=name)
    assert abs(a.tok.std().item() - 0.02) < 1e-3 and abs(a.pos.std().item() - 0.02) < 1e-3
    for w in (a.enc_layers[0].attn.wq, a.dec_layers[1].xattn.wk, a.dec_layers[0].ffn.wi):
        assert abs(w.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.03
    ln = a.dec_layers[0].lnx
    assert torch.equal(ln.scale, torch.ones(cfg.d_model))
    assert torch.equal(ln.bias, torch.zeros(cfg.d_model))
    assert not torch.equal(a.enc_layers[0].attn.wq, a.enc_layers[1].attn.wq)


def test_decoder_lm_refuses_the_audio_family():
    with pytest.raises(ValueError, match="whisper"):
        DecoderLM(smoke_config(ARCH), torch.device("cpu"))
