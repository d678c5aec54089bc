"""The port's model against the JAX model: the weight bridge carries
``api.init(PRNGKey(0))`` params into the port, and train-mode, prefill and
decode logits agree with ``repro.models`` ``apply_lm`` at atol 1e-4 (both
stacks in float32 on the CPU; sums over d_model and d_ff are taken in
another order, the port's attention keeps its probabilities in fp32, the
port's WKV6 steps token by token where JAX scans in chunks, and the port's
Mamba scan doubles where JAX's ``associative_scan`` recurses).  jamba's
hybrid smoke model (one unit: a GQA layer and seven Mamba layers, MoE on
the odd ones) also holds its ``lm_loss`` and gradients, and its weights
through the bridge both ways bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import _flatten as ckpt_flatten  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro.models import make_smoke_batch as jbatch  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_api, make_smoke_batch, smoke_config  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from tests.test_torch_moe import (  # noqa: E402
    check_bridge_round_trip, check_lm_loss, check_lm_loss_gradients)

DENSE = ["gemma-2b", "olmo-1b", "gemma2-9b", "qwen2.5-14b"]
RWKV = "rwkv6-1.6b"
HYBRID = "jamba-1.5-large-398b"
PORTED = DENSE + [RWKV, HYBRID]
ATOL = 1e-4


def _bridged(arch, **replace):
    """(JAX cfg, JAX params, port cfg, port model on the CPU) with one set of
    weights; ``replace`` changes both smoke configs alike."""
    jcfg = jsmoke(arch).replace(**replace)
    jparams = jget_api(jcfg).init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    model = transformer.DecoderLM(cfg, torch.device("cpu"))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    model.load_state_dict(sd, strict=True)
    return jcfg, jparams, cfg, model


def _jax_apply(jcfg, mode):
    """JAX apply_lm jitted once per (cfg, mode), so decode loops compile once."""
    return jax.jit(lambda params, toks, cache: jtransformer.apply_lm(
        params, toks, jcfg, cache=cache, mode=mode))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", RWKV, HYBRID])
def test_bridge_takes_pytree_and_checkpoint_layouts(arch):
    jcfg, jparams, cfg, model = _bridged(arch)
    flat = ckpt_flatten(jparams)
    sd = params_from_jax(flat, cfg)
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].dtype == t.dtype
        torch.testing.assert_close(sd[name], t, atol=0, rtol=0)
    # layer u * len(unit) of the port is unit u, element 0 of the stacked JAX params
    key = "wq" if "wq" in jparams["units"]["l0"]["mix"] else "wr"
    w = np.asarray(jparams["units"]["l0"]["mix"][key])
    unit_len = len(transformer.layer_plan(cfg).unit)
    for u in range(cfg.num_layers // unit_len):
        np.testing.assert_array_equal(
            getattr(model.layers[u * unit_len].mix, key).detach().numpy(), w[u])


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.itemsize == 2 else np.uint32)


def test_bf16_bridge_keeps_rwkv_decay_and_bonus_in_fp32():
    """At param_dtype bfloat16 the JAX initialiser keeps w0 and u in fp32;
    the bridge keeps them so (from the pytree and from the checkpoint
    layout, which stores bf16 as f32), bit for bit, and the rest in bf16."""
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", num_layers=2)
    jcfg = jsmoke(RWKV).replace(**bf16)
    jparams = jget_api(jcfg).init(jax.random.PRNGKey(0))
    cfg = smoke_config(RWKV).replace(**bf16)
    jmix = jax.tree_util.tree_map(np.asarray, jparams["units"]["l0"]["mix"])
    assert jmix["w0"].dtype == np.float32 and jmix["wr"].dtype != np.float32
    for tree in (jax.tree_util.tree_map(np.asarray, jparams), ckpt_flatten(jparams)):
        sd = params_from_jax(tree, cfg)
        for i in range(cfg.num_layers):
            for name in ("w0", "u", "wr", "mu"):
                t = sd[f"layers.{i}.mix.{name}"]
                assert t.dtype == (torch.float32 if name in ("w0", "u") else torch.bfloat16)
                want = jmix[name][i]
                got = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
                np.testing.assert_array_equal(
                    _bits(got if t.dtype == torch.float32 else t.view(torch.int16).numpy()),
                    _bits(want if t.dtype == torch.float32 else want.view(np.int16)))
        model = transformer.DecoderLM(cfg, torch.device("cpu"))
        model.load_state_dict(sd, strict=True)
        assert model.layers[1].mix.u.dtype == torch.float32


def test_bridge_rejects_a_name_the_port_lacks():
    _, jparams, cfg, _ = _bridged("gemma-2b")
    flat = ckpt_flatten(jparams)
    flat["units/l0/mix/w_extra"] = flat["units/l0/mix/wq"]
    with pytest.raises(KeyError, match="w_extra"):
        params_from_jax(flat, cfg)


@pytest.mark.parametrize("arch,replace", [(a, {}) for a in PORTED]
                         + [(RWKV, dict(num_layers=3))])
def test_logits_match_jax(arch, replace):
    jcfg, jparams, cfg, model = _bridged(arch, **replace)
    jb = jbatch(jcfg, batch=2, seq=16)
    tb = make_smoke_batch(cfg, batch=2, seq=16, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))

    jlogits, _, _ = jtransformer.apply_lm(jparams, jb["tokens"], jcfg)
    with torch.no_grad():
        logits, _ = transformer.apply_lm(model, tb["tokens"])
    assert logits.dtype == torch.float32 and logits.shape == (2, 16, cfg.vocab_size)
    _close(logits, jlogits)

    # prefill on the first 12 tokens, then decode the next 4 one at a time
    s_max, s0 = 20, 12
    jcache = jtransformer.init_cache(jcfg, 2, s_max)
    cache = transformer.init_cache(cfg, 2, s_max, "cpu")
    jl, _, jcache = jtransformer.apply_lm(jparams, jb["tokens"][:, :s0], jcfg,
                                          cache=jcache, mode="prefill")
    jdecode = _jax_apply(jcfg, "decode")
    with torch.no_grad():
        tl, cache = transformer.apply_lm(model, tb["tokens"][:, :s0], cache, mode="prefill")
        _close(tl, jl)
        last, _ = transformer.apply_lm(
            model, tb["tokens"][:, :s0], transformer.init_cache(cfg, 2, s_max, "cpu"),
            mode="prefill", last_only=True)
        _close(last, jl[:, -1:])
        for t in range(s0, 16):
            jl, _, jcache = jdecode(jparams, jb["tokens"][:, t:t + 1], jcache)
            tl, cache = transformer.apply_lm(model, tb["tokens"][:, t:t + 1], cache,
                                                mode="decode")
            _close(tl, jl)
    assert cache["pos"] == int(jcache["pos"]) == 16
    # the cache holds what JAX's holds (unit u, element j -> layer u*len(unit)+j)
    unit = transformer.layer_plan(cfg).unit
    for i, entry in enumerate(cache["layers"]):
        jentry = jcache["units"][f"l{i % len(unit)}"]
        assert len(entry) == len(jentry)
        for t, j in zip(entry, jentry):
            _close(t, j[i // len(unit)])


@pytest.mark.parametrize("arch", PORTED)
def test_cache_shapes_match_init_cache(arch):
    cfg = smoke_config(arch)
    jcache = jtransformer.init_cache(jsmoke(arch), 3, 24)
    cache = transformer.init_cache(cfg, 3, 24, "cpu")
    plan = transformer.layer_plan(cfg)
    assert len(cache["layers"]) == cfg.num_layers == plan.n_units * len(plan.unit)
    for i, kv in enumerate(cache["layers"]):
        jkv = jcache["units"][f"l{i % len(plan.unit)}"]
        for t, j in zip(kv, jkv):
            assert tuple(t.shape) == tuple(j.shape[1:])
            assert t.dtype == getattr(torch, str(j.dtype))


def test_decode_past_a_window_masks_old_slots():
    """gemma2-9b smoke has a sliding window of 8: decoding 12 tokens past a
    prompt of 8 must match JAX, which masks slots older than the window."""
    jcfg, jparams, cfg, model = _bridged("gemma2-9b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(1, 20))
    jcache = jtransformer.init_cache(jcfg, 1, 24)
    cache = transformer.init_cache(cfg, 1, 24, "cpu")
    _, _, jcache = jtransformer.apply_lm(jparams, jnp.asarray(toks[:, :8]), jcfg,
                                         cache=jcache, mode="prefill")
    jdecode = _jax_apply(jcfg, "decode")
    with torch.no_grad():
        _, cache = transformer.apply_lm(model, torch.from_numpy(toks[:, :8]), cache,
                                           mode="prefill")
        for t in range(8, 20):
            jl, _, jcache = jdecode(jparams, jnp.asarray(toks[:, t:t + 1]), jcache)
            tl, cache = transformer.apply_lm(model, torch.from_numpy(toks[:, t:t + 1]),
                                                cache, mode="decode")
            _close(tl, jl)


@pytest.mark.parametrize("arch", sorted(configs.ARCH_IDS))
def test_every_arch_serves_on_the_cpu(arch):
    """All 10 archs (whisper and internvl2 with their frames and patches)
    through ``get_api`` and ``ServeEngine.generate`` on the CPU: a prefill
    and 3 decode steps give in-range ids, and a second prefill of the same
    inputs picks the same first tokens."""
    cfg = smoke_config(arch)
    api = get_api(cfg, device="cpu")
    model = api.init(seed=0)
    batch = make_smoke_batch(cfg, batch=2, seq=8, device="cpu")
    del batch["targets"]
    out = ServeEngine(api, model, batch=2, s_max=12).generate(
        {k: v.numpy() for k, v in batch.items()}, 4)
    assert out.shape == (2, 4) and 0 <= out.min() and out.max() < cfg.vocab_size
    with torch.no_grad():
        logits, _ = api.prefill(model, batch, api.init_cache(2, 12), last_only=True)
    assert logits.shape == (2, 1, cfg.vocab_size) and torch.isfinite(logits).all()
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), out[:, 0])


def test_torch_init_distributions():
    """The port's own initialiser: weights normal/sqrt(in), embeddings
    0.02-normal, norm scales one; the same seed gives the same weights."""
    cfg = smoke_config("gemma-2b").replace(d_model=256, d_ff=512, vocab_size=4096)
    api = get_api(cfg, device="cpu")
    a, b = api.init(seed=5), api.init(seed=5)
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, atol=0, rtol=0, msg=name)
    assert abs(a.embed.tok.std().item() - 0.02) < 1e-3
    wi = a.layers[0].ffn.wi
    assert abs(wi.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.02
    assert torch.equal(a.layers[0].ln1.scale, torch.ones(cfg.d_model))
    assert not torch.equal(a.layers[0].ffn.wi, a.layers[1].ffn.wi)


def test_torch_init_distributions_rwkv():
    """The RWKV parameters: token-shift mixes uniform in [0.25, 0.75] (the
    bf16 rounding can reach 0.75), lora
    outputs at scale 0.01, w0 normal(-0.5, 0.5), u normal(0, 0.1),
    ln_scale one; w0 and u in fp32 at a bf16 param dtype."""
    cfg = smoke_config(RWKV).replace(d_model=1024, num_layers=2, param_dtype="bfloat16",
                                     compute_dtype="bfloat16")
    mix = get_api(cfg, device="cpu").init(seed=3).layers[0].mix
    assert 0.25 <= mix.mu.min().item() and mix.mu.max().item() <= 0.75
    assert abs(mix.mu.float().mean().item() - 0.5) < 0.01
    assert abs(mix.ts_b.float().std().item() - 0.01) < 1e-3
    assert abs(mix.w_b.float().std().item() - 0.01) < 1e-3
    assert mix.w0.dtype == mix.u.dtype == torch.float32
    assert abs(mix.w0.mean().item() + 0.5) < 0.05 and abs(mix.w0.std().item() - 0.5) < 0.05
    assert abs(mix.u.mean().item()) < 0.01 and abs(mix.u.std().item() - 0.1) < 0.01
    assert abs(mix.wr.float().std().item() * cfg.d_model ** 0.5 - 1.0) < 0.02
    assert torch.equal(mix.ln_scale, torch.ones(cfg.d_model, dtype=torch.bfloat16))


def test_rwkv_state_is_written_in_place():
    """Prefill and decode update the rwkv cache tensors themselves."""
    cfg = smoke_config(RWKV)
    api = get_api(cfg, device="cpu")
    model = api.init(seed=0)
    cache = api.init_cache(2, 8)
    tensors = [t for entry in cache["layers"] for t in entry]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5)))
    with torch.no_grad():
        _, new = api.prefill(model, {"tokens": toks}, cache)
        assert all(a is b for a, b in zip(tensors, (t for e in new["layers"] for t in e)))
        assert all(t.abs().sum() > 0 for t in tensors)
        before = [t.clone() for t in tensors]
        api.decode(model, (toks[:, -1:] + 1) % cfg.vocab_size, new)
    assert all(not torch.equal(a, b) for a, b in zip(before, tensors))


def test_bf16_rwkv_time_mix_normalises_an_fp32_y(monkeypatch):
    """At compute dtype bfloat16 the time mix asks WKV6 for an fp32 y and
    hands that to the group norm, as the JAX model keeps y fp32 there."""
    seen = []
    wkv6 = ops.wkv6

    def spy(r, *args, **kwargs):
        y, s = wkv6(r, *args, **kwargs)
        seen.append((r.dtype, kwargs.get("out_dtype"), y.dtype))
        return y, s

    monkeypatch.setattr(ops, "wkv6", spy)
    cfg = smoke_config(RWKV).replace(param_dtype="bfloat16", compute_dtype="bfloat16",
                                     num_layers=2)
    api = get_api(cfg, device="cpu")
    model = api.init(seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6)))
    with torch.no_grad():
        logits, cache = api.prefill(model, {"tokens": toks}, api.init_cache(2, 8))
        api.decode(model, toks[:, -1:], cache)
        train, _ = model(toks, mode="train")
    assert seen == [(torch.bfloat16, torch.float32, torch.float32)] * (3 * cfg.num_layers)
    assert torch.isfinite(logits).all() and torch.isfinite(train).all()


def test_jamba_layers_in_the_plan():
    """One unit of jamba: GQA attention at position 0, Mamba at 1..7; a
    dense SwiGLU MLP on the attention layer and MoE on the odd positions."""
    model = get_api(smoke_config(HYBRID), device="cpu").init(seed=0)
    assert [b.kind for b in model.layers] == ["attn"] + ["mamba"] * 7
    assert [b.moe for b in model.layers] == [i % 2 == 1 for i in range(8)]
    assert isinstance(model.layers[1].mix, ssm.Mamba)


def test_jamba_lm_loss_matches_jax():
    check_lm_loss(HYBRID)


def test_jamba_lm_loss_gradients_match_jax():
    check_lm_loss_gradients(HYBRID)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jamba_bridge_round_trips(dtype):
    """JAX -> port -> JAX bit for bit, from the checkpoint's flat layout;
    from the pytree too, with ``A_log`` and ``D`` fp32 (as JAX's
    ``init_mamba`` keeps them) and the rest of the Mamba block in the param
    dtype."""
    check_bridge_round_trip(HYBRID, dtype)
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jparams = jget_api(jsmoke(HYBRID).replace(**kw)).init(jax.random.PRNGKey(0))
    jmix = jax.tree_util.tree_map(np.asarray, jparams["units"]["l1"]["mix"])
    assert jmix["A_log"].dtype == jmix["D"].dtype == np.float32
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                         smoke_config(HYBRID).replace(**kw))
    for name, leaf in jmix.items():
        t = sd[f"layers.1.mix.{name}"]
        fp32 = name in ("A_log", "D")
        assert t.dtype == (torch.float32 if fp32 else getattr(torch, dtype)), name
        got = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
        want = leaf[0] if leaf.dtype == np.float32 else leaf[0].view(np.int16)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)
