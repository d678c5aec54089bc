"""The port's MoE FFN against the JAX package's on the CPU: ``moe_mlp`` for
both routers, every GLU kind, with and without a shared expert, and at
capacities small enough to drop tokens, with the expert indices and the
dispatch table held equal exactly and y and the auxiliary loss at fp32
``ATOL``; the stacked expert initialiser; and grok-1's whole smoke model
(GQA with softcap + MoE on every layer): logits in every mode, greedy
tokens, ``lm_loss`` with its 0.01 x aux term and every parameter's
gradient, the weight bridge both ways
through the checkpoint's flat layout, and ``comm_profile``.  Weights come
from the JAX initialisers through the bridge; inputs are drawn with numpy
from a fixed seed and handed to both stacks."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import _flatten as ckpt_flatten  # noqa: E402
from repro.dist.demand import kv_bytes_per_token  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro.models import make_smoke_batch as jbatch  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import get_api, make_smoke_batch, moe, smoke_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.models.layers import cross_entropy_fused  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ATOL = 1e-4
MOE_ARCHS = ["grok-1-314b", "deepseek-v3-671b"]


def _moe_pair(router="softmax", mlp_kind="swiglu", num_shared=0, **moe_kw):
    """(JAX cfg, JAX params, port cfg, port MoE) of one MoE FFN with one set
    of weights (JAX's ``init_moe``, through the port's parameter names)."""
    def cfg_of(base):
        m = dataclasses.replace(base.moe, router=router, num_shared=num_shared, **moe_kw)
        return base.replace(moe=m, mlp_kind=mlp_kind)

    jcfg, cfg = cfg_of(jsmoke("deepseek-v3-671b")), cfg_of(smoke_config("deepseek-v3-671b"))
    jparams = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    mod = moe.MoE(cfg, torch.device("cpu"))
    sd = {k.replace("/", "."): torch.from_numpy(np.array(v))
          for k, v in ckpt_flatten(jparams).items()}
    mod.load_state_dict(sd, strict=True)
    return jcfg, jparams, cfg, mod


def _jax_moe(jparams, x, jcfg, capacity, monkeypatch):
    """JAX's moe_mlp, with its top-k result and its experts' gathered input
    captured on the way."""
    seen = {}
    top_k, expert_ffn = jax.lax.top_k, jmoe._expert_ffn

    def spy_top_k(scores, k):
        seen["gates"], seen["idx"] = top_k(scores, k)
        return seen["gates"], seen["idx"]

    def spy_ffn(p, xin, cfg):
        seen["xin"] = np.asarray(xin)
        return expert_ffn(p, xin, cfg)

    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jmoe, "_expert_ffn", spy_ffn)
    y, aux = jmoe.moe_mlp(jparams, jnp.asarray(x), jcfg, capacity=capacity)
    monkeypatch.undo()
    return np.asarray(y), float(aux), seen


def _dispatch_of(xin: np.ndarray, xt: np.ndarray) -> np.ndarray:
    """The token index behind each row of a gathered (E, C, d) input: row t
    of xt, or T for the zero pad row (the rows of xt are distinct)."""
    T = xt.shape[0]
    rows = {r.tobytes(): t for t, r in enumerate(xt)}
    rows[np.zeros_like(xt[0]).tobytes()] = T
    return np.vectorize(lambda i: rows[xin.reshape(-1, xt.shape[1])[i].tobytes()])(
        np.arange(xin.shape[0] * xin.shape[1])).reshape(xin.shape[:2])


@pytest.mark.parametrize("capacity", [None, 3, 1])
@pytest.mark.parametrize("num_shared", [0, 1])
@pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_mlp_matches_jax(router, mlp_kind, num_shared, capacity, monkeypatch):
    jcfg, jparams, cfg, mod = _moe_pair(router, mlp_kind, num_shared)
    x = np.random.default_rng(7).normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    want_y, want_aux, seen = _jax_moe(jparams, x, jcfg, capacity, monkeypatch)
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model))
    with torch.no_grad():
        r = moe.route(mod, xt, cfg, capacity)
        y, aux = moe.moe_mlp(mod, torch.from_numpy(x), cfg, capacity)

    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(seen["idx"]))
    raw = np.asarray(seen["gates"])
    np.testing.assert_allclose(r.gate_vals.numpy(),
                               raw / np.maximum(raw.sum(-1, keepdims=True), 1e-9),
                               atol=1e-6, rtol=0)
    want_dispatch = _dispatch_of(seen["xin"], x.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(r.dispatch.numpy(), want_dispatch)
    T, k = xt.shape[0], cfg.moe.top_k
    E, C = r.dispatch.shape
    dropped = int((r.slot == E * C).sum())
    # every kept pick sits in its slot, and the capacity decides the drops
    kept = r.slot[r.slot < E * C]
    assert int((r.dispatch.reshape(-1)[kept] < T).sum()) == T * k - dropped
    if capacity == 1:
        assert dropped > 0
    if capacity is None:
        assert C == int(np.ceil(T * k / E * cfg.moe.capacity_factor))
    np.testing.assert_allclose(y.numpy(), want_y, atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), want_aux, atol=1e-5, rtol=0)


def test_decode_capacity_drops_the_later_token(monkeypatch):
    """At deepseek-v3's decode, 4 tokens give each expert C = ceil(4 x 8 / 256
    x 1.25) = 1 slot: of two tokens that pick one expert, the first keeps it
    and the second's pick is dropped, as in JAX."""
    jcfg, jparams, cfg, mod = _moe_pair("sigmoid", num_experts=4, top_k=2)
    x = np.random.default_rng(1).normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    x[1] = x[0] + 1e-3  # token 1 picks token 0's experts
    want_y, _, seen = _jax_moe(jparams, x, jcfg, 1, monkeypatch)
    with torch.no_grad():
        r = moe.route(mod, torch.from_numpy(x.reshape(2, -1)), cfg, 1)
        y, _ = moe.moe_mlp(mod, torch.from_numpy(x), cfg, 1)
    assert r.expert_idx[0].tolist() == r.expert_idx[1].tolist()
    assert r.dispatch.shape == (4, 1)
    assert (r.dispatch[r.expert_idx[0], 0] == 0).all()  # token 0 holds both slots
    assert (r.slot[1] == 4).all()  # token 1's picks dropped: its MoE output is zero
    np.testing.assert_array_equal(r.dispatch.numpy(),
                                  _dispatch_of(seen["xin"], x.reshape(2, -1)))
    assert float(y[1].abs().max()) == 0.0
    np.testing.assert_allclose(y.numpy(), want_y, atol=ATOL, rtol=0)


def test_stacked_expert_init():
    """Expert stacks: normal x 1/sqrt(in) per expert with the fan-in from the
    second axis, every expert drawn apart; the router fp32 at a bf16 param
    dtype, as JAX's ``init_moe`` makes it."""
    cfg = smoke_config("deepseek-v3-671b").replace(d_model=512, param_dtype="bfloat16",
                                                   compute_dtype="bfloat16")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=8, d_expert=256))
    mod = moe.MoE(cfg, torch.device("cpu"))
    mod.reset_parameters(torch.Generator().manual_seed(0))
    assert mod.router.dtype == torch.float32 and mod.wi.dtype == torch.bfloat16
    for w, fan_in in ((mod.wi, 512), (mod.wg, 512), (mod.wo, 256)):
        for e in range(w.shape[0]):
            assert abs(w[e].float().std().item() * fan_in ** 0.5 - 1.0) < 0.03
        assert not torch.equal(w[0], w[1])
    assert abs(mod.router.std().item() * 512 ** 0.5 - 1.0) < 0.03


# ---------------------------------------------------------------------------
# whole MoE models (grok-1 here; deepseek-v3 in test_torch_mla.py)
# ---------------------------------------------------------------------------

def _bridged(arch, **replace):
    jcfg = jsmoke(arch).replace(**replace)
    jparams = jget_api(jcfg).init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**replace)
    model = transformer.DecoderLM(cfg, torch.device("cpu"))
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg),
                          strict=True)
    return jcfg, jparams, cfg, model


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL, rtol=0)


def _jcache_entry(jcache, plan, i):
    """Layer i's entry of JAX's cache (prologue layer or unit element)."""
    n_pro = len(plan.prologue)
    if i < n_pro:
        return [t[i] for t in jcache["pro"]]
    u, j = divmod(i - n_pro, len(plan.unit))
    return [t[u] for t in jcache["units"][f"l{j}"]]


def check_logits_and_cache(arch):
    """Train-mode logits and aux, then a prefill of 12 tokens and 4 decode
    steps, against JAX; the cache as JAX writes it."""
    jcfg, jparams, cfg, model = _bridged(arch)
    jb = jbatch(jcfg, batch=2, seq=16)
    tb = make_smoke_batch(cfg, batch=2, seq=16, device="cpu")
    jlogits, jaux, _ = jtransformer.apply_lm(jparams, jb["tokens"], jcfg)
    with torch.no_grad():
        logits, aux, _ = transformer.apply_lm(model, tb["tokens"], return_aux=True)
        _close(logits, jlogits)
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=0)
        assert float(aux) > 0

        s_max, s0 = 20, 12
        jcache = jtransformer.init_cache(jcfg, 2, s_max)
        cache = transformer.init_cache(cfg, 2, s_max, "cpu")
        jl, _, jcache = jtransformer.apply_lm(jparams, jb["tokens"][:, :s0], jcfg,
                                              cache=jcache, mode="prefill")
        tl, cache = transformer.apply_lm(model, tb["tokens"][:, :s0], cache, mode="prefill")
        _close(tl, jl)
        jdecode = jax.jit(lambda p, t, c: jtransformer.apply_lm(p, t, jcfg, cache=c,
                                                                mode="decode"))
        for t in range(s0, 16):
            jl, _, jcache = jdecode(jparams, jb["tokens"][:, t:t + 1], jcache)
            tl, cache = transformer.apply_lm(model, tb["tokens"][:, t:t + 1], cache,
                                             mode="decode")
            _close(tl, jl)
    assert cache["pos"] == int(jcache["pos"]) == 16
    plan = transformer.layer_plan(cfg)
    for i, entry in enumerate(cache["layers"]):
        jentry = _jcache_entry(jcache, plan, i)
        assert len(entry) == len(jentry)
        for t, j in zip(entry, jentry):
            assert tuple(t.shape) == tuple(j.shape)
            _close(t, j)


def check_lm_loss(arch):
    jcfg, jparams, cfg, model = _bridged(arch)
    jb = jbatch(jcfg, batch=2, seq=16)
    tb = make_smoke_batch(cfg, batch=2, seq=16, device="cpu")
    want = float(jtransformer.lm_loss(jparams, jb, jcfg))
    _, jaux, _ = jtransformer.apply_lm(jparams, jb["tokens"], jcfg)
    with torch.no_grad():
        got = float(transformer.lm_loss(model, tb))
        h, _ = model(tb["tokens"], return_hidden=True)
        nll = float(cross_entropy_fused(h, model.embed, tb["targets"]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the aux term is in it: 0.01 x aux above the NLL alone
    np.testing.assert_allclose(got - nll, 0.01 * float(jaux), atol=1e-5, rtol=0)
    assert 0.01 * float(jaux) > 1e-3


def check_lm_loss_gradients(arch):
    """Every parameter's gradient of ``lm_loss`` (aux term included) against
    ``jax.value_and_grad``: the router's through the gates and the aux
    loss, the experts' through the gather and the combine."""
    jcfg, jparams, cfg, model = _bridged(arch)
    jb = jbatch(jcfg, batch=2, seq=16)
    tb = make_smoke_batch(cfg, batch=2, seq=16, device="cpu")
    want, jgrads = jax.value_and_grad(jtransformer.lm_loss)(jparams, jb, jcfg)
    loss = transformer.lm_loss(model, tb)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(want), atol=1e-5, rtol=0)
    want_grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg)
    assert set(want_grads) == set(names)
    assert any(n.endswith("ffn.router") for n in names)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=ATOL, rtol=ATOL,
                                   err_msg=name)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


def check_bridge_round_trip(arch, dtype):
    """JAX's checkpoint layout -> the port -> back: every leaf bit for bit,
    the prologue under ``pro/``, the router fp32 at a bf16 param dtype."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = jsmoke(arch).replace(**kw)
    jparams = jget_api(jcfg).init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**kw)
    flat = ckpt_flatten(jparams)
    sd = params_from_jax(flat, cfg)
    model = transformer.DecoderLM(cfg, torch.device("cpu"))
    model.load_state_dict(sd, strict=True)
    back = params_to_jax(model.state_dict(), cfg)
    assert back.keys() == flat.keys()
    for key, want in flat.items():
        assert back[key].shape == want.shape, key
        np.testing.assert_array_equal(_bits(back[key]), _bits(want.astype(back[key].dtype)))
    plan = transformer.layer_plan(cfg)
    assert any(k.startswith("pro/") for k in flat) == bool(plan.prologue)
    for i, layer in enumerate(model.layers):
        if layer.moe:
            assert layer.ffn.router.dtype == torch.float32
            assert layer.ffn.wi.dtype == getattr(torch, dtype)
    routers = [k for k in flat if k.endswith("/router")]
    assert routers and all(jparams_leaf.dtype == np.float32
                           for jparams_leaf in (flat[k] for k in routers))


def check_greedy_tokens(arch):
    jcfg = jsmoke(arch)
    japi = jget_api(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    want = JServeEngine(japi, jparams, batch=2, s_max=26).generate(
        {"tokens": prompts}, max_new_tokens=8)
    cfg = smoke_config(arch)
    api = get_api(cfg, device="cpu")
    model = api.init()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg))
    got = ServeEngine(api, model, batch=2, s_max=26).generate({"tokens": prompts},
                                                               max_new_tokens=8)
    np.testing.assert_array_equal(got, want)


def check_comm_profile(arch, dtype):
    cfg = smoke_config(arch).replace(compute_dtype=dtype)
    prof = ServeEngine(get_api(cfg, device="cpu"), None, batch=2, s_max=32).comm_profile()
    jcfg = jsmoke(arch).replace(compute_dtype=dtype)
    assert prof["kv_bytes_per_token"] == kv_bytes_per_token(jcfg) > 0
    assert prof["fixed_state_bytes"] == 0.0
    itemsize = np.dtype(np.float32).itemsize if dtype == "float32" else 2
    if cfg.attn_kind == "mla":
        want = cfg.num_layers * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * itemsize
    else:
        want = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * itemsize
    assert prof["kv_bytes_per_token"] == want


ARCH = "grok-1-314b"


def test_grok_logits_match_jax():
    check_logits_and_cache(ARCH)


def test_grok_lm_loss_matches_jax():
    check_lm_loss(ARCH)


def test_grok_lm_loss_gradients_match_jax():
    check_lm_loss_gradients(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grok_bridge_round_trips(dtype):
    check_bridge_round_trip(ARCH, dtype)


def test_grok_greedy_tokens_equal_jax():
    check_greedy_tokens(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grok_comm_profile(dtype):
    check_comm_profile(ARCH, dtype)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cli_runs_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "tok/s" in out


def test_moe_layers_in_the_plan():
    """grok-1: MoE on every layer, GQA; deepseek-v3's smoke: one dense MLA
    prologue layer at the dense d_ff, then MoE layers."""
    grok = transformer.DecoderLM(smoke_config(ARCH), torch.device("meta"))
    assert all(isinstance(b.ffn, moe.MoE) for b in grok.layers)
    ds_cfg = smoke_config("deepseek-v3-671b")
    ds = transformer.DecoderLM(ds_cfg, torch.device("meta"))
    assert [isinstance(b.ffn, moe.MoE) for b in ds.layers] == [False, True, True, True, True]
    assert ds.layers[0].ffn.wi.shape == (ds_cfg.d_model, ds_cfg.d_ff)
    assert hasattr(ds.layers[1].ffn, "shared") and not hasattr(grok.layers[0].ffn, "shared")
