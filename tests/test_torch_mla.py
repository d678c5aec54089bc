"""The port's MLA attention against the JAX package's on the CPU: the
expanded form in train and prefill modes, the absorbed decode over the
compressed cache (written as JAX writes it), the chunked causal attention
against JAX's ``sdpa_chunked`` on its scanned path, and the kv_norm input
handed to the RMSNorm kernel whole (contiguous); then deepseek-v3's whole
smoke model (one dense MLA prologue layer, four MLA + MoE layers): logits
in every mode, greedy tokens, ``lm_loss`` with its 0.01 x aux term and
every parameter's gradient, the weight bridge both ways through the
checkpoint's flat layout with the prologue under ``pro/``, and
``comm_profile`` against the simulator's formula, L (R + Dr) bytes per
token.  fp32 ``ATOL`` 1e-4 as in
``tests/test_torch_models.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import _flatten as ckpt_flatten  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention, smoke_config  # noqa: E402
from tests.test_torch_moe import (  # noqa: E402
    check_bridge_round_trip, check_comm_profile, check_greedy_tokens,
    check_lm_loss, check_lm_loss_gradients, check_logits_and_cache)

ATOL = 1e-4
ARCH = "deepseek-v3-671b"


def _mla_pair(seed=0):
    """(JAX cfg, JAX params, port cfg, port MLAAttention) with one set of
    weights from JAX's ``init_mla``."""
    jcfg, cfg = jsmoke(ARCH), smoke_config(ARCH)
    jparams = jattention.init_mla(jax.random.PRNGKey(seed), jcfg)
    mod = attention.MLAAttention(cfg, torch.device("cpu"))
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(v))
                         for k, v in ckpt_flatten(jparams).items()}, strict=True)
    return jcfg, jparams, cfg, mod


def _x(cfg, S, seed=5):
    return np.random.default_rng(seed).normal(size=(2, S, cfg.d_model)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL, rtol=0)


def _cache(cfg, B, s_max):
    m = cfg.mla
    return (np.zeros((B, s_max, m.kv_lora_rank), np.float32),
            np.zeros((B, s_max, m.qk_rope_head_dim), np.float32))


@pytest.mark.parametrize("S", [1, 7, 16])
def test_mla_train_matches_jax(S):
    jcfg, jparams, cfg, mod = _mla_pair()
    x = _x(cfg, S)
    want, none = jattention.mla_attention(jparams, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = attention.mla_attention(mod, torch.from_numpy(x), cfg)
    assert none is None and got.shape == (2, S, cfg.d_model)
    _close(got, want)


def test_mla_prefill_writes_the_cache_as_jax():
    jcfg, jparams, cfg, mod = _mla_pair()
    x = _x(cfg, 12)
    jc = tuple(jnp.asarray(a) for a in _cache(cfg, 2, 20))
    want, (jcc, jcr) = jattention.mla_attention(jparams, jnp.asarray(x), jcfg, cache=jc)
    cache = tuple(torch.from_numpy(a) for a in _cache(cfg, 2, 20))
    with torch.no_grad():
        got = attention.mla_attention(mod, torch.from_numpy(x), cfg, cache=cache)
    _close(got, want)
    _close(cache[0], jcc)
    _close(cache[1], jcr)
    assert float(cache[0][:, 12:].abs().max()) == 0.0  # slots past the prompt untouched


def test_mla_decode_matches_jax():
    """Prefill 8 tokens, then decode 8 one at a time through the absorbed
    form: y and both cache tensors against JAX after every step."""
    jcfg, jparams, cfg, mod = _mla_pair(seed=2)
    x = _x(cfg, 16, seed=9)
    jc = tuple(jnp.asarray(a) for a in _cache(cfg, 2, 20))
    cache = tuple(torch.from_numpy(a) for a in _cache(cfg, 2, 20))
    _, jc = jattention.mla_attention(jparams, jnp.asarray(x[:, :8]), jcfg, cache=jc)
    jstep = jax.jit(lambda p, xx, c, pos: jattention.mla_attention(p, xx, jcfg, cache=c, pos=pos))
    with torch.no_grad():
        attention.mla_attention(mod, torch.from_numpy(x[:, :8]), cfg, cache=cache)
        for t in range(8, 16):
            want, jc = jstep(jparams, jnp.asarray(x[:, t:t + 1]), jc, jnp.int32(t))
            got = attention.mla_attention(mod, torch.from_numpy(x[:, t:t + 1]), cfg,
                                          cache=cache, pos=t)
            _close(got, want)
            _close(cache[0], jc[0])
            _close(cache[1], jc[1])


def test_mla_decode_equals_the_expanded_form():
    """The absorbed decode step gives the expanded form's last row (the same
    attention in another order of products)."""
    _, _, cfg, mod = _mla_pair(seed=4)
    x = torch.from_numpy(_x(cfg, 10, seed=4))
    cache = tuple(torch.from_numpy(a) for a in _cache(cfg, 2, 10))
    with torch.no_grad():
        full = attention.mla_attention(mod, x, cfg)
        attention.mla_attention(mod, x[:, :9], cfg, cache=cache)
        step = attention.mla_attention(mod, x[:, 9:], cfg, cache=cache, pos=9)
    _close(step, full[:, 9:].numpy())


def test_sdpa_chunked_matches_jax_scan():
    """Query blocks of 16 over S = 48: JAX's ``sdpa_chunked`` takes its
    scanned path there (S > 2 x chunk); both equal one block of all rows."""
    rng = np.random.default_rng(0)
    B, S, H, Dq, Dv = 2, 48, 3, 24, 16
    q, k = (rng.normal(size=(B, S, H, Dq)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, S, H, Dv)).astype(np.float32)
    scale = Dq ** -0.5
    want = jattention.sdpa_chunked(
        jnp.asarray(q)[:, :, :, None, :], jnp.asarray(k), jnp.asarray(v), jnp.arange(S),
        jnp.arange(S), scale=scale, window=jattention.BIG_WINDOW, cap=None, valid=None,
        causal=True, chunk=16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention._sdpa_chunked(tq, tk, tv, scale, chunk=16)
    _close(got, np.asarray(want).reshape(B, S, H, Dv))
    _close(attention._sdpa_chunked(tq, tk, tv, scale, chunk=S), np.asarray(got))


def test_kv_norm_gets_contiguous_rows(monkeypatch):
    """c_kv is a last-axis slice of dkv (rows R + Dr wide); the RMSNorm
    kernel takes contiguous rows only, so MLA hands it a contiguous copy.
    Every RMSNorm input of the layer, in every mode, is contiguous."""
    _, _, cfg, mod = _mla_pair()
    seen = []
    rmsnorm = ops.rmsnorm

    def spy(x, scale, **kw):
        seen.append((x.shape[-1], x.is_contiguous()))
        return rmsnorm(x, scale, **kw)

    monkeypatch.setattr(ops, "rmsnorm", spy)
    x = torch.from_numpy(_x(cfg, 6))
    cache = tuple(torch.from_numpy(a) for a in _cache(cfg, 2, 8))
    with torch.no_grad():
        attention.mla_attention(mod, x, cfg)
        attention.mla_attention(mod, x, cfg, cache=cache)
        attention.mla_attention(mod, x[:, :1], cfg, cache=cache, pos=6)
    m = cfg.mla
    assert seen == [(m.q_lora_rank, True), (m.kv_lora_rank, True)] * 3


# ---------------------------------------------------------------------------
# deepseek-v3's whole smoke model
# ---------------------------------------------------------------------------

def test_deepseek_logits_match_jax():
    check_logits_and_cache(ARCH)


def test_deepseek_lm_loss_matches_jax():
    check_lm_loss(ARCH)


def test_deepseek_lm_loss_gradients_match_jax():
    check_lm_loss_gradients(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_bridge_round_trips(dtype):
    check_bridge_round_trip(ARCH, dtype)


def test_deepseek_greedy_tokens_equal_jax():
    check_greedy_tokens(ARCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_comm_profile(dtype):
    check_comm_profile(ARCH, dtype)
