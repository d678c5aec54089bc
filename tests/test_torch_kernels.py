"""The port's plain kernel versions against the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode, and the
CPU dispatch of ``repro_torch.kernels.ops``.

Inputs are drawn with numpy from a fixed seed and fed to both stacks.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 in float32 (both
sides reduce in fp32, in another order) and 2e-2 in bfloat16 (both round
the fp32 result to bf16, so they may differ by one bf16 step); WKV6 2e-4
(1e-4 under extreme decay), as the JAX tests hold the Pallas kernel.  The
kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as pallas_flash  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rmsnorm as pallas_rmsnorm  # noqa: E402
from repro.kernels import wkv6 as pallas_wkv6  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref, rmsnorm, wkv6  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_SHAPES = [  # (B, Hq, Hkv, Sq, Sk, D)
    (1, 1, 1, 128, 128, 64),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 256, 128),  # MQA, cross lengths
    (1, 2, 2, 100, 100, 32),  # non-divisible seq
    (1, 8, 1, 128, 128, 256),  # gemma-2b: MQA, head_dim 256
]
FLASH_VARIANTS = [
    dict(causal=False),
    dict(causal=True, window=64),
    dict(causal=True, softcap=30.0),
    dict(causal=True, window=32, softcap=50.0),
]


def _pair(rng, shape, dtype):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(
        t_out.float().numpy(), np.asarray(j_out, np.float32), atol=tol, rtol=tol
    )


def _qkv(rng, B, Hq, Hkv, Sq, Sk, D, dtype):
    return [_pair(rng, s, dtype) for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_matches_jax_oracle(rng, dtype, shape):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, *shape, dtype)
    _close(ref.mha_reference(tq, tk, tv), jref.mha_reference(jq, jk, jv), TOL[dtype])


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_matches_pallas_interpret(rng, shape):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, *shape, "float32")
    want = pallas_flash(jq, jk, jv, causal=True, interpret=True, block_q=64, block_k=64)
    _close(flash_attention(tq, tk, tv, causal=True), want, TOL["float32"])


@pytest.mark.parametrize("kw", FLASH_VARIANTS)
def test_flash_variants_match_oracle_and_pallas(rng, kw):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(rng, 1, 4, 2, 256, 256, 64, "float32")
    got = flash_attention(tq, tk, tv, **kw)
    _close(got, jref.mha_reference(jq, jk, jv, **kw), 2e-5)
    _close(got, pallas_flash(jq, jk, jv, interpret=True, block_q=64, block_k=64, **kw), 2e-5)


RMS_SHAPES = [(8, 256), (3, 5, 512), (64, 128), (7, 896), (5, 3584)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_plain_matches_oracle_and_pallas(rng, dtype, shape):
    jx, tx = _pair(rng, shape, dtype)
    js, ts = _pair(rng, shape[-1:], dtype)
    got = rmsnorm(tx, ts)
    _close(got, jref.rmsnorm_reference(jx, js), TOL[dtype])
    _close(got, pallas_rmsnorm(jx, js, interpret=True, block_rows=16), TOL[dtype])


def _wkv6_inputs(rng, B, H, T, K, dtype="float32", log_w=None, s0=True):
    """r, k, v, log_w, u, s0 as test_kernels.py draws them: (jax, torch) pairs."""
    r, k, v = (_pair(rng, (B, H, T, K), dtype) for _ in range(3))
    lw = (-np.exp(rng.normal(size=(B, H, T, K))) if log_w is None
          else np.full((B, H, T, K), log_w)).astype(np.float32)
    u = _pair(rng, (H, K), "float32")
    s = _pair(rng, (B, H, K, K), "float32") if s0 else (
        jnp.zeros((B, H, K, K)), torch.zeros(B, H, K, K))
    return [r, k, v, (jnp.asarray(lw), torch.from_numpy(lw)), u, s]


# (T, Pallas chunk, K); T = 2 and 31 at K = 64 are lengths of the token loop
WKV6_PLAIN = [(64, 16, 16), (96, 32, 16), (50, 32, 16), (16, 64, 16), (1, 32, 16),
              (2, 32, 64), (31, 32, 64)]


@pytest.mark.parametrize("T,chunk,K", WKV6_PLAIN,
                         ids=[f"{T}-{c}" + (f"-K{K}" if K != 16 else "") for T, c, K in WKV6_PLAIN])
def test_wkv6_plain_matches_oracle_and_pallas(rng, T, chunk, K):
    pairs = _wkv6_inputs(rng, 2, 3, T, K)
    jin, tin = [p[0] for p in pairs], [p[1] for p in pairs]
    y, sf = wkv6(*tin)
    assert y.shape == (2, 3, T, K) and sf.dtype == torch.float32
    for want_y, want_s in (jref.wkv6_reference(*jin),
                           pallas_wkv6(*jin, chunk=chunk, interpret=True)):
        _close(y, want_y, 2e-4)
        _close(sf, want_s, 2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [16, 64])
def test_wkv6_wrapper_updates_the_state_in_place(rng, K, dtype):
    """The model's decode call (T = 1, s_out = s0, fp32 y): the wrapper
    writes the final state over s0 and returns it, equal to the JAX oracle
    and the Pallas kernel on the same (fp32) inputs."""
    pairs = _wkv6_inputs(rng, 4, 3, 1, K, dtype=dtype)
    jin = [p[0].astype(jnp.float32) for p in pairs]
    wants = [jref.wkv6_reference(*jin), pallas_wkv6(*jin, chunk=32, interpret=True)]
    tin = [p[1] for p in pairs]
    s0 = tin[5] = tin[5].clone()  # the JAX array may share the numpy buffer of tin[5]
    y, sf = wkv6(*tin, s_out=s0, out_dtype=torch.float32)
    assert sf is s0 and y.dtype == torch.float32
    for want_y, want_s in wants:
        _close(y, want_y, 2e-4)
        _close(s0, want_s, 2e-4)


def test_wkv6_plain_extreme_decay(rng):
    """log_w = -50 (decay ~ e^-50): finite, and equal to the oracle and the
    Pallas kernel within 1e-4."""
    pairs = _wkv6_inputs(rng, 1, 1, 32, 8, log_w=-50.0, s0=False)
    jin, tin = [p[0] for p in pairs], [p[1] for p in pairs]
    y, sf = wkv6(*tin)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    for want_y, _ in (jref.wkv6_reference(*jin), pallas_wkv6(*jin, chunk=16, interpret=True)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4)


def test_wkv6_plain_bf16_matches_oracle(rng):
    pairs = _wkv6_inputs(rng, 2, 2, 40, 32, dtype="bfloat16")
    y, sf = wkv6(*[p[1] for p in pairs])
    want_y, want_s = jref.wkv6_reference(*[p[0] for p in pairs])
    assert y.dtype == torch.bfloat16
    _close(y, want_y, TOL["bfloat16"])
    _close(sf, want_s, 2e-4)


def test_wkv6_plain_bf16_inputs_fp32_out_matches_oracle(rng):
    """out_dtype=float32: bf16 r/k/v give the fp32 y that the oracle (and the
    JAX model's chunked scan) computes from the same values in fp32."""
    pairs = _wkv6_inputs(rng, 2, 2, 40, 32, dtype="bfloat16")
    y, sf = wkv6(*[p[1] for p in pairs], out_dtype=torch.float32)
    jin = [p[0].astype(jnp.float32) for p in pairs]
    want_y, want_s = jref.wkv6_reference(*jin)
    assert y.dtype == torch.float32 and sf.dtype == torch.float32
    _close(y, want_y, 1e-4)
    _close(sf, want_s, 1e-4)
    y_ops, _ = ops.wkv6(*(p[1].transpose(1, 2) for p in pairs[:4]), pairs[4][1], pairs[5][1],
                        out_dtype=torch.float32)
    assert y_ops.dtype == torch.float32
    torch.testing.assert_close(y_ops.transpose(1, 2), y, atol=0, rtol=0)
    with pytest.raises(TypeError):
        wkv6(*[p[1] for p in pairs], out_dtype=torch.float16)


def test_ops_cpu_tensors_take_the_plain_path(rng):
    """ops.* take model layout (B, S, H, D), agree with the oracle, and on
    CPU tensors launch no kernel."""
    flash_attention.launches = rmsnorm.launches = wkv6.launches = 0
    (jq, tq), (jk, tk) = _pair(rng, (2, 64, 4, 32), "float32"), _pair(rng, (2, 64, 2, 32), "float32")
    got = ops.attention(tq, tk, tk, window=16)
    want = jnp.swapaxes(jref.mha_reference(*(jnp.swapaxes(a, 1, 2) for a in (jq, jk, jk)),
                                           window=16), 1, 2)
    assert got.shape == (2, 64, 4, 32)
    _close(got, want, 2e-5)

    (jx, tx), (js, ts) = _pair(rng, (4, 16, 128), "float32"), _pair(rng, (128,), "float32")
    _close(ops.rmsnorm(tx, ts), jref.rmsnorm_reference(jx, js), 2e-5)

    # WKV6 in model layout (B, S, H, K); the final state written over s0
    # (a copy: JAX on the CPU may share the numpy buffer that s0 was made from)
    pairs = _wkv6_inputs(rng, 2, 4, 24, 16)
    (jr, tr), (jk, tk), (jv, tv), (jw, tw), (ju, tu), (js0, ts0) = [
        (jnp.swapaxes(j, 1, 2), t.transpose(1, 2).contiguous()) if i < 4 else (j, t.clone())
        for i, (j, t) in enumerate(pairs)]
    y, sf = ops.wkv6(tr, tk, tv, tw, tu, ts0, s_out=ts0)
    want_y, want_s = jref.wkv6_reference(*(jnp.swapaxes(a, 1, 2) for a in (jr, jk, jv, jw)),
                                         ju, js0)
    assert y.shape == (2, 24, 4, 16) and sf is ts0
    _close(y, jnp.swapaxes(want_y, 1, 2), 2e-4)
    _close(ts0, want_s, 2e-4)
    assert flash_attention.launches == rmsnorm.launches == wkv6.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))  # 4 % 3 heads
    with pytest.raises(ValueError):
        flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(2, 8), torch.zeros(4))
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))

    r, u, s0 = torch.zeros(1, 2, 4, 8), torch.zeros(2, 8), torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError):
        wkv6(r, r, r, r, torch.zeros(3, 8), s0)  # u of the wrong heads
    with pytest.raises(ValueError):
        wkv6(r, r, r, r, u, torch.zeros(1, 2, 8, 4))  # state not (K, V)
    with pytest.raises(TypeError):
        wkv6(r, r, r, r.double(), u, s0)  # log_w must be float32
    with pytest.raises(ValueError):
        wkv6(r, r, r, r, u, s0.to("meta"))  # mixed devices
    with pytest.raises(ValueError):
        wkv6(*(t.to("meta") for t in (r, r, r, r, u, s0)))
