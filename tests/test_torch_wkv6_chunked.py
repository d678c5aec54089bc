"""The chunked WKV6 of the CUDA kernel, mirrored on the CPU
(``ref.wkv6_chunked_reference``: chunks of 32, sub-chunks of 16, products in
3xTF32), against the token-by-token plain version, the JAX oracle and the
Pallas kernel in interpret mode.

Inputs are drawn with numpy from a fixed seed.  Tolerances are those that
``chip_smoke.py`` holds the kernel to: 2e-4 for an fp32 y and the fp32
state, 1e-4 at log_w = -50, 2e-2 for a bf16 y.  One test pins why the
kernel splits its operands: a single TF32 pass misses the fp32 tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import wkv6 as pallas_wkv6  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32_TOL, BF16_TOL, DECAY_TOL = 2e-4, 2e-2, 1e-4


def _inputs(rng, B, H, T, K, dtype="float32", log_w=None):
    """(jax, torch) pairs of r, k, v, log_w, u, s0; log_w = -exp(N(0, 1)) as
    tests/test_kernels.py draws it, or a constant."""
    def pair(shape, dt="float32"):
        x = rng.normal(size=shape).astype(np.float32)
        return jnp.asarray(x).astype(dt), torch.from_numpy(x).to(getattr(torch, dt))

    r, k, v = (pair((B, H, T, K), dtype) for _ in range(3))
    lw = (-np.exp(rng.normal(size=(B, H, T, K))) if log_w is None
          else np.full((B, H, T, K), log_w)).astype(np.float32)
    return [r, k, v, (jnp.asarray(lw), torch.from_numpy(lw)), pair((H, K)), pair((B, H, K, K))]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


CASES = [(2, 2, T, K) for K in (16, 32, 64) for T in (1, 31, 32, 33, 50)]
CASES += [(1, 1, 1024, K) for K in (16, 32, 64)]


@pytest.mark.parametrize("B,H,T,K", CASES)
def test_chunked_mirror_matches_plain_oracle_and_pallas(rng, B, H, T, K):
    pairs = _inputs(rng, B, H, T, K)
    jin, tin = [p[0] for p in pairs], [p[1] for p in pairs]
    y, sf = ref.wkv6_chunked_reference(*tin)
    assert y.shape == (B, H, T, K) and y.dtype == sf.dtype == torch.float32
    want_y, want_s = ref.wkv6_reference(*tin)
    torch.testing.assert_close(y, want_y, atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(sf, want_s, atol=F32_TOL, rtol=F32_TOL)
    for jy, js in (jref.wkv6_reference(*jin), pallas_wkv6(*jin, chunk=32, interpret=True)):
        _close(y, jy, F32_TOL)
        _close(sf, js, F32_TOL)


@pytest.mark.parametrize("T,K", [(33, 16), (50, 64), (1024, 64)])
def test_chunked_mirror_bf16_inputs(rng, T, K):
    """bf16 r/k/v: the bf16 y within one bf16 step, and the fp32 y that the
    rwkv6 model asks for at the fp32 tolerance, of the plain version."""
    pairs = _inputs(rng, 1, 2, T, K, dtype="bfloat16")
    tin = [p[1] for p in pairs]
    y, sf = ref.wkv6_chunked_reference(*tin)
    want_y, want_s = ref.wkv6_reference(*tin)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), want_y.float(), atol=BF16_TOL, rtol=BF16_TOL)
    torch.testing.assert_close(sf, want_s, atol=F32_TOL, rtol=F32_TOL)
    y32, _ = ref.wkv6_chunked_reference(*tin, out_dtype=torch.float32)
    want_y32, _ = ref.wkv6_reference(*tin, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    torch.testing.assert_close(y32, want_y32, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("T,K", [(32, 64), (40, 16), (97, 32)])
def test_chunked_mirror_extreme_decay(rng, T, K):
    """log_w = -50: every exponent of the factorised products stays ≤ 0, so
    y and the state are finite and within 1e-4 of the oracle and Pallas."""
    pairs = _inputs(rng, 1, 2, T, K, log_w=-50.0)
    jin, tin = [p[0] for p in pairs], [p[1] for p in pairs]
    y, sf = ref.wkv6_chunked_reference(*tin)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    for jy, js in (jref.wkv6_reference(*jin), pallas_wkv6(*jin, chunk=32, interpret=True)):
        _close(y, jy, DECAY_TOL)
        _close(sf, js, DECAY_TOL)


def test_one_tf32_pass_misses_the_fp32_tolerance(rng):
    """Why the kernel splits its operands: at the serving length, one TF32
    pass (10-bit mantissas) is far outside the 2e-4 that 3xTF32 meets."""
    pairs = _inputs(rng, 1, 1, 1024, 64, dtype="bfloat16")
    tin = [p[1] for p in pairs]
    want_y, _ = ref.wkv6_reference(*tin, out_dtype=torch.float32)

    def worst(y):  # max |err| / (atol + rtol |want|), > 1 fails allclose
        return ((y - want_y).abs() / (F32_TOL + F32_TOL * want_y.abs())).max().item()

    y3, _ = ref.wkv6_chunked_reference(*tin, out_dtype=torch.float32)
    y1, _ = ref.wkv6_chunked_reference(*tin, tf32x3=False, out_dtype=torch.float32)
    assert worst(y3) < 1.0
    assert worst(y1) > 5.0


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``ref._tf32`` keeps 10 mantissa bits as cvt.rna.tf32.f32 does."""
    one_ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + one_ulp / 2, 1.0 + one_ulp / 4, -(1.0 + one_ulp / 2),
                      1.0 + 1.5 * one_ulp, 3.0e-3])
    got = ref._tf32(x)
    want = [1.0, 1.0 + one_ulp, 1.0, -(1.0 + one_ulp), 1.0 + 2 * one_ulp]
    assert got[:5].tolist() == want
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2.0 ** -11
    bits = got.view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)
