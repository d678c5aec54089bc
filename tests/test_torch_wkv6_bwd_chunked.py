"""The chunked WKV6 backward of the CUDA kernels, mirrored on the CPU
(``ref.wkv6_backward_chunked_reference``: two state sweeps, chunks of 32
tokens in two sub-chunks of 16, products in 3xTF32, a carry pass for
dlog_w), against ``jax.vjp`` of the JAX oracle
(``repro.kernels.ref.wkv6_reference``) and against the plain version
``ref.wkv6_backward_reference`` that the card is held to.

Inputs are drawn with numpy from a fixed seed.  Tolerance: 2e-4 of each
gradient's largest entry in fp32, the tolerance ``chip_smoke.py`` holds the
kernels to; dlog_w relative to the larger of its own largest entry and
r ⊙ dr's, since at log_w = -50 its two suffix sums cancel to ~0 while their
rounding does not (``tests/test_torch_wkv6_bwd.py``).  One test pins why the
kernels split their operands: one TF32 pass misses that tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL, BF16_TOL = 2e-4, 2e-2
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")
DECAYS = {"near0": -1e-3, "typical": None, "extreme": -50.0}


def _inputs(seed, B, H, T, K, decay):
    """r, k, v, log_w, u, s0, dy, ds_final as numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, H, T, K)).astype(np.float32) for _ in range(4))
    lw = (-np.exp(rng.standard_normal((B, H, T, K))) if decay is None
          else np.full((B, H, T, K), decay)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0, ds = (rng.standard_normal((B, H, K, K)).astype(np.float32) for _ in range(2))
    return r, k, v, lw, u, s0, dy, ds


def _worst(got, want, r, dr, tol, names=NAMES):
    """The largest error of any gradient over tol times its scale (> 1 fails)."""
    floor = float((r.float() * dr.float()).abs().max())
    worst = 0.0
    for name, g, w in zip(names, got, want):
        w = w.float() if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w))
        assert g.shape == w.shape, name
        scale = float(w.abs().max())
        if name == "dlog_w":
            scale = max(scale, floor)
        worst = max(worst, float((g.float() - w).abs().max()) / (tol * max(scale, 1e-30)))
    return worst


def _assert_close(got, want, r, dr, tol=TOL, names=NAMES):
    assert _worst(got, want, r, dr, tol, names) <= 1.0


@pytest.mark.parametrize("decay", list(DECAYS), ids=list(DECAYS))
@pytest.mark.parametrize("K", [16, 32, 64])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 64, 100])
def test_chunked_backward_matches_jax_vjp_and_plain(T, K, decay):
    """Random s0 and ds_final: the mirror against jax.vjp of the JAX oracle
    and against the plain version, every gradient in fp32."""
    arrays = _inputs(T * 100 + K, 2, 3, T, K, DECAYS[decay])
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a) for a in arrays)
    got = ref.wkv6_backward_chunked_reference(r, k, v, lw, u, s0, dy, ds)
    for g in got:
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
    _, vjp = jax.vjp(jref.wkv6_reference, *(jnp.asarray(a) for a in arrays[:6]))
    want = vjp((jnp.asarray(arrays[6]), jnp.asarray(arrays[7])))
    _assert_close(got, want, r, got[0])
    _assert_close(got, ref.wkv6_backward_reference(r, k, v, lw, u, s0, dy, ds), r, got[0])


@pytest.mark.parametrize("s0_zero,ds_none", [(True, True), (True, False), (False, True)],
                         ids=["model", "zero_s0", "no_ds_final"])
@pytest.mark.parametrize("T,K", [(33, 16), (100, 64)])
def test_chunked_backward_zero_state_and_no_ds_final(T, K, s0_zero, ds_none):
    """A zero s0 and no gradient of the final state (the rwkv6 model's call):
    the same gradients as jax.vjp with zeros there."""
    arrays = list(_inputs(7 + T, 2, 2, T, K, None))
    if s0_zero:
        arrays[5] = np.zeros_like(arrays[5])
    if ds_none:
        arrays[7] = np.zeros_like(arrays[7])
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a) for a in arrays)
    got = ref.wkv6_backward_chunked_reference(r, k, v, lw, u, s0, dy, None if ds_none else ds)
    _, vjp = jax.vjp(jref.wkv6_reference, *(jnp.asarray(a) for a in arrays[:6]))
    _assert_close(got, vjp((jnp.asarray(arrays[6]), jnp.asarray(arrays[7]))), r, got[0])


@pytest.mark.parametrize("T,K", [(45, 32), (100, 64)])
def test_chunked_backward_bf16_inputs(T, K):
    """bf16 r/k/v: dr, dk and dv in bf16 within one bf16 step of the plain
    version; dlog_w, du and ds0 in fp32 at the fp32 tolerance."""
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a) for a in _inputs(11 + T, 2, 2, T, K, None))
    rb, kb, vb = (a.bfloat16() for a in (r, k, v))
    got = ref.wkv6_backward_chunked_reference(rb, kb, vb, lw, u, s0, dy, ds)
    want = ref.wkv6_backward_reference(rb, kb, vb, lw, u, s0, dy, ds)
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert [g.dtype for g in got[:3]] == [torch.bfloat16] * 3
    _assert_close(got[:3], want[:3], rb, want[0], tol=BF16_TOL)
    _assert_close(got[3:], want[3:], rb, want[0], names=NAMES[3:])


@pytest.mark.parametrize("tf32x3,within", [(True, True), (False, False)], ids=["3xTF32", "1xTF32"])
def test_tf32_split_is_what_meets_the_fp32_tolerance(tf32x3, within):
    """Why the kernels split each fp32 operand into two TF32 parts (each cut
    to TF32, as the kernels cut them): at the training length, one TF32 pass
    (10-bit mantissas) misses 2e-4 of the largest gradient by more than half
    again, and 3xTF32 meets it with more than tenfold margin."""
    arrays = _inputs(5, 1, 2, 1024, 64, None)
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a) for a in arrays)
    want = ref.wkv6_backward_reference(r, k, v, lw, u, s0, dy, ds)
    got = ref.wkv6_backward_chunked_reference(r, k, v, lw, u, s0, dy, ds, tf32x3=tf32x3)
    worst = _worst(got, want, r, want[0], TOL)
    assert (worst < 0.1) if within else (worst > 1.5)


def test_chunk_cumsum_edges_are_the_tokens_cl():
    """cl_C and g are entries of CL itself, so exp(cl_C - cl) at the last
    token and exp(g - cl) at the sub-chunk's last token are exactly 1; CL
    is the inclusive sum to within fp32 rounding."""
    lw = torch.from_numpy(-np.exp(np.random.default_rng(3).standard_normal((2, 32, 8)))
                          .astype(np.float32))
    CL = ref.chunk_cumsum(lw)
    assert CL.shape == (2, 33, 8) and torch.all(CL[:, 0] == 0)
    assert torch.all(torch.exp(CL[:, 32] - CL[:, 32]) == 1.0)
    torch.testing.assert_close(CL[:, 1:], torch.cumsum(lw.double(), 1).float(), atol=1e-5,
                               rtol=1e-6)
    parts = lw.reshape(2, 4, 8, 8)
    assert torch.equal(CL[:, 8], parts[:, 0].cumsum(1)[:, -1])  # a part's total, as summed
