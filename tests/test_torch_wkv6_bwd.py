"""WKV6's backward plain version against ``jax.vjp`` of the JAX oracle
(``repro.kernels.ref.wkv6_reference``) and against ``torch.autograd`` of the
port's forward plain version, and the wrapper's autograd wiring on the CPU.

The JAX package has no backward Pallas kernel for WKV6: XLA differentiates
its chunked scan.  So the backward kernel (``csrc/wkv6_bwd.cu``) is held
here through its plain version, ``ref.wkv6_backward_reference`` (the passes
the kernel takes), and on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``) against that plain version.  Both stacks in float32,
with cotangents on y and on the final state and a nonzero initial state.

Tolerance: 1e-5 relative to each gradient's largest entry (the sums run over
at most a few thousand products, in another order than XLA's).  dlog_w is a
difference of suffix sums: where the decay is strong (log_w = -50) its two
sums cancel to ~0 while the rounding of their common terms, each as large
as r ⊙ dr, does not.  So dlog_w's tolerance is relative to the larger of
its own largest entry and that of r ⊙ dr.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref, wkv6  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6_bwd  # noqa: E402

TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")
DECAYS = {"near0": -1e-3, "typical": None, "extreme": -50.0}


def _inputs(seed, B, H, T, K, decay):
    """r, k, v, log_w, u, s0 and the cotangents dy, ds_final, as numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, H, T, K)).astype(np.float32) for _ in range(4))
    lw = (-np.exp(rng.standard_normal((B, H, T, K))) if decay is None
          else np.full((B, H, T, K), decay)).astype(np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    s0, ds = (rng.standard_normal((B, H, K, K)).astype(np.float32) for _ in range(2))
    return r, k, v, lw, u, s0, dy, ds


def _assert_grads_close(got, want, r, dr, tol=TOL):
    """got, want: the six gradients (torch or numpy); r, dr: for dlog_w's scale."""
    floor = float((r.float() * dr.float()).abs().max())
    for name, g, w in zip(NAMES, got, want):
        w = torch.as_tensor(np.array(w)).float()
        assert g.shape == w.shape, name
        scale = float(w.abs().max())
        if name == "dlog_w":
            scale = max(scale, floor)
        torch.testing.assert_close(g.float(), w, atol=tol * scale, rtol=tol, msg=name)


@pytest.mark.parametrize("decay", list(DECAYS), ids=list(DECAYS))
@pytest.mark.parametrize("K", [16, 32, 64])
@pytest.mark.parametrize("T", [1, 31, 45, 64])
def test_wkv6_bwd_plain_matches_jax_vjp(T, K, decay):
    r, k, v, lw, u, s0, dy, ds = _inputs(T * 100 + K, 2, 3, T, K, DECAYS[decay])
    _, vjp = jax.vjp(jref.wkv6_reference, *(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    got = ref.wkv6_backward_reference(*(torch.from_numpy(a) for a in (r, k, v, lw, u, s0, dy, ds)))
    for g in got:
        assert g.dtype == torch.float32
    _assert_grads_close(got, want, torch.from_numpy(r), got[0])


@pytest.mark.parametrize("decay", ["typical", "extreme"])
@pytest.mark.parametrize("T,K", [(1, 16), (33, 64), (50, 16)])
def test_wkv6_bwd_plain_matches_autograd_of_forward(T, K, decay):
    r, k, v, lw, u, s0, dy, ds = _inputs(7 + T, 2, 2, T, K, DECAYS[decay])
    leaves = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, lw, u, s0)]
    y, s_final = ref.wkv6_reference(*leaves)
    want = torch.autograd.grad((y, s_final), leaves, (torch.from_numpy(dy), torch.from_numpy(ds)))
    got = ref.wkv6_backward_reference(*(torch.from_numpy(a) for a in (r, k, v, lw, u, s0, dy, ds)))
    _assert_grads_close(got, want, leaves[0].detach(), got[0])


def test_wkv6_bwd_plain_without_cotangents():
    """dy = None or ds_final = None stand for zeros."""
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 9, 16, None))
    zeros = (torch.zeros_like(dy), torch.zeros_like(ds))
    for given, full in (((dy, None), (dy, zeros[1])), ((None, ds), (zeros[0], ds)),
                        ((None, None), zeros)):
        got = ref.wkv6_backward_reference(r, k, v, lw, u, s0, *given)
        want = ref.wkv6_backward_reference(r, k, v, lw, u, s0, *full)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_wkv6_bwd_plain_bf16_rounds_fp32_math_once():
    """bf16 r/k/v: dr, dk and dv come back in bf16, the fp32 result of the
    same values rounded once; the rest stays fp32."""
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a) for a in _inputs(4, 2, 2, 20, 32, None))
    rb, kb, vb = (a.bfloat16() for a in (r, k, v))
    got = ref.wkv6_backward_reference(rb, kb, vb, lw, u, s0, dy, ds)
    want = ref.wkv6_backward_reference(rb.float(), kb.float(), vb.float(), lw, u, s0, dy, ds)
    for name, g, w in zip(NAMES, got, want):
        if name in ("dr", "dk", "dv"):
            assert g.dtype == torch.bfloat16, name
            torch.testing.assert_close(g, w.bfloat16(), atol=0, rtol=0, msg=name)
        else:
            assert g.dtype == torch.float32, name
            torch.testing.assert_close(g, w, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("outputs", ["y", "s_final", "both"])
def test_wkv6_wrapper_differentiates_on_cpu(outputs):
    """On CPU tensors the wrapper's autograd function runs the plain forward
    and the plain backward, launches no kernel, and gives autograd's
    gradients of the plain forward whichever outputs the loss reads."""
    arrays = _inputs(5, 2, 3, 37, 16, None)
    before = (wkv6.launches, wkv6_bwd.launches)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
    plain = [torch.from_numpy(a).requires_grad_() for a in arrays[:6]]
    dy, ds = torch.from_numpy(arrays[6]), torch.from_numpy(arrays[7])
    losses = []
    for fn, xs in ((wkv6, leaves), (ref.wkv6_reference, plain)):
        y, s_final = fn(*xs)
        loss = {"y": (y * dy).sum(), "s_final": (s_final * ds).sum(),
                "both": (y * dy).sum() + (s_final * ds).sum()}[outputs]
        losses.append(torch.autograd.grad(loss, xs, allow_unused=True, materialize_grads=True))
    assert (wkv6.launches, wkv6_bwd.launches) == before
    _assert_grads_close(losses[0], losses[1], leaves[0].detach(), losses[1][0])


def test_ops_wkv6_gradients_in_model_layout():
    """ops.wkv6 takes (B, S, H, K) views and fp32 y from bf16 r/k/v, as the
    rwkv6 model calls it; the gradients come back in that layout and equal
    autograd of the plain version."""
    r, k, v, lw, u, s0, dy, _ = _inputs(6, 2, 4, 29, 16, None)
    r, k, v, lw = (torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
                   for a in (r, k, v, lw))
    model = [t.requires_grad_() for t in (r.bfloat16(), k.bfloat16(), v.bfloat16(), lw,
                                          torch.from_numpy(u))]
    s0t = torch.from_numpy(s0)
    dyt = torch.from_numpy(np.ascontiguousarray(dy.transpose(0, 2, 1, 3)))
    y, _ = ops.wkv6(*model, s0t, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == (2, 29, 4, 16)
    got = torch.autograd.grad(y, model, dyt)
    plain = [t.detach().clone().requires_grad_() for t in model]
    want_y, _ = ref.wkv6_reference(*(t.transpose(1, 2) for t in plain[:4]), plain[4], s0t,
                                   out_dtype=torch.float32)
    want = torch.autograd.grad(want_y.transpose(1, 2), plain, dyt)
    for g, w, m in zip(got, want, model):
        assert g.shape == m.shape and g.dtype == m.dtype
        tol = 2e-2 if g.dtype == torch.bfloat16 else TOL  # bf16: both round one fp32 result
        torch.testing.assert_close(g.float(), w.float(), atol=tol * float(w.float().abs().max()),
                                   rtol=tol)


def test_wkv6_gradient_with_state_in_place_raises():
    r, k, v, lw, u, s0, _, _ = (torch.from_numpy(a) for a in _inputs(8, 1, 2, 4, 16, None))
    with pytest.raises(RuntimeError, match="in place"):
        wkv6(r.requires_grad_(), k, v, lw, u, s0, s_out=s0)
    with torch.no_grad():  # serving: in place, no gradient
        y, s = wkv6(r, k, v, lw, u, s0, s_out=s0)
    assert s is s0


def test_wkv6_bwd_wrapper_checks_shapes():
    r, k, v, lw, u, s0, dy, ds = (torch.from_numpy(a) for a in _inputs(9, 1, 2, 6, 16, None))
    with pytest.raises(ValueError):
        wkv6_bwd(r, k, v, lw, u, s0, dy[:, :, :5], ds)  # dy of another length
    with pytest.raises(ValueError):
        wkv6_bwd(r, k, v, lw, u, s0, dy, ds[..., :8])  # ds_final not (K, V)
    with pytest.raises(ValueError):
        wkv6_bwd(r, k, v, lw, u, s0.to("meta"), dy, ds)  # mixed devices
