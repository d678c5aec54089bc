"""The backward plain versions of flash attention and RMSNorm against
``jax.grad`` of the JAX oracles (``repro.kernels.ref``) and against
``torch.autograd`` of the port's forward plain versions, and the wrappers'
autograd wiring on the CPU.

The JAX package has no backward Pallas kernel: its gradients go through XLA.
So the backward kernels are held here, on the CPU, through their plain
versions (the explicit formulas the kernels compute), and on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``) against those plain
versions.  Both stacks in float32 on the CPU; 1e-5, since the formulas sum
over at most a few hundred products.  Inputs are drawn with numpy from a
fixed seed and handed to both stacks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention, flash_attention_bwd, ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm, rmsnorm_bwd  # noqa: E402
from repro_torch.kernels.rmsnorm import BWD_PHASES, BWD_THREADS, bwd_plan  # noqa: E402

TOL = 1e-5

FLASH_CASES = [  # (B, Hq, Hkv, Sq, Sk, D, options)
    (2, 4, 4, 16, 16, 16, {}),
    (1, 2, 2, 24, 24, 32, dict(causal=False)),
    (1, 4, 2, 33, 33, 16, dict(window=8)),
    (1, 4, 2, 33, 33, 16, dict(softcap=5.0)),
    (2, 4, 2, 40, 40, 16, dict(window=6, softcap=3.0)),
    (1, 8, 2, 20, 20, 32, {}),  # GQA
    (2, 4, 1, 18, 18, 64, {}),  # MQA, as gemma-2b
    (1, 4, 2, 20, 33, 16, {}),  # ragged: Sq != Sk
    (1, 2, 1, 33, 20, 16, dict(causal=False)),
    (1, 2, 2, 37, 37, 16, dict(causal=False, window=5, softcap=2.0)),
]


def _ids(cases):
    return [f"B{c[0]}-Hq{c[1]}-Hkv{c[2]}-Sq{c[3]}-Sk{c[4]}-D{c[5]}-{c[6] or 'causal'}"
            for c in cases]


def _qkv_do(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D), (B, Hq, Sq, D)))


def _plain_grads(q, k, v, do, kw):
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.mha_reference(qt, kt, vt, return_lse=True, **kw)
    return ref.mha_backward_reference(qt, kt, vt, o, lse, dot, **kw)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,kw", FLASH_CASES, ids=_ids(FLASH_CASES))
def test_flash_bwd_plain_matches_jax_grad(B, Hq, Hkv, Sq, Sk, D, kw):
    q, k, v, do = _qkv_do(0, B, Hq, Hkv, Sq, Sk, D)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha_reference(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = _plain_grads(q, k, v, do, kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,kw", FLASH_CASES, ids=_ids(FLASH_CASES))
def test_flash_bwd_plain_matches_autograd_of_forward(B, Hq, Hkv, Sq, Sk, D, kw):
    q, k, v, do = _qkv_do(1, B, Hq, Hkv, Sq, Sk, D)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ref.mha_reference(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    got = _plain_grads(q, k, v, do, kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_flash_lse_is_the_forwards_normaliser():
    """The row log-sum-exp of the plain forward is logsumexp of the masked,
    softcapped scores: exp(s - lse) sums to one over each row."""
    q, k, v, _ = _qkv_do(2, 1, 4, 2, 30, 30, 16)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(window=7, softcap=4.0)
    out, lse = ref.mha_reference(qt, kt, vt, return_lse=True, **kw)
    assert lse.shape == (1, 4, 30) and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref.mha_reference(qt, kt, vt, **kw), atol=0, rtol=0)
    s, ok, _ = ref._scores(qt, kt.repeat_interleave(2, dim=1), True, 7, 4.0, 0.25)
    p = torch.where(ok[None, None], torch.exp(s - lse[..., None]), 0.0)
    torch.testing.assert_close(p.sum(-1), torch.ones(1, 4, 30), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [{}, dict(window=5, softcap=3.0)], ids=["causal", "window-softcap"])
def test_flash_attention_wrapper_differentiates_on_cpu(kw):
    """On CPU tensors the wrapper's autograd function runs the plain forward
    and the plain backward and launches no kernel."""
    q, k, v, do = _qkv_do(3, 2, 4, 2, 21, 21, 32)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ref.mha_reference(*plain, **kw), plain, torch.from_numpy(do))
    torch.testing.assert_close(out, ref.mha_reference(*plain, **kw).detach(), atol=0, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_ops_attention_gradients_in_model_layout():
    """ops.attention takes (B, S, H, D) views; its gradients come back in that
    layout and equal autograd of the plain version."""
    q, k, v, do = _qkv_do(4, 2, 4, 1, 19, 19, 16)
    model = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))).requires_grad_()
             for a in (q, k, v)]
    out = ops.attention(*model)
    dout = torch.from_numpy(np.ascontiguousarray(do.transpose(0, 2, 1, 3)))
    got = torch.autograd.grad(out, model, dout)
    plain = [t.detach().clone().requires_grad_() for t in model]
    want_out = ref.mha_reference(*(t.transpose(1, 2) for t in plain)).transpose(1, 2)
    want = torch.autograd.grad(want_out, plain, dout)
    for g, w, m in zip(got, want, model):
        assert g.shape == m.shape
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_flash_bwd_plain_bf16_rounds_fp32_math_once():
    """bf16 inputs: the plain backward computes in fp32 and rounds each
    gradient once to bf16."""
    q, k, v, do = _qkv_do(5, 1, 4, 1, 24, 24, 32)
    bq, bk, bv, bdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o, lse = ref.mha_reference(bq, bk, bv, return_lse=True)
    got = ref.mha_backward_reference(bq, bk, bv, o, lse, bdo)
    want = ref.mha_backward_reference(bq.float(), bk.float(), bv.float(), o.float(), lse,
                                      bdo.float())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.bfloat16(), atol=0, rtol=0)


def test_flash_bwd_wrapper_checks_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in _qkv_do(6, 1, 2, 2, 8, 8, 16))
    o, lse = ref.mha_reference(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse[:, :, :4], do)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o[:, :1], lse, do)


RMS_SHAPES = [(8, 64), (3, 5, 96), (7, 896), (2, 33)]


def _rms_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1]).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_bwd_plain_matches_jax_grad(shape):
    x, s, g = _rms_inputs(0, shape)
    _, vjp = jax.vjp(jref.rmsnorm_reference, jnp.asarray(x), jnp.asarray(s))
    want_dx, want_ds = vjp(jnp.asarray(g))
    dx, ds = ref.rmsnorm_backward_reference(torch.from_numpy(x), torch.from_numpy(s),
                                            torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_bwd_plain_matches_autograd_of_forward(shape):
    x, s, g = (torch.from_numpy(a) for a in _rms_inputs(1, shape))
    xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
    want = torch.autograd.grad(ref.rmsnorm_reference(xl, sl), (xl, sl), g)
    got = ref.rmsnorm_backward_reference(x, s, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


def test_rmsnorm_wrapper_differentiates_on_cpu():
    x, s, g = (torch.from_numpy(a) for a in _rms_inputs(2, (4, 6, 64)))
    before = (rmsnorm.launches, rmsnorm_bwd.launches)
    xl, sl = x.clone().requires_grad_(), s.clone().requires_grad_()
    got = torch.autograd.grad(ops.rmsnorm(xl, sl), (xl, sl), g)
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == before
    want = ref.rmsnorm_backward_reference(x, s, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_rmsnorm_bwd_dtypes_follow_their_inputs():
    """dx in x's dtype, dscale in scale's dtype."""
    x, s, g = (torch.from_numpy(a) for a in _rms_inputs(3, (5, 32)))
    dx, ds = rmsnorm_bwd(x.bfloat16(), s, g.bfloat16())
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    dx, ds = rmsnorm_bwd(x, s.bfloat16(), g)
    assert dx.dtype == torch.float32 and ds.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        rmsnorm_bwd(x, s, g[:3])


BLOCKED_SHAPES = [(37, 2048), (300, 896), (50, 3584), (9, 8192), (5, 5), (6, 16384)]


@pytest.mark.parametrize("n_sm", [8, 132])
@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("rows,d", BLOCKED_SHAPES)
def test_rmsnorm_bwd_plan_takes_every_row_once(rows, d, elem_size, n_sm):
    """The CUDA backward's split: a team covers a row, a block at most fills
    its 512 threads, at most one block per SM, and the teams' rows are every
    row exactly once (ragged row counts included)."""
    plan = bwd_plan(rows, d, elem_size, n_sm)
    tt = plan["team_threads"]
    assert 32 <= tt <= BWD_THREADS and tt & (tt - 1) == 0
    assert tt * plan["elems"] >= d and plan["teams"] * tt == BWD_THREADS
    assert plan["rows_per_block"] % (plan["teams"] * plan["rows_per_step"]) == 0
    assert plan["blocks"] <= n_sm
    rpb = plan["rows_per_block"]
    assert (plan["blocks"] - 1) * rpb < rows <= plan["blocks"] * rpb
    order = ref.rmsnorm_bwd_team_rows(rows, plan["rows_per_block"], plan["teams"],
                                      plan["rows_per_step"])
    assert len(order) == plan["blocks"]
    assert sorted(row for block in order for team in block for row in team) == list(range(rows))


@pytest.mark.parametrize("n_sm", [8, 132])
@pytest.mark.parametrize("rows,d", BLOCKED_SHAPES)
def test_rmsnorm_bwd_blocked_matches_plain_and_jax_grad(rows, d, n_sm):
    """dscale summed per team, block and column-sum phase in the kernels' order against
    the plain backward and jax.vjp of the JAX reference (fp32, sums of up to
    300 terms in another order: relative to max |dscale|)."""
    x, s, g = _rms_inputs(4, (rows, d))
    plan = bwd_plan(rows, d, 4, n_sm)
    tx, ts, tg = (torch.from_numpy(a) for a in (x, s, g))
    dx, ds = ref.rmsnorm_backward_blocked(
        tx, ts, tg, rows_per_block=plan["rows_per_block"], teams=plan["teams"],
        rows_per_step=plan["rows_per_step"], phases=BWD_PHASES)
    want_dx, want_ds = ref.rmsnorm_backward_reference(tx, ts, tg)
    torch.testing.assert_close(dx, want_dx, atol=0, rtol=0)
    scale = want_ds.abs().max().item()
    torch.testing.assert_close(ds, want_ds, atol=TOL * scale, rtol=TOL)
    _, vjp = jax.vjp(jref.rmsnorm_reference, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=TOL * scale, rtol=TOL)
