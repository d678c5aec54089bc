"""The port's selective state-space (Mamba-1) block against the JAX
package's ``repro.models.ssm`` on the CPU: ``scan_chunk`` (the port's
doubling scan against JAX's ``associative_scan``) with decays spread over
(0, 1) and bunched near 0 and near 1, ``chunked_scan`` at lengths that take
each branch of the chunk rule, ``Mamba.forward`` against ``mamba_block``
without a state, through a zero state, and as a prefill followed by
teacher-forced decode steps, the new ``(conv_buf, ssm_state)`` (a prompt of
2 tokens keeps one row of the old conv buffer), ``mamba_state_shape``, and
the block at a bf16 param and compute dtype.  The selective scan's plain
versions, which the CPU runs in place of its kernels: the forward
(``ref.selective_scan_reference``) against JAX's chunked scan at S = 1,
100, 127 and 1024 with decays near 0 and near 1 (within 1e-5 of max|y|),
the backward (``ref.selective_scan_backward_reference``) against torch
autograd through the plain forward, and the block's gradients through the
wrapper's ``autograd.Function`` against ``jax.grad`` of ``mamba_block``
(within 1e-4 of each gradient's max).  Weights come from JAX's
``init_mamba``; inputs are drawn with numpy from a fixed seed and handed to
both stacks.  fp32 tolerances: 1e-5 for the scan (the two scans multiply
the same decays in another tree order), 1e-4 for the block (sums over d_in
taken in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import _flatten as ckpt_flatten  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import smoke_config, ssm  # noqa: E402

ARCH = "jamba-1.5-large-398b"
SCAN_ATOL, BLOCK_ATOL = 1e-5, 1e-4
BF16_STEP = 2.0 ** -7


def _decays(rng, shape, regime):
    if regime == "spread":
        return rng.uniform(0.0, 1.0, shape)
    if regime == "near 0":
        return rng.uniform(0.0, 1e-3, shape)
    return 1.0 - rng.uniform(0.0, 1e-3, shape)  # near 1


@pytest.mark.parametrize("Q", [64, 37, 1])
@pytest.mark.parametrize("regime", ["spread", "near 0", "near 1"])
def test_scan_chunk_matches_jax(regime, Q):
    rng = np.random.default_rng(0)
    decay = _decays(rng, (2, Q, 8, 4), regime).astype(np.float32)
    inp = rng.normal(size=(2, Q, 8, 4)).astype(np.float32)
    h0 = rng.normal(size=(2, 8, 4)).astype(np.float32)
    want, want_last = jssm.scan_chunk(jnp.asarray(decay), jnp.asarray(inp), jnp.asarray(h0))
    got, last = ssm.scan_chunk(*(torch.from_numpy(a) for a in (decay, inp, h0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=SCAN_ATOL, rtol=0)
    # the recurrence itself, step by step in float64
    h = h0.astype(np.float64)
    for t in range(Q):
        h = decay[:, t] * h + inp[:, t]
    np.testing.assert_allclose(last.numpy(), h, atol=SCAN_ATOL, rtol=0)


@pytest.mark.parametrize("S,chunks", [(64, [64]), (100, [4] * 25), (127, [1] * 127),
                                      (128, [64, 64]), (1, [1])])
def test_chunked_scan_matches_jax(S, chunks):
    """JAX's chunk rule: 64 if it divides S, else S when S < 64, else
    gcd(S, 64); the mamba chunk function on both sides, and the port's
    ``selective_scan``."""
    rng = np.random.default_rng(S)
    B, D, N = 2, 8, 4
    dt = rng.uniform(0.0, 1.0, (B, S, D)).astype(np.float32)
    dtx = rng.normal(size=(B, S, D)).astype(np.float32)
    bm, cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    A = -np.exp(rng.normal(size=(D, N))).astype(np.float32)
    h0 = rng.normal(size=(B, D, N)).astype(np.float32)

    def jchunk(h, ac):
        dt_c, dtx_c, b_c, c_c = ac
        states, h2 = jssm.scan_chunk(jnp.exp(dt_c[..., None] * A),
                                     dtx_c[..., None] * b_c[:, :, None, :], h)
        return h2, jnp.einsum("bqdn,bqn->bqd", states, c_c)

    seen = []

    def tchunk(h, ac):
        dt_c, dtx_c, b_c, c_c = ac
        seen.append(dt_c.shape[1])
        states, h2 = ssm.scan_chunk(torch.exp(dt_c[..., None] * torch.from_numpy(A)),
                                    dtx_c[..., None] * b_c[:, :, None, :], h)
        return h2, torch.einsum("bqdn,bqn->bqd", states, c_c)

    want, want_h = jssm.chunked_scan(tuple(jnp.asarray(a) for a in (dt, dtx, bm, cm)),
                                     jnp.asarray(h0), jchunk, 64)
    got, h = ssm.chunked_scan(tuple(torch.from_numpy(a) for a in (dt, dtx, bm, cm)),
                              torch.from_numpy(h0), tchunk, ssm.CHUNK)
    assert seen == chunks
    assert got.shape == (B, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=SCAN_ATOL, rtol=0)
    # the block's own scan, the same chunk function
    got, h = ssm.selective_scan(*(torch.from_numpy(a) for a in (dt, dtx, bm, cm, A, h0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_ATOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=SCAN_ATOL, rtol=0)


def _pair(dtype="float32"):
    """(JAX cfg, JAX params, port Mamba) of one block with JAX's weights."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg, cfg = jsmoke(ARCH).replace(**kw), smoke_config(ARCH).replace(**kw)
    jparams = jssm.init_mamba(jax.random.PRNGKey(4), jcfg)
    mod = ssm.Mamba(cfg, torch.device("cpu"))
    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(getattr(mod, k).dtype)
          for k, v in ckpt_flatten(jparams).items()}
    mod.load_state_dict(sd, strict=True)
    return jcfg, jparams, cfg, mod


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _close(t, j, atol=BLOCK_ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, dtype=np.float32),
                               atol=atol, rtol=0)


def _zero_state(cfg, B):
    (s1, s2) = ssm.mamba_state_shape(cfg, B)
    return torch.zeros(s1), torch.zeros(s2)


@pytest.mark.parametrize("S", [16, 100])
def test_mamba_block_matches_jax(S):
    """No state, and a prefill through a zero state: the same y, and the
    state written in place equals JAX's new state."""
    jcfg, jparams, cfg, mod = _pair()
    x = _x(cfg, 2, S)
    want, _ = jssm.mamba_block(jparams, jnp.asarray(x), jcfg)
    jstate = tuple(jnp.zeros(s, jnp.float32) for s in jssm.mamba_state_shape(jcfg, 2))
    want_p, (jbuf, jh) = jssm.mamba_block(jparams, jnp.asarray(x), jcfg, state=jstate)
    state = _zero_state(cfg, 2)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
        got_p = mod(torch.from_numpy(x), state=state)
    _close(got, want)
    _close(got_p, want_p)
    _close(state[0], jbuf)
    _close(state[1], jh)
    assert state[1].dtype == torch.float32 and state[1].abs().sum() > 0


@pytest.mark.parametrize("prompt", [2, 12])
def test_mamba_prefill_then_decode_equals_the_full_pass(prompt):
    """A prefill of ``prompt`` tokens, then one decode step (S = 1) per
    further token, gives the full pass's y; after every call the state
    equals JAX's.  A 2-token prompt keeps one row of the zero buffer."""
    jcfg, jparams, cfg, mod = _pair()
    S = 16
    x = _x(cfg, 2, S, seed=1)
    full, _ = jssm.mamba_block(jparams, jnp.asarray(x), jcfg)
    jstate = tuple(jnp.zeros(s, jnp.float32) for s in jssm.mamba_state_shape(jcfg, 2))
    state = _zero_state(cfg, 2)
    with torch.no_grad():
        ys = [mod(torch.from_numpy(x[:, :prompt]), state=state)]
        _, jstate = jssm.mamba_block(jparams, jnp.asarray(x[:, :prompt]), jcfg, state=jstate)
        for s, j in zip(state, jstate):
            _close(s, j)
        if prompt < cfg.mamba.d_conv - 1:
            assert (state[0][:, :cfg.mamba.d_conv - 1 - prompt] == 0).all()
        for t in range(prompt, S):
            ys.append(mod(torch.from_numpy(x[:, t:t + 1]), state=state))
            want_t, jstate = jssm.mamba_block(jparams, jnp.asarray(x[:, t:t + 1]), jcfg,
                                              state=jstate)
            _close(ys[-1], want_t)
    _close(torch.cat(ys, dim=1), full)
    for s, j in zip(state, jstate):
        _close(s, j)


def test_mamba_state_shape():
    assert ssm.mamba_state_shape(smoke_config(ARCH), 3) == jssm.mamba_state_shape(jsmoke(ARCH), 3)
    full, jfull = get_config(ARCH), jget_config(ARCH)
    assert ssm.mamba_state_shape(full, 4) == jssm.mamba_state_shape(jfull, 4) \
        == ((4, 3, 16384), (4, 16384, 16))
    assert ssm.mamba_dims(full)[1:] == jssm._mamba_dims(jfull)[1:] == (16384, 512)


def test_mamba_init():
    """JAX's ``init_mamba``: A_log = log(1..N) on every channel, D one,
    conv_b and dt_bias zero, A_log and D fp32 at a bf16 param dtype, the
    projections normal/sqrt(in)."""
    cfg = smoke_config(ARCH).replace(d_model=512, param_dtype="bfloat16",
                                     compute_dtype="bfloat16")
    mod = ssm.Mamba(cfg, torch.device("cpu"))
    mod.reset_parameters(torch.Generator().manual_seed(0))
    N = cfg.mamba.d_state
    assert mod.A_log.dtype == mod.D.dtype == torch.float32
    assert mod.in_proj.dtype == mod.conv_w.dtype == torch.bfloat16
    torch.testing.assert_close(mod.A_log, torch.log(torch.arange(1.0, N + 1)).expand(1024, N),
                               atol=0, rtol=0)
    assert torch.equal(mod.D, torch.ones(1024))
    assert not mod.conv_b.float().any() and not mod.dt_bias.float().any()
    assert abs(mod.in_proj.float().std().item() * 512 ** 0.5 - 1.0) < 0.02
    assert abs(mod.conv_w.float().std().item() * cfg.mamba.d_conv ** 0.5 - 1.0) < 0.05


def test_bf16_mamba_block_matches_jax():
    """At param and compute dtype bfloat16, within the bf16 parity test's
    tolerance: two bf16 steps at |y| in [1, 2) plus one relative step, and
    2e-3 on average (the two stacks round silu, the projections and
    y·silu(z) to bf16 at other places).  JAX's block runs jitted, as the
    model runs it inside ``apply_lm``; its eager op-by-op form differs from
    its jitted one by ~8e-4 on average here."""
    jcfg, jparams, cfg, mod = _pair("bfloat16")
    assert mod.A_log.dtype == mod.D.dtype == torch.float32
    x = _x(cfg, 2, 16, seed=2)
    (s1, s2) = ssm.mamba_state_shape(cfg, 2)
    block = jax.jit(lambda p, x, s: jssm.mamba_block(p, x, jcfg, state=s))
    want, (jbuf, jh) = block(jparams, jnp.asarray(x).astype(jnp.bfloat16),
                             (jnp.zeros(s1, jnp.bfloat16), jnp.zeros(s2, jnp.float32)))
    state = (torch.zeros(s1, dtype=torch.bfloat16), torch.zeros(s2))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(torch.bfloat16), state=state)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    gap = np.abs(got.float().numpy() - want)
    assert (gap <= 2 * BF16_STEP + BF16_STEP * np.abs(want)).all(), gap.max()
    assert gap.mean() <= 2e-3
    # the conv buffer is in_proj's output, rounded once on both sides
    np.testing.assert_array_equal(state[0].float().numpy(),
                                  np.asarray(jbuf.astype(jnp.float32)))
    # the fp32 scan state, from inputs rounded to bf16 at other places:
    # within two bf16 steps of its largest entry
    assert state[1].dtype == torch.float32
    jh = np.asarray(jh)
    assert np.abs(state[1].numpy() - jh).max() <= 2 * BF16_STEP * np.abs(jh).max()


# ---------------------------------------------------------------------------
# the selective scan's plain versions (the kernels' contracts on the CPU)
# ---------------------------------------------------------------------------

SCAN_REL = 1e-5  # y against JAX's, relative to max|y| (fp32 sums in another order)
SCAN_BWD_REL = 1e-4  # each fp32 gradient relative to its max (chip_smoke.py holds the kernels so)


def _scan_inputs(S, regime, B=2, D=8, N=4, seed=0):
    """(dt, dtx, B, C, A, h0) as numpy fp32: dt softplus-sized, or 5-10
    ("near 0": exp(dt A) < 7e-3) or 1e-5-1e-4 ("near 1"); A = -(1 .. N)
    scaled per channel."""
    rng = np.random.default_rng(seed)
    if regime == "near 0":
        dt = rng.uniform(5.0, 10.0, (B, S, D))
    elif regime == "near 1":
        dt = rng.uniform(1e-5, 1e-4, (B, S, D))
    else:
        dt = np.log1p(np.exp(rng.normal(size=(B, S, D))))
    dtx = dt * rng.normal(size=(B, S, D))
    bm, cm = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    A = -np.arange(1, N + 1) * rng.uniform(0.5, 1.5, (D, N))
    h0 = rng.normal(size=(B, D, N))
    return tuple(a.astype(np.float32) for a in (dt, dtx, bm, cm, A, h0))


def _jax_scan(dt, dtx, bm, cm, A, h0):
    """JAX's selective scan as ``mamba_block`` runs it: ``chunked_scan`` in
    chunks of 64 with the mamba chunk function."""
    def jchunk(h, ac):
        dt_c, dtx_c, b_c, c_c = ac
        states, h2 = jssm.scan_chunk(jnp.exp(dt_c[..., None] * A),
                                     dtx_c[..., None] * b_c[:, :, None, :], h)
        return h2, jnp.einsum("bqdn,bqn->bqd", states, c_c)

    return jssm.chunked_scan(tuple(jnp.asarray(a) for a in (dt, dtx, bm, cm)), jnp.asarray(h0),
                             jchunk, 64)


@pytest.mark.parametrize("regime", ["model", "near 0", "near 1"])
@pytest.mark.parametrize("S", [1, 100, 127, 1024])
def test_plain_selective_scan_matches_jax(S, regime):
    """``ref.selective_scan_reference``, the kernel's plain version, against
    JAX's chunked scan: y and h_S within SCAN_REL of max|y|."""
    args = _scan_inputs(S, regime)
    want, want_h = _jax_scan(*args)
    got, h = ref.selective_scan_reference(*(torch.from_numpy(a) for a in args))
    top = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_REL * top, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=SCAN_REL * top, rtol=0)


def _close_rel(got, want, rel, what=""):
    want = np.asarray(want, dtype=np.float32)
    top = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want, atol=rel * top, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("regime", ["model", "near 0", "near 1"])
@pytest.mark.parametrize("S", [1, 100, 127, 130])
def test_plain_scan_backward_matches_autograd(S, regime):
    """``ref.selective_scan_backward_reference`` (a reverse sweep over
    64-token chunks, each run forward again from its first state) against
    torch autograd through the plain forward (JAX's doubling scan), with
    gradients of y and of h_S: every gradient within SCAN_BWD_REL of its
    max."""
    args = [torch.from_numpy(a).requires_grad_() for a in _scan_inputs(S, regime, seed=S)]
    y, h = ref.selective_scan_reference(*args)
    rng = np.random.default_rng(1)
    dy = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), args)
    got = ref.selective_scan_backward_reference(*(a.detach() for a in args), dy, dh)
    for name, g, w in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        _close_rel(g.numpy(), w.numpy(), SCAN_BWD_REL, name)


def test_selective_scan_autograd_function_on_the_cpu():
    """The wrapper on CPU tensors: without a gradient it is the plain
    forward; with one it runs the ``torch.autograd.Function`` through the
    plain versions, whose gradients equal the plain backward's bit for bit
    (with and without a gradient of h_S), and launches no kernel."""
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_bwd

    args = [torch.from_numpy(a) for a in _scan_inputs(100, "model")]
    before = (selective_scan.launches, selective_scan_bwd.launches)
    y0, h0 = selective_scan(*args)
    want_y, want_h = ref.selective_scan_reference(*args)
    assert torch.equal(y0, want_y) and torch.equal(h0, want_h)
    dy = torch.ones_like(y0)
    for with_dh in (False, True):
        ins = [a.clone().requires_grad_() for a in args]
        y, h = selective_scan(*ins)
        assert torch.equal(y, want_y)
        loss = (y * dy).sum() + ((h * 2.0).sum() if with_dh else 0.0)
        got = torch.autograd.grad(loss, ins)
        want = ref.selective_scan_backward_reference(
            *args, dy, torch.full_like(h0, 2.0) if with_dh else None)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert (selective_scan.launches, selective_scan_bwd.launches) == before


def test_selective_scan_wrapper_refuses_what_it_does_not_take():
    from repro_torch.kernels.selective_scan import selective_scan

    dt, dtx, bm, cm, A, h0 = (torch.from_numpy(a) for a in _scan_inputs(8, "model"))
    with pytest.raises(TypeError, match="float32"):
        selective_scan(dt.double(), dtx, bm, cm, A, h0)
    with pytest.raises(ValueError, match="h0"):
        selective_scan(dt, dtx, bm, cm, A, h0[:, :4])
    with pytest.raises(ValueError, match="B and C"):
        selective_scan(dt, dtx, bm[:, :, :2], cm, A, h0)


@pytest.mark.parametrize("S", [16, 100])
def test_mamba_block_gradients_match_jax(S):
    """``jax.grad`` of JAX's ``mamba_block`` against torch autograd through
    the port's block (the scan's ``autograd.Function`` on its plain
    backward): the gradient of every parameter and of x, for a fixed
    random cotangent of y, within 1e-4 of each gradient's max (sums over
    d_in in another order)."""
    jcfg, jparams, cfg, mod = _pair()
    x = _x(cfg, 2, S, seed=3)
    w = np.random.default_rng(4).normal(size=(2, S, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        y, _ = jssm.mamba_block(p, xx, jcfg)
        return jnp.sum(y * w)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    loss = (mod(xt) * torch.from_numpy(w)).sum()
    names, params = zip(*mod.named_parameters())
    grads = torch.autograd.grad(loss, list(params) + [xt])
    want = ckpt_flatten(jg)
    for name, g in zip(names, grads[:-1]):
        _close_rel(g.numpy(), want[name], 1e-4, name)
    _close_rel(grads[-1].numpy(), jgx, 1e-4, "x")
