"""The hand-written kernels against their plain versions on the card.

These need a CUDA device, ``nvcc`` and ``triton``; without a card they skip
with a reason.  Run them on the GPU with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: 2e-5 in float32 and 2e-2 in bfloat16, as in
``tests/test_kernels.py``; WKV6 2e-4 in float32 (1e-4 under extreme decay),
as the JAX tests hold the Pallas kernel, and 2e-2 in bfloat16.  The backward
kernels: 1e-4 in float32 (dK and dV sum up to a few thousand products in
another order than the plain version) and 2e-2 in bfloat16 (both sides
compute in fp32 from the same bf16 inputs and round once).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, flash_attention_bwd, ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm, rmsnorm_bwd, wkv6  # noqa: E402
from repro_torch.kernels.flash_attention import _forward as flash_forward  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,kw", [
    (1, 1, 1, 128, 128, 64, {}),
    (2, 4, 2, 256, 256, 64, dict(causal=False)),
    (1, 4, 2, 256, 256, 64, dict(window=64)),
    (1, 4, 2, 256, 256, 64, dict(window=32, softcap=50.0)),
    (1, 8, 1, 128, 256, 128, dict(softcap=30.0)),
    (1, 2, 2, 100, 100, 32, {}),
    (2, 8, 1, 300, 300, 256, {}),
    (1, 4, 2, 50, 70, 16, dict(window=8)),
])
def test_flash_kernel_matches_plain(gen, dtype, B, Hq, Hkv, Sq, Sk, D, kw):
    q = _randn(gen, (B, Hq, Sq, D), dtype)
    k = _randn(gen, (B, Hkv, Sk, D), dtype)
    v = _randn(gen, (B, Hkv, Sk, D), dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.mha_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,kw", [
    (1, 2, 1, 65, 65, 64, {}),  # one row and one key past a 64-row q tile and kv tile
    (2, 2, 2, 65, 65, 128, dict(causal=False)),
    (1, 2, 1, 33, 200, 64, {}),  # half a q tile against a ragged kv tail
    (1, 2, 1, 33, 200, 256, dict(causal=False, softcap=30.0)),
    (1, 2, 1, 200, 200, 256, dict(window=40)),  # the window edge crosses BK=32 tiles
    (2, 8, 1, 130, 130, 32, dict(window=40, softcap=50.0)),  # Hq/Hkv = 8
    (1, 8, 1, 64, 64, 16, {}),
])
def test_flash_bf16_tensor_core_edges(gen, B, Hq, Hkv, Sq, Sk, D, kw):
    """The bf16 kernel at the edges of its tiles: ragged q and kv tails,
    windows across kv tiles, MQA groups of 8."""
    q = _randn(gen, (B, Hq, Sq, D), torch.bfloat16)
    k = _randn(gen, (B, Hkv, Sk, D), torch.bfloat16)
    v = _randn(gen, (B, Hkv, Sk, D), torch.bfloat16)
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.dtype == torch.bfloat16
    want = ref.mha_reference(q, k, v, **kw)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 256), (3, 5, 512), (4095, 2048), (7, 896), (5, 3584), (3, 8192)])
def test_rmsnorm_kernel_matches_plain(gen, dtype, shape):
    x = _randn(gen, shape, dtype)
    s = _randn(gen, shape[-1:], dtype)
    before = rmsnorm.launches
    out = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(out.float(), ref.rmsnorm_reference(x, s).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_ops_model_layout_on_the_card(gen):
    q = _randn(gen, (2, 64, 4, 32), torch.float32)
    kv = _randn(gen, (2, 64, 2, 32), torch.float32)
    out = ops.attention(q, kv, kv)
    assert out.shape == q.shape and out.is_contiguous()
    want = ref.mha_reference(q.transpose(1, 2), kv.transpose(1, 2), kv.transpose(1, 2))
    torch.testing.assert_close(out, want.transpose(1, 2), atol=2e-5, rtol=2e-5)


def test_kernels_raise_on_what_they_do_not_take(gen):
    q = _randn(gen, (1, 2, 8, 48), torch.float32)  # head_dim 48 has no kernel
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(TypeError):
        rmsnorm(_randn(gen, (4, 64), torch.float16), _randn(gen, (64,), torch.float16))


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,dtype,kw", [
    (4, 8, 1, 1024, 1024, 256, torch.bfloat16, {}),  # gemma-2b training
    (4, 8, 1, 1024, 1024, 256, torch.float32, {}),
    (1, 4, 2, 256, 256, 64, torch.float32, dict(window=64)),
    (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(softcap=30.0)),
    (1, 4, 2, 256, 256, 64, torch.float32, dict(causal=False)),
    (1, 8, 2, 128, 256, 128, torch.float32, dict(window=100)),  # GQA, cross lengths
    (1, 2, 2, 1000, 1000, 128, torch.bfloat16, {}),  # ragged S
    (2, 4, 2, 77, 77, 16, torch.float32, dict(window=8, softcap=5.0)),
    (1, 2, 2, 100, 100, 32, torch.bfloat16, dict(causal=False, window=30)),
    # the bf16 kernels' 64-row tiles at D = 256: ragged ends, Sq != Sk, options
    (1, 2, 2, 1000, 1000, 256, torch.bfloat16, {}),
    (1, 4, 1, 200, 333, 256, torch.bfloat16, {}),
    (1, 4, 1, 333, 200, 256, torch.bfloat16, dict(causal=False)),
    (1, 4, 2, 300, 300, 256, torch.bfloat16, dict(window=100, softcap=50.0)),
    (1, 8, 2, 256, 256, 256, torch.bfloat16, {}),  # GQA 8/2
    (2, 4, 2, 200, 200, 16, torch.bfloat16, {}),
    (1, 4, 2, 200, 200, 64, torch.bfloat16, {}),
])
def test_flash_backward_kernel_matches_plain(gen, B, Hq, Hkv, Sq, Sk, D, dtype, kw):
    """The forward's LSE against the plain one, then the backward kernel
    against the plain backward on the same q, k, v, o, LSE and dO."""
    q = _randn(gen, (B, Sq, Hq, D), dtype).transpose(1, 2)
    k = _randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
    v = _randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
    dout = _randn(gen, (B, Sq, Hq, D), dtype).transpose(1, 2)
    opts = dict(causal=True, window=None, softcap=None, scale=D ** -0.5) | kw
    out, lse = flash_forward(q, k, v, with_lse=True, **opts)
    _, want_lse = ref.mha_reference(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = ref.mha_backward_reference(q, k, v, out, lse, dout, **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape and g.stride() == x.stride()
        torch.testing.assert_close(g.float(), w.float(), atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype", [
    (4, 8, 1, 1024, 256, torch.bfloat16),  # gemma-2b training: MQA, through the group sum
    (1, 4, 4, 300, 128, torch.bfloat16),
    (1, 4, 2, 200, 64, torch.float32),
])
def test_flash_backward_kernel_is_deterministic(gen, B, Hq, Hkv, S, D, dtype):
    """Two calls on the same inputs give bit-identical dQ, dK and dV: the
    kernels sum in one fixed order and use no atomics."""
    q = _randn(gen, (B, Hq, S, D), dtype)
    k, v = (_randn(gen, (B, Hkv, S, D), dtype) for _ in range(2))
    dout = _randn(gen, (B, Hq, S, D), dtype)
    out, lse = flash_forward(q, k, v, with_lse=True, causal=True, window=None, softcap=None,
                             scale=D ** -0.5)
    first = flash_attention_bwd(q, k, v, out, lse, dout)
    second = flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_runs_both_kernels(gen):
    """A gradient through ops.attention launches the forward (with its LSE)
    and the backward kernel once each, and matches autograd of the plain
    version; a broadcast dO is copied to rows the kernel can read."""
    q, k, v = (_randn(gen, (2, 64, h, 32), torch.float32).requires_grad_() for h in (4, 2, 2))
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out = ops.attention(q, k, v, window=20)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    plain = ref.mha_reference(*(t.transpose(1, 2) for t in (q, k, v)), window=20)
    want = torch.autograd.grad(plain.sum(), (q, k, v))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def _rmsnorm_bwd_close(dx, ds, want_dx, want_ds, dtype):
    tol = BWD_TOL[dtype]
    torch.testing.assert_close(dx.float(), want_dx.float(), atol=tol, rtol=tol)
    # dscale sums `rows` products: relative to its size
    torch.testing.assert_close(ds.float(), want_ds.float(), atol=tol * want_ds.abs().max().item(),
                               rtol=tol)


@pytest.mark.parametrize("rows,d,dtype", [
    (4096, 2048, torch.bfloat16),  # gemma-2b training
    (4096, 2048, torch.float32),
    (1000, 896, torch.float32),  # widths that are not powers of two
    (333, 3584, torch.bfloat16),
    (17, 8192, torch.bfloat16),
    (3, 5, torch.float32),
    (4095, 2048, torch.bfloat16),  # a ragged last slice of rows
    (64, 16384, torch.bfloat16),  # the widest row: 32 elements a thread
    (9, 16384, torch.float32),
])
def test_rmsnorm_backward_kernel_matches_plain(gen, rows, d, dtype):
    x, g = _randn(gen, (rows, d), dtype), _randn(gen, (rows, d), dtype)
    s = _randn(gen, (d,), dtype)
    before = rmsnorm_bwd.launches
    dx, ds = rmsnorm_bwd(x, s, g)
    torch.cuda.synchronize()
    assert rmsnorm_bwd.launches == before + 1
    want_dx, want_ds = ref.rmsnorm_backward_reference(x, s, g)
    assert dx.dtype == ds.dtype == dtype
    _rmsnorm_bwd_close(dx, ds, want_dx, want_ds, dtype)


@pytest.mark.parametrize("case", ["unaligned_x", "broadcast_g", "scale_dtype"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel_other_layouts(gen, case, dtype):
    """An x that does not start on 16 bytes (scalar loads), a broadcast g
    (autograd's gradient of a sum) and a scale of the other dtype."""
    rows, d = 300, 2048
    x, g = _randn(gen, (rows, d), dtype), _randn(gen, (rows, d), dtype)
    s = _randn(gen, (d,), dtype)
    if case == "unaligned_x":
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(rows, d)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    elif case == "broadcast_g":
        g = _randn(gen, (d,), dtype).expand(rows, d)
    else:
        s = s.to(torch.bfloat16 if dtype == torch.float32 else torch.float32)
    dx, ds = rmsnorm_bwd(x, s, g)
    want_dx, want_ds = ref.rmsnorm_backward_reference(x, s, g)
    assert dx.dtype == dtype and ds.dtype == s.dtype
    tol_dtype = torch.bfloat16 if torch.bfloat16 in (dtype, s.dtype) else torch.float32
    _rmsnorm_bwd_close(dx, ds, want_dx, want_ds, tol_dtype)


@pytest.mark.parametrize("rows,d,dtype", [
    (4096, 2048, torch.bfloat16),  # gemma-2b training
    (333, 3584, torch.bfloat16),
    (1000, 896, torch.float32),
])
def test_rmsnorm_backward_kernel_is_deterministic(gen, rows, d, dtype):
    """Two calls give bit-identical dx and dscale: the partial rows of dscale
    are added in one fixed order, with no floating-point atomics."""
    x, g = _randn(gen, (rows, d), dtype), _randn(gen, (rows, d), dtype)
    s = _randn(gen, (d,), dtype)
    first = rmsnorm_bwd(x, s, g)
    second = rmsnorm_bwd(x, s, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_rmsnorm_autograd_runs_both_kernels(gen):
    x = _randn(gen, (3, 7, 256), torch.float32).requires_grad_()
    s = _randn(gen, (256,), torch.float32).requires_grad_()
    before = (rmsnorm.launches, rmsnorm_bwd.launches)
    grads = torch.autograd.grad(ops.rmsnorm(x, s).square().sum(), (x, s))
    assert (rmsnorm.launches, rmsnorm_bwd.launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(ref.rmsnorm_reference(x, s).square().sum(), (x, s))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_gemma_gradient_on_the_card_matches_the_cpu(gen):
    """lm_loss and every parameter's gradient of a 2-layer, narrow fp32
    gemma-2b: the card (forward and backward kernels) against the CPU
    (plain versions), same weights and batch."""
    from repro_torch.models import get_api, smoke_config
    from repro_torch.models.transformer import lm_loss

    cfg = smoke_config("gemma-2b").replace(num_layers=2, d_model=256, num_heads=4,
                                           head_dim=64, d_ff=512, vocab_size=1024)
    cpu_model = get_api(cfg, device="cpu").init(seed=0)
    gpu_model = get_api(cfg, device="cuda").init(seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=torch.Generator().manual_seed(0))
    out = {}
    for name, model in (("cpu", cpu_model), ("card", gpu_model)):
        dev = "cpu" if name == "cpu" else "cuda"
        batch = {"tokens": toks[:, :-1].to(dev), "targets": toks[:, 1:].to(dev)}
        before = (flash_attention_bwd.launches, rmsnorm_bwd.launches)
        loss = lm_loss(model, batch)
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        after = (flash_attention_bwd.launches, rmsnorm_bwd.launches)
        assert after == (before if name == "cpu" else (before[0] + 2, before[1] + 5))
        out[name] = (loss.item(), {n: g.cpu() for n, g in zip(names, grads)})
    assert out["card"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    for n, g in out["cpu"][1].items():
        torch.testing.assert_close(out["card"][1][n], g, atol=1e-3 * g.abs().max().item(),
                                   rtol=1e-3)


def _wkv6_inputs(gen, B, H, T, K, dtype, log_w=None, s0=True):
    """As tests/test_kernels.py draws them: log_w = -exp(N(0, 1))."""
    r, k, v = (_randn(gen, (B, H, T, K), dtype) for _ in range(3))
    lw = (-torch.exp(_randn(gen, (B, H, T, K), torch.float32)) if log_w is None
          else torch.full((B, H, T, K), log_w, device="cuda"))
    u = _randn(gen, (H, K), torch.float32)
    state = (_randn(gen, (B, H, K, K), torch.float32) if s0
             else torch.zeros(B, H, K, K, device="cuda"))
    return r, k, v, lw, u, state


@pytest.mark.parametrize("B,H,T,K,dtype,kw", [
    (4, 32, 1024, 64, torch.bfloat16, {}),  # rwkv6-1.6b prefill
    (4, 32, 1024, 64, torch.float32, {}),
    (4, 32, 1, 64, torch.bfloat16, {}),  # a decode step
    (2, 3, 50, 16, torch.float32, {}),  # ragged T, the smoke head size
    (2, 3, 96, 32, torch.float32, {}),
    (2, 4, 64, 16, torch.bfloat16, dict(s0=False)),
    (1, 2, 32, 64, torch.float32, dict(log_w=-50.0, s0=False)),  # extreme decay
    (2, 3, 31, 64, torch.float32, {}),  # the edges of the kernel's 32-token chunks
    (2, 3, 32, 64, torch.bfloat16, {}),
    (2, 3, 33, 64, torch.float32, {}),
    (2, 3, 65, 64, torch.bfloat16, {}),
    (3, 2, 33, 16, torch.float32, {}),  # V = 16: one 16-column block is the whole state
    (3, 2, 65, 16, torch.bfloat16, {}),
    (1, 2, 65, 32, torch.float32, dict(log_w=-50.0)),
])
def test_wkv6_kernel_matches_plain(gen, B, H, T, K, dtype, kw):
    args = _wkv6_inputs(gen, B, H, T, K, dtype, **kw)
    before = wkv6.launches
    y, sf = wkv6(*args)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want_y, want_s = ref.wkv6_reference(*args)
    tol = 1e-4 if "log_w" in kw else (2e-4 if dtype == torch.float32 else 2e-2)
    assert y.dtype == dtype and sf.dtype == torch.float32
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    s_tol = min(tol, 2e-4)  # the state is fp32 whatever r's dtype
    torch.testing.assert_close(sf, want_s, atol=s_tol, rtol=s_tol)


@pytest.mark.parametrize("B,H,T,K", [(4, 32, 1024, 64), (4, 32, 1, 64), (2, 3, 50, 16)])
def test_wkv6_kernel_fp32_out_matches_plain(gen, B, H, T, K):
    """bf16 r/k/v with out_dtype=float32 (the rwkv6 model's call): the fp32 y
    of the kernel and of the plain version, both computed in fp32 from the
    same bf16 values."""
    args = _wkv6_inputs(gen, B, H, T, K, torch.bfloat16)
    before = wkv6.launches
    y, sf = wkv6(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want_y, want_s = ref.wkv6_reference(*args, out_dtype=torch.float32)
    assert y.dtype == want_y.dtype == torch.float32
    torch.testing.assert_close(y, want_y, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(sf, want_s, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("T,kernel", [(1, "step"), (31, "step"), (32, "chunk"), (1024, "chunk")])
def test_wkv6_picks_its_kernel_by_length(gen, T, kernel):
    """A sequence of wkv6.CHUNK tokens or more goes to the chunked kernel,
    a shorter one (the decode step) to the token-by-token kernel."""
    args = _wkv6_inputs(gen, 2, 4, T, 64, torch.bfloat16)
    before = (wkv6.launches, wkv6.chunk_launches, wkv6.step_launches)
    wkv6(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    chunk = int(kernel == "chunk")
    assert (wkv6.launches, wkv6.chunk_launches, wkv6.step_launches) == (
        before[0] + 1, before[1] + chunk, before[2] + 1 - chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_kernel_unaligned_inputs(gen, dtype):
    """Rows that do not start on 16 bytes (a view one element into a wider
    buffer) are staged with plain loads instead of cp.async."""
    args = list(_wkv6_inputs(gen, 2, 3, 45, 32, dtype))
    for i in range(4):
        wide = torch.zeros(*args[i].shape[:3], 33, dtype=args[i].dtype, device="cuda")
        wide[..., 1:] = args[i]
        args[i] = wide[..., 1:]
        assert args[i].data_ptr() % 16 != 0
    y, sf = wkv6(*args)
    want_y, want_s = ref.wkv6_reference(*args)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(sf, want_s, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("state", ["new", "in_place", "unaligned"])
@pytest.mark.parametrize("T,K", [(1, 64), (2, 64), (31, 64), (1, 16), (1, 32), (3, 32)])
def test_wkv6_step_kernel_matches_plain(gen, T, K, state):
    """The step kernels (T < wkv6.CHUNK) at T = 1, 2 and 31: into a new
    state, over s0 (the layer's cache), and from and into a state that does
    not start on 16 bytes (scalar accesses)."""
    B, H = 4, 32 if K == 64 else 3
    r, k, v, lw, u, s0 = _wkv6_inputs(gen, B, H, T, K, torch.bfloat16)
    if state == "unaligned":  # s0 from a storage offset by 4 bytes
        s0 = torch.cat([s0.new_zeros(1), s0.flatten()])[1:].view(s0.shape)
        assert s0.data_ptr() % 16 != 0 and s0.is_contiguous()
    want_y, want_s = ref.wkv6_reference(r, k, v, lw, u, s0, out_dtype=torch.float32)
    before = (wkv6.launches, wkv6.step_launches)
    s_out = None if state == "new" else s0
    y, sf = wkv6(r, k, v, lw, u, s0, s_out=s_out, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (wkv6.launches, wkv6.step_launches) == (before[0] + 1, before[1] + 1)
    assert state == "new" or sf is s0
    torch.testing.assert_close(y, want_y, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(sf, want_s, atol=2e-4, rtol=2e-4)


def test_wkv6_model_layout_and_state_in_place(gen):
    """ops.wkv6 reads (B, S, H, K) in place and writes y in that layout and
    the final state over s0."""
    r, k, v, lw, u, s0 = _wkv6_inputs(gen, 2, 4, 77, 64, torch.bfloat16)
    model = [t.transpose(1, 2).contiguous() for t in (r, k, v, lw)]
    want_y, want_s = ref.wkv6_reference(r, k, v, lw, u, s0)
    y, sf = ops.wkv6(*model, u, s0, s_out=s0)
    torch.cuda.synchronize()
    assert sf is s0 and y.shape == (2, 77, 4, 64) and y.is_contiguous()
    torch.testing.assert_close(y.float(), want_y.transpose(1, 2).float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(s0, want_s, atol=2e-4, rtol=2e-4)


def test_wkv6_raises_on_what_the_kernel_does_not_take(gen):
    r, k, v, lw, u, s0 = _wkv6_inputs(gen, 1, 2, 8, 128, torch.float32)
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw, u, s0)  # K = 128 has no kernel
    r, k, v, lw, u, s0 = _wkv6_inputs(gen, 1, 2, 8, 64, torch.float32)
    with pytest.raises(TypeError):
        wkv6(r.half(), k.half(), v.half(), lw, u, s0)
    with pytest.raises(RuntimeError, match="backward"):
        wkv6(r.requires_grad_(), k, v, lw, u, s0)
    with pytest.raises(ValueError):
        wkv6(r.detach(), k, v, lw, u.cpu(), s0)  # mixed devices
