"""The hand-written kernels against their plain versions on the card.

These need a CUDA device, ``nvcc`` and ``triton``; without a card they skip
with a reason.  Run them on the GPU with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerances: 2e-5 in float32 and 2e-2 in bfloat16, as in
``tests/test_kernels.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, ops, ref, rmsnorm  # noqa: E402

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
