"""The bf16 flash-attention backward kernels' algebra, mirrored on the CPU
(``ref.mha_backward_tiled``: 64 x 64 tile pairs, S^T and dP^T formed once per
pair, P^T and dS^T rounded to bf16, a group sum in head order), against the
plain backward ``ref.mha_backward_reference`` and ``jax.vjp`` of the JAX
oracle ``repro.kernels.ref.mha_reference``.

Inputs are drawn with numpy from a fixed seed and handed to both stacks.
Tolerances: 1e-5 in fp32 (the mirror and the oracles sum a few hundred
products in other orders), and in bf16 the card's 2e-2 absolute plus 2e-2
relative, which ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
kernels to.  The shapes end inside a tile, so the kernels' ragged edges and
their causal and window tile bounds are all walked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32_TOL, BF16_TOL = 1e-5, 2e-2
TILE = 64

CASES = [  # (B, Hq, Hkv, Sq, Sk, D, options)
    (1, 2, 2, 150, 150, 16, {}),
    (1, 2, 2, 130, 130, 32, dict(causal=False)),
    (1, 2, 1, 200, 200, 16, dict(window=70)),
    (1, 2, 2, 140, 140, 16, dict(softcap=5.0)),
    (1, 4, 2, 160, 160, 16, dict(window=40, softcap=3.0)),  # GQA
    (2, 4, 1, 100, 100, 32, {}),  # MQA, as gemma-2b
    (1, 2, 1, 100, 170, 16, {}),  # ragged: Sq < Sk
    (1, 2, 2, 170, 100, 16, dict(causal=False)),  # Sq > Sk
    (1, 2, 2, 170, 100, 16, {}),
    (1, 2, 2, 150, 150, 16, dict(causal=False, window=50)),
    (1, 8, 2, 129, 129, 64, {}),  # GQA 8/2, one row into the third tile
    (1, 2, 1, 70, 70, 256, {}),  # gemma-2b's head_dim
]


def _ids(cases):
    return [f"B{c[0]}-Hq{c[1]}-Hkv{c[2]}-Sq{c[3]}-Sk{c[4]}-D{c[5]}-{c[6] or 'causal'}"
            for c in cases]


def _inputs(seed, B, Hq, Hkv, Sq, Sk, D, dtype, kw):
    """q, k, v, dO in ``dtype``, and the forward's o and LSE from the plain
    forward, as the kernels receive them; numpy copies of q, k, v, dO in
    fp32."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D), (B, Hq, Sq, D))]
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrs)
    o, lse = ref.mha_reference(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, lse, do), [t.float().numpy() for t in (q, k, v, do)]


def _jax_grads(arrs, kw):
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha_reference(a, b, c, **kw), q, k, v)
    return vjp(do)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,kw", CASES, ids=_ids(CASES))
def test_tiled_mirror_matches_plain_and_jax_fp32(B, Hq, Hkv, Sq, Sk, D, kw):
    args, arrs = _inputs(0, B, Hq, Hkv, Sq, Sk, D, torch.float32, kw)
    got = ref.mha_backward_tiled(*args, **kw)
    want = ref.mha_backward_reference(*args, **kw)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, args[:3]):
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, _jax_grads(arrs, kw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL, rtol=F32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D,kw", CASES, ids=_ids(CASES))
def test_tiled_mirror_matches_plain_and_jax_bf16(B, Hq, Hkv, Sq, Sk, D, kw):
    """bf16 inputs: the mirror rounds P^T and dS^T (and dS) to bf16 before
    their products, as the kernels do; it stays within the card's tolerance
    of the plain backward (fp32 from the same bf16 inputs) and of jax.vjp in
    fp32 on those inputs."""
    args, arrs = _inputs(1, B, Hq, Hkv, Sq, Sk, D, torch.bfloat16, kw)
    got = ref.mha_backward_tiled(*args, **kw)
    want = ref.mha_backward_reference(*args, **kw)
    for g, w, x in zip(got, want, args[:3]):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        torch.testing.assert_close(g.float(), w.float(), atol=BF16_TOL, rtol=BF16_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, _jax_grads(arrs, kw)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w), atol=BF16_TOL,
                                   rtol=BF16_TOL, err_msg=name)


def test_tiled_mirror_rounds_where_the_kernels_do():
    """In bf16 the mirror differs from the plain backward only by the bf16
    rounding of P and dS: with the rounding taken out (fp32 inputs of the
    same values) the two agree to fp32 precision."""
    args, _ = _inputs(2, 1, 2, 1, 150, 150, 32, torch.bfloat16, {})
    rounded = ref.mha_backward_tiled(*args)
    unrounded = ref.mha_backward_tiled(*(t.float() for t in args))
    plain = ref.mha_backward_reference(*(t.float() for t in args))
    for r, u, w in zip(rounded, unrounded, plain):
        torch.testing.assert_close(u, w, atol=F32_TOL, rtol=F32_TOL)
        assert (r.float() - u).abs().max() > 0


WALKS = [  # (Sq, Sk, causal, window)
    (150, 150, True, None), (150, 150, False, None), (200, 200, True, 70),
    (200, 200, False, 70), (100, 170, True, None), (170, 100, True, None),
    (170, 100, False, 30), (64, 64, True, 1), (300, 300, True, 128), (129, 300, False, 5),
]


@pytest.mark.parametrize("Sq,Sk,causal,window", WALKS)
def test_tile_walks_visit_exactly_the_tiles_with_a_visible_pair(Sq, Sk, causal, window):
    """The dK/dV walk (q tiles per key tile) and the dQ walk (key tiles per q
    tile) both visit every tile pair that holds a visible (q, k) pair, and no
    other."""
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    nq, nk = -(-Sq // TILE), -(-Sk // TILE)
    want = {(i, j) for i in range(nq) for j in range(nk)
            if ok[i * TILE:(i + 1) * TILE, j * TILE:(j + 1) * TILE].any()}
    dkdv = {(i, j) for j in range(nk)
            for i in ref.dkdv_q_tiles(j * TILE, Sq, Sk, causal, window, TILE)}
    dq = {(i, j) for i in range(nq)
          for j in ref.dq_key_tiles(i * TILE, Sq, Sk, causal, window, TILE)}
    assert dkdv == want
    assert dq == want
