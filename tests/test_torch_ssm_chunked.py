"""The selective-scan kernels' chunked algebra, mirrored on the CPU
(``ref.selective_scan_chunked_reference`` and
``ref.selective_scan_backward_chunked_reference``: the state kept before
every 64th token, each chunk run forward from its saved state to the first
state of each 16-token sub-chunk, each sub-chunk run again from its first
state and walked back),
against JAX's scan built from ``repro.models.ssm`` (``scan_chunk`` inside
``chunked_scan``, as ``mamba_block`` runs it), against ``jax.vjp`` of it,
and against the plain versions that the card is held to
(``ref.selective_scan_reference``, ``ref.selective_scan_backward_reference``).

Inputs are drawn with numpy from a fixed seed: S = 1, 64, 65, 100, 127 at
N = 4, 8, 16 and S = 1024 at jamba's N = 16, decays model-like, near 0 and
near 1, h0 and the gradient of h_S zero or random.  Each case runs the
backward mirror at the kernels' chunk and sub-chunk (64, 16) and with
chunks of one sub-chunk (16, 16).  Tolerances, the bounds
``chip_smoke.py`` holds the kernels to: y and h_S within 1e-5 of max|y| (the
scans multiply the same decays in another order), each gradient within
1e-4 of its largest entry.
"""
import importlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

ss = importlib.import_module("repro_torch.kernels.selective_scan")

SCAN_REL, SCAN_BWD_REL = 1e-5, 1e-4
NAMES = ("ddt", "ddtx", "dB", "dC", "dA", "dh0")
SHAPES = [(S, N) for S in (1, 64, 65, 100, 127) for N in (4, 8, 16)] + [(1024, 16)]
REGIMES = ("model", "near 0", "near 1")


def _inputs(S, N, regime, random_state, B=2, D=8, seed=0):
    """(dt, dtx, B, C, A, h0, dy, dh) as numpy fp32; dh None unless
    ``random_state`` (which also draws h0)."""
    rng = np.random.default_rng(seed + 7 * S + N)
    if regime == "near 0":
        dt = rng.uniform(5.0, 10.0, (B, S, D))
    elif regime == "near 1":
        dt = rng.uniform(1e-5, 1e-4, (B, S, D))
    else:
        dt = np.log1p(np.exp(rng.normal(size=(B, S, D))))
    dtx = dt * rng.normal(size=(B, S, D))
    bm, cm = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    A = -np.arange(1, N + 1) * rng.uniform(0.5, 1.5, (D, N))
    h0 = rng.normal(size=(B, D, N)) if random_state else np.zeros((B, D, N))
    dy = rng.normal(size=(B, S, D))
    dh = rng.normal(size=(B, D, N)).astype(np.float32) if random_state else None
    return (*(a.astype(np.float32) for a in (dt, dtx, bm, cm, A, h0, dy)), dh)


def _jax_scan(dt, dtx, bm, cm, A, h0):
    """JAX's selective scan as ``mamba_block`` runs it: ``chunked_scan`` in
    chunks of 64 with ``scan_chunk``."""
    def jchunk(h, ac):
        dt_c, dtx_c, b_c, c_c = ac
        states, h2 = jssm.scan_chunk(jnp.exp(dt_c[..., None] * A),
                                     dtx_c[..., None] * b_c[:, :, None, :], h)
        return h2, jnp.einsum("bqdn,bqn->bqd", states, c_c)

    return jssm.chunked_scan((dt, dtx, bm, cm), h0, jchunk, 64)


_jax_forward = jax.jit(_jax_scan)  # compiled once a shape, as the cases repeat shapes
_jax_backward = jax.jit(lambda args, cts: jax.vjp(_jax_scan, *args)[1](cts))


def _close(got, want, rel, scale, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), np.asarray(want), rtol=0,
                               atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("random_state", [False, True], ids=["zero_h0", "random_h0"])
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S,N", SHAPES)
def test_chunked_forward_matches_jax_and_plain(S, N, regime, random_state):
    """The forward mirror: y and h_S against JAX's chunked scan and the
    plain version; the kept states hs, hs[0] = h0."""
    dt, dtx, bm, cm, A, h0, _, _ = _inputs(S, N, regime, random_state)
    want_y, want_h = (np.asarray(a) for a in _jax_forward(*(jnp.asarray(a) for a in
                                                           (dt, dtx, bm, cm, A, h0))))
    args = [torch.from_numpy(a) for a in (dt, dtx, bm, cm, A, h0)]
    plain_y, plain_h = ref.selective_scan_reference(*args)
    top = np.abs(want_y).max()
    y, h, hs = ref.selective_scan_chunked_reference(*args)
    assert y.shape == (2, S, 8) and h.shape == (2, 8, N)
    assert hs.shape == (2, -(-S // ref.KERNEL_CHUNK), 8, N)
    for what, got, want in (("y", y, want_y), ("h_S", h, want_h),
                            ("plain y", y, plain_y), ("plain h_S", h, plain_h)):
        _close(got, want, SCAN_REL, top, what)
    assert torch.equal(hs[:, 0], args[5])


@pytest.mark.parametrize("random_state", [False, True], ids=["zero_h0_no_dh", "random_h0_dh"])
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("S,N", SHAPES)
def test_chunked_backward_matches_jax_vjp_and_plain(S, N, regime, random_state):
    """The backward mirror, at the kernels' 64-token chunks of 16-token
    sub-chunks and at chunks of one sub-chunk, against ``jax.vjp`` of JAX's
    chunked scan and against the plain backward: every gradient
    within 1e-4 of its largest entry (dh None is a zero gradient of h_S)."""
    dt, dtx, bm, cm, A, h0, dy, dh = _inputs(S, N, regime, random_state)
    want = [np.asarray(g) for g in _jax_backward(
        tuple(jnp.asarray(a) for a in (dt, dtx, bm, cm, A, h0)),
        (jnp.asarray(dy), jnp.asarray(dh if dh is not None else 0 * h0)))]
    args = [torch.from_numpy(a) for a in (dt, dtx, bm, cm, A, h0)]
    dyt, dht = torch.from_numpy(dy), None if dh is None else torch.from_numpy(dh)
    plain = ref.selective_scan_backward_reference(*args, dyt, dht)
    for chunk in (ref.KERNEL_CHUNK, ref.KERNEL_SUB):
        got = ref.selective_scan_backward_chunked_reference(*args, dyt, dht, chunk=chunk)
        for name, g, w, p in zip(NAMES, got, want, plain):
            assert g.shape == p.shape and g.dtype == torch.float32, name
            scale = max(np.abs(w).max(), 1e-30)
            _close(g, w, SCAN_BWD_REL, scale, f"{name} against JAX, chunks of {chunk}")
            _close(g, p, SCAN_BWD_REL, max(p.abs().max().item(), 1e-30),
                   f"{name} against the plain backward, chunks of {chunk}")


def _constant(source: str, name: str) -> int:
    text = (build.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_chunk_lengths_agree():
    """The wrapper's, the mirror's and both kernel sources' chunk (JAX's 64,
    so the saved states are no larger than JAX's chunk boundaries) and
    sub-chunk, a chunk being whole sub-chunks."""
    assert ss.CHUNK == ref.KERNEL_CHUNK == 64 and ss.SUB == ref.KERNEL_SUB
    for source in ("selective_scan.cu", "selective_scan_bwd.cu"):
        assert _constant(source, "CHUNK") == ss.CHUNK, source
        assert _constant(source, "SUB") == ss.SUB, source
    assert ss.CHUNK % ss.SUB == 0


@pytest.mark.parametrize("S", [1, 15, 16, 1024])
@pytest.mark.parametrize("N", [4, 8, 16])
def test_fwd_states_take_an_instantiation(S, N):
    """The forward's states a thread name one of the (N, states) pairs the
    kernel source instantiates: 8 from a stage of tokens (4 at N 4), 4 for
    fewer, as a decode step's one token."""
    text = (build.CSRC / "selective_scan.cu").read_text()
    built = {(int(n), int(k)) for n, k in re.findall(r"return launch<(\d+), (\d+)>", text)}
    spt = ss.fwd_states(S, N)
    assert (N, spt) in built and N % spt == 0
    assert spt == (min(N, 8) if S >= ss.SUB else 4)


@pytest.mark.parametrize("offset", [0, 1, 3, 4])
def test_aligned_copies_views_off_16_bytes(offset):
    """``_aligned`` hands the kernels a contiguous tensor at a 16-byte
    address: a view ``offset`` floats into a projection's row (a decode
    step's B, sliced after dt's columns) is copied when it starts off 16
    bytes, and kept as it is otherwise."""
    proj = torch.arange(64, dtype=torch.float32).reshape(1, 1, 64)
    assert proj.data_ptr() % 16 == 0
    view = proj[..., offset:offset + 16]
    got = ss._aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, view)
    assert (got.data_ptr() == view.data_ptr()) == (offset % 4 == 0)
