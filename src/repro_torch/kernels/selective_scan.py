"""The selective scan of the Mamba-1 (S6) mixer: the wrapper of the
hand-written CUDA kernels ``csrc/selective_scan.cu`` (the forward) and
``csrc/selective_scan_bwd.cu`` (its backward), whose heads say what bounds
them on the H100 and how their design answers that.

It replaces no TPU kernel: the JAX package computes the scan in XLA
(``repro.models.ssm``, an associative scan in chunks of 64 tokens) and has
no Pallas kernel for it.  Per batch row b, channel d and state n, in fp32
from the state h0:

    h_t = exp(dt_t A[d, n]) h_{t-1} + dtx_t B_t[n],    y_t[d] = sum_n h_t C_t[n]

returning y (B, S, d_in) and h_S (B, d_in, N).  A prefill (S = 1024 at
jamba's serving and training shapes) and a decode step (S = 1, from the
cache's state) take the same kernel.  :func:`selective_scan` is
differentiable: when a gradient is wanted it runs the forward kernel inside
a ``torch.autograd.Function`` that also keeps the state before every
``CHUNK``-th token (B, ceil(S / CHUNK), d_in, N), and the backward kernel
starts each chunk from it.  Without one (serving) the call is the forward
kernel alone.

The forward kernel's one choice is the states a thread holds
(:func:`fwd_states`); the backward's is fixed (4).  Both kernels copy their
rows to shared memory in 16-byte pieces, so the wrapper hands them
contiguous tensors at 16-byte aligned addresses (:func:`_aligned` copies a
view that starts elsewhere).

On a CUDA tensor each wrapper launches its kernels or raises; on a CPU
tensor it runs the plain version (:func:`repro_torch.kernels.ref.selective_scan_reference`,
:func:`~repro_torch.kernels.ref.selective_scan_backward_reference`);
:func:`~repro_torch.kernels.ref.selective_scan_chunked_reference` and
:func:`~repro_torch.kernels.ref.selective_scan_backward_chunked_reference`
mirror the kernels' algebra on the CPU for the tests.
``selective_scan.launches`` counts forward calls on the card (one launch
each); ``selective_scan_bwd.launches`` counts backward calls (two launches
each, the sweep and the ordered sum of its parts).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import ref
from .build import load_library

STATE_DIMS = (4, 8, 16)  # N, the kernels' template instantiations
CHUNK = 64  # tokens between the states the forward keeps for the backward (JAX's chunk)
SUB = 16  # tokens the forward stages at a time


@functools.lru_cache(maxsize=None)
def _bind() -> ctypes.CDLL:
    lib = load_library("selective_scan")
    fn = lib.selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bind_bwd() -> ctypes.CDLL:
    lib = load_library("selective_scan_bwd")
    fn = lib.selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.selective_scan_bwd_channels.argtypes = [ctypes.c_int]
    lib.selective_scan_bwd_channels.restype = ctypes.c_int
    lib.selective_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(dt, dtx, Bm, Cm, A, h0) -> None:
    if dt.dim() != 3 or dtx.shape != dt.shape:
        raise ValueError(f"expected dt = dtx (B,S,d_in); got {tuple(dt.shape)}, "
                         f"{tuple(dtx.shape)}")
    B, S, D = dt.shape
    if A.dim() != 2 or A.shape[0] != D:
        raise ValueError(f"expected A ({D},N); got {tuple(A.shape)}")
    N = A.shape[1]
    if Bm.shape != (B, S, N) or Cm.shape != (B, S, N):
        raise ValueError(f"expected B and C ({B},{S},{N}); got {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    if h0.shape != (B, D, N):
        raise ValueError(f"expected h0 ({B},{D},{N}); got {tuple(h0.shape)}")
    if S < 1:
        raise ValueError("selective_scan needs S >= 1")
    tensors = (dt, dtx, Bm, Cm, A, h0)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("selective_scan inputs must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("selective_scan takes float32 dt, dtx, B, C, A and h0")


def fwd_states(S: int, N: int) -> int:
    """The states a thread of the forward kernel holds: 8 (N / 8 lanes a
    channel; 4 at N 4, and for fewer tokens than a stage, as a decode
    step's, whose one token wants the threads)."""
    return min(N, 8) if S >= SUB else 4


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address, copied if it is not:
    the kernels stage its rows with 16-byte ``cp.async``."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(dt, dtx, Bm, Cm, A, h0, keep: bool):
    """(y, h_S, the states before every CHUNK-th token or None): the forward
    kernel."""
    B, S, D = dt.shape
    N = A.shape[1]
    if N not in STATE_DIMS:
        raise ValueError(f"selective_scan kernel takes N in {STATE_DIMS}, not {N}")
    dt, dtx, Bm, Cm = (_aligned(t) for t in (dt, dtx, Bm, Cm))
    A, h0 = A.contiguous(), h0.contiguous()
    y = torch.empty_like(dt)
    h_out = torch.empty_like(h0)
    hs = (torch.empty((B, -(-S // CHUNK), D, N), dtype=torch.float32, device=dt.device)
          if keep else None)
    lib = _bind()
    err = lib.selective_scan_fwd(
        dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), hs.data_ptr() if keep else None,
        B, S, D, N, CHUNK, fwd_states(S, N), _stream(dt))
    if err:
        msg = lib.selective_scan_error_string(err).decode()
        raise RuntimeError(f"selective_scan kernel launch failed: {msg} ({err})")
    selective_scan.launches += 1
    return y, h_out, hs


def _forward(dt, dtx, Bm, Cm, A, h0, keep: bool):
    """(y, h_S, saved states): the kernel on the card, the plain version
    (which keeps no states) on the CPU."""
    if dt.device.type == "cpu":
        return (*ref.selective_scan_reference(dt, dtx, Bm, Cm, A, h0), None)
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu, not {dt.device}")
    return _launch(dt, dtx, Bm, Cm, A, h0, keep)


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, keeping its inputs and the chunks' first states,
    and the backward kernel."""

    @staticmethod
    def forward(ctx, dt, dtx, Bm, Cm, A, h0):
        y, h_s, hs = _forward(dt, dtx, Bm, Cm, A, h0, keep=True)
        ctx.save_for_backward(dt, dtx, Bm, Cm, A, h0, hs)
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        return y, h_s

    @staticmethod
    def backward(ctx, dy, dh):
        dt, dtx, Bm, Cm, A, h0, hs = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(dt)
        return selective_scan_bwd(dt, dtx, Bm, Cm, A, h0, dy, dh, hs=hs)


def selective_scan(
    dt: torch.Tensor,  # (B, S, d_in) fp32
    dtx: torch.Tensor,  # (B, S, d_in) fp32
    Bm: torch.Tensor,  # (B, S, N) fp32
    Cm: torch.Tensor,  # (B, S, N) fp32
    A: torch.Tensor,  # (d_in, N) fp32, entries < 0
    h0: torch.Tensor,  # (B, d_in, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan: (y (B, S, d_in), h_S (B, d_in, N)), fp32.
    Differentiable in every input."""
    _check(dt, dtx, Bm, Cm, A, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, dtx, Bm, Cm, A, h0)):
        return _SelectiveScan.apply(dt, dtx, Bm, Cm, A, h0)
    return _forward(dt, dtx, Bm, Cm, A, h0, keep=False)[:2]


selective_scan.launches = 0


def selective_scan_bwd(
    dt: torch.Tensor,  # (B, S, d_in) fp32
    dtx: torch.Tensor,  # (B, S, d_in) fp32
    Bm: torch.Tensor,  # (B, S, N) fp32
    Cm: torch.Tensor,  # (B, S, N) fp32
    A: torch.Tensor,  # (d_in, N) fp32
    h0: torch.Tensor,  # (B, d_in, N) fp32
    dy: torch.Tensor,  # (B, S, d_in): the gradient of y
    dh: Optional[torch.Tensor] = None,  # (B, d_in, N): the gradient of h_S, None for zeros
    *,
    hs: Optional[torch.Tensor] = None,  # the forward's states before every CHUNK-th token
) -> Tuple[torch.Tensor, ...]:
    """(ddt, ddtx (B, S, d_in), dB, dC (B, S, N), dA (d_in, N), dh0 (B,
    d_in, N)), fp32.  On the card ``hs`` comes from the forward in
    :func:`selective_scan` (without it a forward launch makes it first);
    the sweep and the ordered sums of its per-block parts of dB, dC and dA,
    counted as one in ``selective_scan_bwd.launches``.  No atomics: two
    calls give bit-identical gradients."""
    _check(dt, dtx, Bm, Cm, A, h0)
    B, S, D = dt.shape
    N = A.shape[1]
    if dy.shape != dt.shape or dy.device != dt.device:
        raise ValueError(f"expected dy {tuple(dt.shape)} on {dt.device}; got {tuple(dy.shape)}")
    if dh is not None and (dh.shape != h0.shape or dh.device != dt.device):
        raise ValueError(f"expected dh {tuple(h0.shape)} on {dt.device}; got {tuple(dh.shape)}")
    if dt.device.type == "cpu":
        return ref.selective_scan_backward_reference(dt, dtx, Bm, Cm, A, h0, dy, dh)
    if dt.device.type != "cuda":
        raise ValueError(f"selective_scan_bwd runs on cuda or cpu, not {dt.device}")
    if N not in STATE_DIMS:
        raise ValueError(f"selective_scan_bwd kernel takes N in {STATE_DIMS}, not {N}")
    if hs is None:
        hs = _launch(dt, dtx, Bm, Cm, A, h0, keep=True)[2]
    if hs.shape != (B, -(-S // CHUNK), D, N):
        raise ValueError(f"expected hs ({B},{-(-S // CHUNK)},{D},{N}); got {tuple(hs.shape)}")
    dt, dtx, Bm, Cm, hs = (_aligned(t) for t in (dt, dtx, Bm, Cm, hs))
    A = A.contiguous()
    dy = _aligned(dy.float())  # autograd may hand in any layout, even a broadcast
    if dh is not None:
        dh = dh.float().contiguous()
    lib = _bind_bwd()
    groups = -(-D // lib.selective_scan_bwd_channels(N))
    ddt, ddtx = torch.empty_like(dt), torch.empty_like(dtx)
    dB, dC, dA = torch.empty_like(Bm), torch.empty_like(Cm), torch.empty_like(A)
    dh0 = torch.empty((B, D, N), dtype=torch.float32, device=dt.device)
    # the per-row dA and per-block dB, dC parts, freed on return
    da_part = torch.empty((B, D, N), dtype=torch.float32, device=dt.device)
    dbc_part = torch.empty((groups, B, S, 2, N), dtype=torch.float32, device=dt.device)
    err = lib.selective_scan_bwd(
        dt.data_ptr(), dtx.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
        hs.data_ptr(), dy.data_ptr(), dh.data_ptr() if dh is not None else None,
        ddt.data_ptr(), ddtx.data_ptr(), dB.data_ptr(), dC.data_ptr(), dA.data_ptr(),
        dh0.data_ptr(), da_part.data_ptr(), dbc_part.data_ptr(), B, S, D, N, CHUNK,
        _stream(dt))
    if err:
        msg = lib.selective_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"selective_scan_bwd kernel launch failed: {msg} ({err})")
    selective_scan_bwd.launches += 1
    return ddt, ddtx, dB, dC, dA, dh0


selective_scan_bwd.launches = 0
