"""WKV6 (RWKV-6 time mixing): the wrapper of the hand-written CUDA kernels.

Replaces the Pallas TPU kernel ``_wkv6_kernel`` / ``wkv6`` of
``src/repro/kernels/rwkv6_wkv.py``; the kernels are in ``csrc/wkv6.cu``,
whose head says what bounds them on the H100 and how their design answers
that.  A sequence of ``CHUNK`` tokens or more (prefill) goes to the chunked
kernel (3xTF32 tensor-core products over chunks of 32 tokens); the decode
step (T = 1) to the decode kernel (the state's columns split over blocks,
no staging); 1 < T < ``CHUNK`` to the token-by-token kernel.  Same contract
as the Pallas kernel, per (batch, head) with an fp32 state S (K, V):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_tᵀ

returning y in r's dtype and the final S in fp32.  The Pallas kernel's chunk
size is a TPU tiling choice and is not part of the contract.  Beyond it,
``out_dtype=torch.float32`` returns y in fp32 from bf16 r/k/v, as the JAX
rwkv6 model keeps y up to its group norm.

The JAX package leaves WKV6's gradient to XLA (it differentiates
``ssm.chunked_scan``); the port's backward is its own, ``csrc/wkv6_bwd.cu``
(:func:`wkv6_bwd`): two sweeps that write the state and its gradient at
every chunk's edge, then the chunks in parallel on the tensor cores, then a
carry of dlog_w across chunks.  :func:`wkv6` is differentiable:
when a gradient is wanted it runs the forward kernel inside a
``torch.autograd.Function`` that saves the inputs, and the backward kernel
rebuilds the states from them.  Without one (serving) the call is the
forward kernel alone.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version (:func:`repro_torch.kernels.ref.wkv6_reference`,
:func:`~repro_torch.kernels.ref.wkv6_backward_reference`).
``wkv6.launches`` counts forward launches (one per call on the card), split
into ``wkv6.chunk_launches`` and ``wkv6.step_launches`` by kernel;
``wkv6_bwd.launches`` counts backward launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import ref
from .build import load_library

HEAD_DIMS = (16, 32, 64)
CHUNK = 32  # the chunked kernel's tokens per chunk (C in csrc/wkv6.cu); below it, the step kernels
# (r/k/v dtype, y dtype) -> the kernel's dtype code
_DTYPE_CODE = {(torch.float32, torch.float32): 0, (torch.bfloat16, torch.bfloat16): 1,
               (torch.bfloat16, torch.float32): 2}
_BWD_DTYPE = {torch.float32: 0, torch.bfloat16: 1}  # r/k/v and dy each, for the backward kernel


@functools.lru_cache(maxsize=None)
def _bind() -> ctypes.CDLL:
    lib = load_library("wkv6")
    fn = lib.wkv6_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bind_bwd() -> ctypes.CDLL:
    lib = load_library("wkv6_bwd")
    fn = lib.wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.wkv6_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.wkv6_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, log_w, u, s0, s_out, out_dtype) -> None:
    if r.dim() != 4 or k.shape != r.shape or log_w.shape != r.shape:
        raise ValueError(f"expected r = k = log_w (B,H,T,K); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(log_w.shape)}")
    B, H, T, K = r.shape
    if v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"expected v (B,H,T,V) with r's (B,H,T); got {tuple(v.shape)}")
    V = v.shape[3]
    if u.shape != (H, K):
        raise ValueError(f"expected u ({H},{K}); got {tuple(u.shape)}")
    if s0.shape != (B, H, K, V) or (s_out is not None and s_out.shape != s0.shape):
        raise ValueError(f"expected s0 (and s_out) ({B},{H},{K},{V}); got {tuple(s0.shape)}")
    if T < 1:
        raise ValueError("wkv6 needs T >= 1")
    tensors = (r, k, v, log_w, u, s0) + ((s_out,) if s_out is not None else ())
    if len({t.device for t in tensors}) != 1:
        raise ValueError("wkv6 inputs must be on one device")
    if not (r.dtype == k.dtype == v.dtype):
        raise TypeError("r, k and v must have one dtype")
    if any(t.dtype != torch.float32 for t in tensors[3:]):
        raise TypeError("log_w, u, s0 and s_out must be float32")
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"out_dtype must be None (r's dtype) or float32, not {out_dtype}")


def _launch(r, k, v, log_w, u, s0, y, s_out) -> None:
    B, H, T, K = r.shape
    code = _DTYPE_CODE.get((r.dtype, y.dtype))
    if code is None:
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16 r/k/v, not {r.dtype}")
    if K not in HEAD_DIMS or v.shape[3] != K:
        raise ValueError(f"wkv6 kernel takes K = V in {HEAD_DIMS}, not K={K}, V={v.shape[3]}")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w), ("y", y)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last axis must be contiguous")
    for name, t in (("u", u), ("s0", s0), ("s_out", s_out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _bind()
    err = lib.wkv6_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
        code, B, H, T, K,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *log_w.stride()[:3],
        *y.stride()[:3],
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err:
        msg = lib.wkv6_error_string(err).decode()
        raise RuntimeError(f"wkv6 kernel launch failed: {msg} ({err})")
    wkv6.launches += 1
    if T >= CHUNK:
        wkv6.chunk_launches += 1
    else:
        wkv6.step_launches += 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def _forward(r, k, v, log_w, u, s0, s_out, out_dtype):
    """(y, s_final): the kernel on the card, the plain version on the CPU."""
    if r.device.type == "cpu":
        y, s_final = ref.wkv6_reference(r, k, v, log_w, u, s0, out_dtype=out_dtype)
        if s_out is None:
            return y, s_final
        return y, s_out.copy_(s_final)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    y = torch.empty_like(v, dtype=out_dtype or r.dtype)
    if s_out is None:
        s_out = torch.empty_like(s0, memory_format=torch.contiguous_format)
    _launch(r, k, v, log_w, u, s0, y, s_out)
    return y, s_out


class _WKV6(torch.autograd.Function):
    """The forward kernel, saving its inputs, and the backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0, out_dtype):
        y, s_final = _forward(r, k, v, log_w, u, s0, None, out_dtype)
        ctx.save_for_backward(r, k, v, log_w, u, s0)
        ctx.set_materialize_grads(False)  # an unused output's gradient stays None
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds_final):
        return (*wkv6_bwd(*ctx.saved_tensors, dy, ds_final), None)


def wkv6(
    r: torch.Tensor,  # (B, H, T, K)
    k: torch.Tensor,  # (B, H, T, K)
    v: torch.Tensor,  # (B, H, T, V)
    log_w: torch.Tensor,  # (B, H, T, K) fp32, entries < 0
    u: torch.Tensor,  # (H, K) fp32
    s0: torch.Tensor,  # (B, H, K, V) fp32
    *,
    s_out: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence.  Returns (y (B,H,T,V) in ``out_dtype``, r's dtype
    by default, with v's memory layout; s_final (B,H,K,V) fp32).  With
    ``s_out`` the final state is written there and returned; ``s_out`` may
    be ``s0`` itself (the layer's cache, updated in place).  Differentiable
    in r, k, v, log_w, u and s0, without ``s_out``."""
    _check(r, k, v, log_w, u, s0, s_out, out_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, log_w, u, s0)):
        if s_out is not None:
            raise RuntimeError("wkv6: a state written in place (s_out) takes no gradient")
        return _WKV6.apply(r, k, v, log_w, u, s0, out_dtype)
    return _forward(r, k, v, log_w, u, s0, s_out, out_dtype)


wkv6.launches = wkv6.chunk_launches = wkv6.step_launches = 0


def wkv6_bwd(
    r: torch.Tensor,  # (B, H, T, K)
    k: torch.Tensor,  # (B, H, T, K)
    v: torch.Tensor,  # (B, H, T, V)
    log_w: torch.Tensor,  # (B, H, T, K) fp32
    u: torch.Tensor,  # (H, K) fp32
    s0: torch.Tensor,  # (B, H, K, V) fp32
    dy: Optional[torch.Tensor],  # (B, H, T, V) the gradient of y, None for zeros
    ds_final: Optional[torch.Tensor],  # (B, H, K, V) the gradient of s_final, None for zeros
) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv in r's dtype and the inputs' layouts; dlog_w fp32 in
    log_w's layout; du (H, K) and ds0 fp32).  On the card: three launches
    (the two state sweeps, the chunks in parallel, the carry of dlog_w
    across chunks) counted as one in ``wkv6_bwd.launches``.  They write one
    du part per (b, h), summed here over b by a reduction with no atomics, so
    two calls give bit-identical gradients."""
    _check(r, k, v, log_w, u, s0, None, None)
    B, H, T, K = r.shape
    if dy is not None and (dy.shape != v.shape or dy.device != r.device):
        raise ValueError(f"expected dy {tuple(v.shape)} on {r.device}; got {tuple(dy.shape)}")
    if ds_final is not None and (ds_final.shape != s0.shape or ds_final.device != r.device):
        raise ValueError(f"expected ds_final {tuple(s0.shape)} on {r.device}; "
                         f"got {tuple(ds_final.shape)}")
    if r.device.type == "cpu":
        return ref.wkv6_backward_reference(r, k, v, log_w, u, s0, dy, ds_final)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd runs on cuda or cpu, not {r.device}")
    if r.dtype not in _BWD_DTYPE or K not in HEAD_DIMS or v.shape[3] != K:
        raise TypeError(f"wkv6_bwd kernel takes float32 or bfloat16 r/k/v and K = V in "
                        f"{HEAD_DIMS}, not {r.dtype}, K={K}, V={v.shape[3]}")
    if dy is None:
        dy = torch.zeros_like(v, dtype=torch.float32)
    elif dy.dtype not in _BWD_DTYPE:
        raise TypeError(f"wkv6_bwd kernel takes a float32 or bfloat16 dy, not {dy.dtype}")
    elif dy.stride(3) != 1:  # autograd may hand in any layout, even a broadcast
        dy = dy.contiguous()
    if ds_final is not None:
        ds_final = _aligned(ds_final.float().contiguous())
    s0 = _aligned(s0)  # the kernel reads s0 and ds_final 16 bytes at a time
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last axis must be contiguous")
    for name, t in (("u", u), ("s0", s0)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dr, dk, dv, dlog_w = (torch.empty_like(t) for t in (r, k, v, log_w))
    du_part = torch.empty((B, H, K), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0, memory_format=torch.contiguous_format)
    lib = _bind_bwd()
    # the chunks' edge states and summaries, freed on return (the caching
    # allocator keeps the block for the next call)
    scratch = torch.empty(lib.wkv6_bwd_scratch_floats(B, H, T, K), dtype=torch.float32,
                          device=r.device)
    strides = (ctypes.c_longlong * 27)(
        *(s for t in (r, k, v, log_w, dy, dr, dk, dv, dlog_w) for s in t.stride()[:3]))
    err = lib.wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), dy.data_ptr(), ds_final.data_ptr() if ds_final is not None else None,
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlog_w.data_ptr(), du_part.data_ptr(),
        ds0.data_ptr(), scratch.data_ptr(), _BWD_DTYPE[r.dtype], _BWD_DTYPE[dy.dtype],
        B, H, T, K, strides, torch.cuda.current_stream(r.device).cuda_stream,
    )
    if err:
        msg = lib.wkv6_bwd_error_string(err).decode()
        raise RuntimeError(f"wkv6_bwd kernel launch failed: {msg} ({err})")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dlog_w, du_part.sum(0), ds0


wkv6_bwd.launches = 0
