"""Flash attention, forward and backward: the wrappers of the hand-written
CUDA kernels.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``; the kernels are
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward, which the JAX package leaves to XLA), whose heads say what bounds
each on the H100 and how its design answers that.  Same contract as the
Pallas kernel: causal or full attention, sliding window, logit softcap,
GQA/MQA, fp32 accumulation, output in q's dtype, q and k positions both
starting at 0.

:func:`flash_attention` is differentiable: when a gradient is wanted it runs
the forward with its row log-sum-exp (LSE) output inside a
``torch.autograd.Function`` whose backward is :func:`flash_attention_bwd`.
Without one (serving) the forward writes no LSE.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs the plain version (:func:`repro_torch.kernels.ref.mha_reference`,
:func:`~repro_torch.kernels.ref.mha_backward_reference`).
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import ref
from .build import load_library

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _bind() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bind_bwd() -> ctypes.CDLL:
    lib = load_library("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Hq,Sq,D), k = v (B,Hkv,Sk,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v must agree on batch and head_dim")
    if Hq % k.shape[1]:
        raise ValueError("num q heads must be a multiple of num kv heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k and v must have one dtype")


def _kernel_dtype_and_dim(q: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, "
                         f"not {q.shape[-1]}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """The kernels read 16-byte vectors along head_dim."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _launch(q, k, v, out, lse, *, causal, window, softcap, scale) -> None:
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _kernel_dtype_and_dim(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")
        if not _rows_aligned(t):
            raise ValueError(f"{name}: rows must start on 16-byte boundaries")
    lib = _bind()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        _DTYPE_CODE[q.dtype], B, Hq, Hkv, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(causal), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    flash_attention.launches += 1


def _forward(q, k, v, *, causal, window, softcap, scale, with_lse: bool):
    """out, or (out, lse) with ``with_lse``: the kernel on the card, the
    plain version on the CPU."""
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, window=window, softcap=softcap,
                                 scale=scale, return_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) if with_lse
           else None)
    _launch(q, k, v, out, lse, causal=causal, window=window, softcap=softcap, scale=scale)
    return (out, lse) if with_lse else out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its LSE, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = _forward(q, k, v, causal=causal, window=window, softcap=softcap,
                            scale=scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _check_options(q, window, softcap, scale) -> float:
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Tiled online-softmax attention.  Returns (B, Hq, Sq, D) in q's dtype,
    with q's memory layout (a (B, S, H, D) tensor viewed as (B, H, S, D) gives
    an output that is contiguous in (B, S, H, D)).  Differentiable in q, k
    and v."""
    _check(q, k, v)
    scale = _check_options(q, window, softcap, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _forward(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale,
                    with_lse=False)


flash_attention.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    out: torch.Tensor,  # (B, Hq, Sq, D) the forward's output
    lse: torch.Tensor,  # (B, Hq, Sq) fp32, the forward's row log-sum-exp
    dout: torch.Tensor,  # (B, Hq, Sq, D) the gradient of out
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' dtype and layouts; dk and dv sum over the
    q heads of each kv group."""
    _check(q, k, v)
    scale = _check_options(q, window, softcap, scale)
    B, Hq, Sq, D = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (B, Hq, Sq):
        raise ValueError(f"expected out and dout of shape {tuple(q.shape)} and lse of "
                         f"{(B, Hq, Sq)}; got {tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if not (q.device == out.device == dout.device == lse.device):
        raise ValueError("q, out, dout and lse must be on one device")
    opts = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return ref.mha_backward_reference(q, k, v, out, lse, dout, **opts)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    _kernel_dtype_and_dim(q)
    if out.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("out must have q's dtype and lse must be float32")
    # dout comes from autograd in whatever layout the graph gave it (even
    # broadcast); the kernel reads 16-byte rows, so such a tensor is copied
    q, k, v, out, dout = (
        t if _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
        for t in (q, k, v, out, dout.to(q.dtype)))
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    Hkv, Sk = k.shape[1], k.shape[2]
    # the bf16 kernels write each q head's dK and dV in fp32 and sum the group after
    parts = ([torch.empty((B, Hq, Sk, D), dtype=torch.float32, device=q.device)
              for _ in range(2)] if q.dtype == torch.bfloat16 and Hq != Hkv else [None, None])
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    lib = _bind_bwd()
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(t.data_ptr() if t is not None else None for t in parts),
        _DTYPE_CODE[q.dtype], B, Hq, Hkv, Sq, Sk, D, strides,
        float(scale), int(causal), int(window) if window is not None else 0,
        float(softcap) if softcap is not None else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: {msg} ({err})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
