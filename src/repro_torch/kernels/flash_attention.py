"""Flash attention (forward): the wrapper of the hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``; the kernel is
``csrc/flash_attention.cu``, whose head says what bounds it on the H100 and
how its design answers that.  Same contract as the Pallas kernel: causal or
full attention, sliding window, logit softcap, GQA/MQA, fp32 accumulation,
output in q's dtype, q and k positions both starting at 0.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version, :func:`repro_torch.kernels.ref.mha_reference`.
``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 12
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
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


def _launch(q, k, v, out, *, causal, window, softcap, scale) -> None:
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {HEAD_DIMS}, not {D}")
    vec = 16 // q.element_size()  # the kernel reads 16-byte vectors
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name}: rows must start on 16-byte boundaries")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention kernel has no backward pass yet")
    lib = _bind()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
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
    an output that is contiguous in (B, S, H, D))."""
    _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError("softcap must be positive")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref.mha_reference(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    out = torch.empty_like(q)
    _launch(q, k, v, out, causal=causal, window=window, softcap=softcap, scale=scale)
    return out


flash_attention.launches = 0
