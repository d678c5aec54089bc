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

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version, :func:`repro_torch.kernels.ref.wkv6_reference`.
``wkv6.launches`` counts kernel launches (one per call on the card), split
into ``wkv6.chunk_launches`` and ``wkv6.step_launches`` by kernel.
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, log_w, u, s0)):
        raise RuntimeError("wkv6 kernel has no backward pass yet")
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
    be ``s0`` itself (the layer's cache, updated in place)."""
    _check(r, k, v, log_w, u, s0, s_out, out_dtype)
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


wkv6.launches = wkv6.chunk_launches = wkv6.step_launches = 0
