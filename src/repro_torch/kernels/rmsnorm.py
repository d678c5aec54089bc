"""Fused RMSNorm, forward and backward: a hand-written Triton kernel (the
forward), a hand-written CUDA kernel (the backward) and their wrappers.

Replaces the Pallas TPU kernel ``_rmsnorm_kernel`` / ``rmsnorm`` of
``src/repro/kernels/rmsnorm.py``: y = x * rsqrt(mean(x^2) + eps) * scale, in
fp32, cast back to x's dtype.

What bounds it on the H100: reading x once and writing y once (a few
operations per byte), so memory bandwidth.  The design keeps it to that one
pass: each program holds whole rows in registers (a row of d=2048 bf16 is
4 KB), reduces them in fp32 and writes them back, so x is read from device
memory exactly once.  Row widths that are not powers of two (896, 3584) are
masked at the row's tail, and the ragged last block of rows is masked
instead of padded.  Small widths take several rows per program so that a
program still moves a few KB.

The backward (the JAX package leaves it to XLA) is bound by bytes too: x
and the gradient g are read once and dx written once.  With
r = rsqrt(mean(x^2) + eps), dx = r (g scale) - x r^3 mean(x g scale) is a
row reduction and an elementwise pass, and dscale = sum over rows of g x r
a column sum across rows.  Both are in ``csrc/rmsnorm_bwd.cu`` (a row
kernel and a column sum of its partial rows), whose head says how it keeps
many rows in flight on each SM and sums dscale in one fixed order without
floating-point atomics (the same bits in every run); :func:`bwd_plan` is its
split of the rows.  Statistics are fp32; dx comes out in x's dtype and
dscale in scale's.

:func:`rmsnorm` is differentiable: when a gradient is wanted it runs inside
a ``torch.autograd.Function`` whose backward is :func:`rmsnorm_bwd`.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version
(:func:`repro_torch.kernels.ref.rmsnorm_reference`,
:func:`~repro_torch.kernels.ref.rmsnorm_backward_reference`).
``rmsnorm.launches`` and ``rmsnorm_bwd.launches`` count kernel launches
(one per call; the backward's call runs its two kernels).  ``triton`` is
imported, and the CUDA source built, only when a kernel is first launched.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import torch

from . import ref
from .build import load_library

MAX_D = 16384
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, n_rows, d, eps,
                       ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        r = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / d + eps)
        s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = x * r[:, None] * s[None, :]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_kernel


def _launch(x2: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, eps: float) -> None:
    rows, d = x2.shape
    triton, kernel = _kernel()
    block_d = triton.next_power_of_2(d)
    rows_per_prog = max(1, 4096 // block_d)
    num_warps = 8 if block_d * rows_per_prog >= 4096 else 4
    grid = (triton.cdiv(rows, rows_per_prog),)
    kernel[grid](x2, scale, out, rows, d, eps,
                 ROWS=rows_per_prog, BLOCK_D=block_d, num_warps=num_warps)
    rmsnorm.launches += 1


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(scale.shape)}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")


def _check_kernel(x: torch.Tensor, scale: torch.Tensor) -> None:
    d = x.shape[-1]
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, not {x.dtype}/{scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm kernel takes 0 < d <= {MAX_D}, not {d}")


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.rmsnorm_reference(x, scale, eps=eps)
    _check_kernel(x, scale)
    if x.numel() == 0:
        return torch.empty_like(x)
    d = x.shape[-1]
    out = torch.empty_like(x)
    _launch(x.view(-1, d), scale, out.view(-1, d), eps)
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, g, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., d) with ``scale`` (d,);
    differentiable in both."""
    _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


rmsnorm.launches = 0


BWD_THREADS = 512  # threads of a block of the backward kernel (THREADS in csrc/rmsnorm_bwd.cu)
BWD_PHASES = 16  # the column sum's threads per column (PHASES in csrc/rmsnorm_bwd.cu)


def bwd_plan(rows: int, d: int, elem_size: int, n_sm: int) -> Dict[str, int]:
    """The backward kernel's split of (rows, d) with elements of
    ``elem_size`` bytes over a card of ``n_sm`` SMs (``csrc/rmsnorm_bwd.cu``):

    - ``elems``: elements of a row per thread (16; 32 above d = 8192);
    - ``team_threads``: threads that share a row (a power of two, 32 to
      512), ``teams`` = 512 / team_threads of them per block;
    - ``rows_per_step``: rows a team takes at a time (2 in bf16, 1 in fp32);
    - ``rows_per_block``, ``blocks``: contiguous slices of rows, at most one
      block per SM, each writing one partial row of dscale.
    """
    elems = 16 if d <= 16 * BWD_THREADS else 32
    team = max(32, 1 << (math.ceil(d / elems) - 1).bit_length())
    teams = BWD_THREADS // team
    step = 2 if elems * elem_size <= 32 else 1
    step_rows = teams * step
    blocks = max(1, min(n_sm, math.ceil(rows / step_rows)))
    rows_per_block = math.ceil(math.ceil(rows / blocks) / step_rows) * step_rows
    return dict(elems=elems, team_threads=team, teams=teams, rows_per_step=step,
                rows_per_block=rows_per_block, blocks=math.ceil(rows / rows_per_block))


@functools.lru_cache(maxsize=None)
def _bind_bwd() -> ctypes.CDLL:
    lib = load_library("rmsnorm_bwd")
    fn = lib.rmsnorm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.rmsnorm_bwd_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale in scale's dtype) for the gradient ``g`` of
    ``rmsnorm(x, scale)``."""
    _check(x, scale)
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must match x: {tuple(g.shape)} on {g.device}, "
                         f"{tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        return ref.rmsnorm_backward_reference(x, scale, g, eps=eps)
    _check_kernel(x, scale)
    g = g.to(x.dtype).contiguous()  # autograd may hand over a broadcast or strided g
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    plan = bwd_plan(rows, d, x.element_size(), _sm_count(x.device))
    part = torch.empty((plan["blocks"], d), dtype=torch.float32, device=x.device)
    dscale = torch.empty_like(scale)
    lib = _bind_bwd()
    err = lib.rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        part.data_ptr(), int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        rows, d, plan["elems"], plan["team_threads"], plan["rows_per_block"], plan["blocks"],
        eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = lib.rmsnorm_bwd_error_string(err).decode()
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed: {msg} ({err})")
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0
