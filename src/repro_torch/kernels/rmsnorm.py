"""Fused RMSNorm, forward and backward: hand-written Triton kernels and
their wrappers.

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
row reduction and an elementwise pass, one program over a block of rows;
dscale = sum over rows of g x r is a column sum across programs, so each
program writes its fp32 partial sums and a second small kernel reduces them
(no atomics, so the sum is the same in every run).  Statistics are fp32; dx
comes out in x's dtype and dscale in scale's.

:func:`rmsnorm` is differentiable: when a gradient is wanted it runs inside
a ``torch.autograd.Function`` whose backward is :func:`rmsnorm_bwd`.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version
(:func:`repro_torch.kernels.ref.rmsnorm_reference`,
:func:`~repro_torch.kernels.ref.rmsnorm_backward_reference`).
``rmsnorm.launches`` and ``rmsnorm_bwd.launches`` count kernel launches
(one per call; the backward's call runs its two kernels).  ``triton`` is
imported only when a kernel is first launched.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import ref

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


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_bwd_kernel(x_ptr, s_ptr, g_ptr, dx_ptr, part_ptr, n_rows, d, eps,
                           ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
        for i in range(ROWS):
            row = pid * ROWS + i
            mask = cmask & (row < n_rows)
            offs = row.to(tl.int64) * d + cols
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            r = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / d + eps)
            gs = g * s
            c = tl.sum(x * gs, axis=0) / d
            dx = r * gs - x * (r * r * r * c)
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            acc += g * x * r
        tl.store(part_ptr + pid.to(tl.int64) * d + cols, acc, mask=cmask)

    @triton.jit
    def column_sum_kernel(part_ptr, out_ptr, n_parts, d,
                          BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < d
        acc = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            parts = p0 + tl.arange(0, BLOCK_P)
            mask = (parts < n_parts)[:, None] & cmask[None, :]
            acc += tl.load(part_ptr + parts.to(tl.int64)[:, None] * d + cols[None, :],
                           mask=mask, other=0.0)
        tl.store(out_ptr + cols, tl.sum(acc, axis=0).to(out_ptr.dtype.element_ty), mask=cmask)

    return triton, rmsnorm_bwd_kernel, column_sum_kernel


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
    triton, kernel, column_sum = _bwd_kernels()
    block_d = triton.next_power_of_2(d)
    num_warps = min(16, max(4, block_d // 256))  # ~8 fp32 values of a row per thread
    rows_per_prog = 16
    n_parts = triton.cdiv(rows, rows_per_prog)
    part = torch.empty((n_parts, d), dtype=torch.float32, device=x.device)
    kernel[(n_parts,)](x, scale, g, dx, part, rows, d, eps,
                       ROWS=rows_per_prog, BLOCK_D=block_d, num_warps=num_warps)
    dscale = torch.empty_like(scale)
    block_c = 64
    column_sum[(triton.cdiv(d, block_c),)](part, dscale, n_parts, d,
                                           BLOCK_P=32, BLOCK_C=block_c, num_warps=4)
    rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm_bwd.launches = 0
