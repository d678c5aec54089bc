"""Fused RMSNorm: a hand-written Triton kernel and its wrapper.

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

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version, :func:`repro_torch.kernels.ref.rmsnorm_reference`.
``rmsnorm.launches`` counts kernel launches.  ``triton`` is imported only
when the kernel is first launched.
"""
from __future__ import annotations

import functools

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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis of ``x`` (..., d) with ``scale`` (d,)."""
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale must have shape ({d},), got {tuple(scale.shape)}")
    if x.device != scale.device:
        raise ValueError("x and scale must be on one device")
    if x.device.type == "cpu":
        return ref.rmsnorm_reference(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, not {x.dtype}/{scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    if not 0 < d <= MAX_D:
        raise ValueError(f"rmsnorm kernel takes 0 < d <= {MAX_D}, not {d}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise RuntimeError("rmsnorm kernel has no backward pass yet")
    if x.numel() == 0:
        return torch.empty_like(x)
    out = torch.empty_like(x)
    _launch(x.view(-1, d), scale, out.view(-1, d), eps)
    return out


rmsnorm.launches = 0
