"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit;
2. build: compiles the CUDA kernel sources of ``src/repro_torch/kernels/csrc``;
3. kernels: each hand-written kernel (flash attention, RMSNorm, the chunked
   and the short-sequence WKV6) against its plain PyTorch version on CUDA
   tensors, at the serving paths'
   shapes and at the other options of the TPU kernel it replaces, with times
   of the kernel, the plain version and one PyTorch library call where there
   is one, beside the least time the card could take;
   The backward kernels of flash attention and RMSNorm are held against
   their plain versions the same way, at the training path's shapes and at
   the other options; both give bit-identical gradients in two calls; flash
   attention's backward time is split by launch (torch.profiler), and its
   yardstick is SDPA's backward under the flash backend (or the backend that
   takes the shape where flash refuses it, named).  Two floors of the timing
   window are printed: one launch of a one-element kernel, and, beside the
   RMSNorm backward and the WKV6 decode step, a PyTorch call that moves the
   bytes the kernel must move;
4. reference: a full-width, 2-layer fp32 gemma-2b and rwkv6-1.6b on the
   card (kernels) against the same weights on the CPU (plain versions):
   logits and greedy tokens; then one AdamW step of the 2-layer fp32
   gemma-2b on the card against the same step on the CPU: the loss, every
   parameter's gradient and the parameter update;
5. serve: full-width gemma-2b (18 layers) and then rwkv6-1.6b (24 layers),
   bf16, random weights from a fixed seed, each serving batch 4 x prompt
   1024 + 32 new tokens through ``ServeEngine.generate``, with the kernels'
   launch counts of each run (flash attention and RMSNorm on gemma-2b's
   path, the chunked WKV6 kernel in rwkv6's prefill and the decode-step
   one in its decode steps);
6. train: full-width, full-depth gemma-2b in bf16, random weights from a
   fixed seed, 6 AdamW steps of batch 4 x 1024 tokens of the synthetic
   affine data through ``train.trainstep.train_step``: the loss of every
   step, step ms, tok/s, peak device memory, the launches per step of the
   four kernels on the path (flash attention and RMSNorm, forward and
   backward) and a profile of one step.

The line before the last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: 80 GB HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor core / fp32 CUDA core
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the JAX kernel tests' tolerances
# backward kernels against their plain versions: fp32 sums of up to a few
# thousand products in another order; bf16: both sides compute in fp32 from
# the same bf16 inputs and round each gradient once
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
WKV_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # 1e-4 at log_w = -50, as in JAX
ARCHS = ("gemma-2b", "rwkv6-1.6b")
SERVE_BATCH, PROMPT_LEN, MAX_NEW = 4, 1024, 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 30, flush_bytes: int = 256 << 20) -> float:
    """Median device time of ``fn()`` in ms (CUDA events), with the 50 MB L2
    flushed before each call so inputs come from device memory.  A device-side
    wait (~1 ms) after the flush keeps the card busy while the host enqueues
    the events and the call, so the host's launch time and its stalls stay
    out of the window."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # clock cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_floor_ms() -> float:
    """time_ms of the smallest launch: one one-element kernel."""
    one = torch.zeros(1, device=DEVICE)
    return time_ms(lambda: one.add_(1.0))


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    cases = [  # (B, Hq, Hkv, Sq, Sk, D, dtype, options)
        (SERVE_BATCH, 8, 1, PROMPT_LEN, PROMPT_LEN, 256, torch.bfloat16, {}),  # gemma-2b prefill
        (SERVE_BATCH, 8, 1, PROMPT_LEN, PROMPT_LEN, 256, torch.float32, {}),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(causal=False)),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(causal=False)),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(window=64)),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(window=64)),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(softcap=30.0)),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(softcap=30.0)),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(window=32, softcap=50.0)),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(window=32, softcap=50.0)),
        (2, 4, 2, 256, 256, 64, torch.bfloat16, {}),
        (1, 8, 2, 128, 256, 128, torch.float32, {}),  # GQA, cross lengths
        (1, 8, 2, 128, 256, 128, torch.bfloat16, dict(window=100)),
        (1, 2, 2, 100, 100, 32, torch.float32, {}),  # ragged Sq/Sk
        (1, 2, 2, 100, 100, 32, torch.bfloat16, {}),
        (1, 8, 1, 100, 173, 256, torch.bfloat16, dict(softcap=50.0)),
        (2, 4, 2, 77, 77, 16, torch.float32, dict(window=8)),  # smoke head_dim
        (2, 4, 2, 77, 77, 16, torch.bfloat16, dict(window=8)),
    ]
    main = None
    for B, Hq, Hkv, Sq, Sk, D, dtype, kw in cases:
        # model layout (B, S, H, D) viewed as (B, H, S, D), as ops.attention passes it
        q = randn(gen, (B, Sq, Hq, D), dtype).transpose(1, 2)
        k = randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
        v = randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
        out = flash_attention(q, k, v, **kw)
        expect = ref.mha_reference(q, k, v, **kw)
        sync()
        err = (out.float() - expect.float()).abs().max().item()
        ok = torch.allclose(out.float(), expect.float(), atol=TOL[dtype], rtol=TOL[dtype])
        log(f"  flash_attention B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} "
            f"{str(dtype)[6:]} {kw or 'causal'}: max_abs_err={err:.3g} (tol {TOL[dtype]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
        if main is None:
            main = dict(q=q, k=k, v=v, err=err, dtype=dtype)

    q, k, v, dtype = main["q"], main["k"], main["v"], main["dtype"]
    B, Hq, S, D = q.shape
    ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: ref.mha_reference(q, k, v))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    pairs = B * Hq * S * (S + 1) // 2  # causal (q, k) pairs this input needs
    flops = 4.0 * D * pairs  # q.k and p.v, 2 flops per multiply-add
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()  # q, k, v read; o written
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log(f"  flash_attention at the prefill shape (B={B}, Hq={Hq}, Hkv={k.shape[1]}, S={S}, D={D}, "
        f"bf16, causal): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (scaled_dot_product_attention) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:40",
                max_abs_err=main["err"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_rmsnorm(gen, d_model: int) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    rows_main = SERVE_BATCH * PROMPT_LEN
    cases = [  # (rows, d, dtype)
        (rows_main, d_model, torch.bfloat16),  # gemma-2b prefill
        (rows_main, d_model, torch.float32),
        (SERVE_BATCH, d_model, torch.bfloat16),  # gemma-2b decode step
        (rows_main - 1, d_model, torch.bfloat16),  # ragged last block of rows
        (1000, 896, torch.float32),  # widths that are not powers of two
        (333, 3584, torch.bfloat16),
        (64, 768, torch.float32),
        (17, 8192, torch.bfloat16),
    ]
    main = None
    for rows, d, dtype in cases:
        x = randn(gen, (rows, d), dtype)
        s = randn(gen, (d,), dtype)
        out = rmsnorm(x, s)
        expect = ref.rmsnorm_reference(x, s)
        sync()
        err = (out.float() - expect.float()).abs().max().item()
        ok = torch.allclose(out.float(), expect.float(), atol=TOL[dtype], rtol=TOL[dtype])
        log(f"  rmsnorm rows={rows} d={d} {str(dtype)[6:]}: max_abs_err={err:.3g} "
            f"(tol {TOL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rmsnorm disagrees with its plain version: {err}")
        if main is None:
            main = dict(x=x, s=s, err=err, dtype=dtype)

    x, s, dtype = main["x"], main["s"], main["dtype"]
    ms = time_ms(lambda: rmsnorm(x, s))
    plain_ms = time_ms(lambda: ref.rmsnorm_reference(x, s))
    library_ms = time_ms(lambda: F.rms_norm(x, (x.shape[-1],), weight=s, eps=1e-6))
    nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
    flops = 4.0 * x.numel()  # square, sum, scale by r, scale by s
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    log(f"  rmsnorm at the prefill shape ({x.shape[0]}, {x.shape[1]}) bf16: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library (rms_norm) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB)")
    return dict(name="rmsnorm", route="triton", source="src/repro_torch/kernels/rmsnorm.py",
                replaces="src/repro/kernels/rmsnorm.py:17",
                max_abs_err=main["err"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_wkv6(gen, cfg) -> list:
    """The WKV6 kernels: the chunked one (T >= wkv6.CHUNK, prefill) and the
    short-sequence ones (the decode step at T = 1, a token loop at
    1 < T < wkv6.CHUNK), the first two timed at their serving shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import CHUNK, wkv6

    K = cfg.rwkv.head_dim
    H = cfg.d_model // K
    zero = dict(s0=False)
    fp32_y = dict(out_dtype=torch.float32)
    in_place = dict(out_dtype=torch.float32, state="in place")  # the model's call: s_out = s0
    unaligned = dict(out_dtype=torch.float32, state="unaligned")  # s0 4 bytes past 16
    cases = [  # (B, H, T, K, dtype, options)
        (SERVE_BATCH, H, PROMPT_LEN, K, torch.bfloat16, fp32_y),  # rwkv6-1.6b prefill
        (SERVE_BATCH, H, PROMPT_LEN, K, torch.bfloat16, {}),
        (SERVE_BATCH, H, PROMPT_LEN, K, torch.float32, {}),
        (SERVE_BATCH, H, 1, K, torch.bfloat16, fp32_y),  # rwkv6-1.6b decode step
        (SERVE_BATCH, H, 1, K, torch.bfloat16, {}),
        (SERVE_BATCH, H, 1, K, torch.float32, zero),
        (SERVE_BATCH, H, 1, K, torch.bfloat16, in_place),
        (SERVE_BATCH, H, 1, K, torch.bfloat16, unaligned),
        (SERVE_BATCH, H, 2, K, torch.bfloat16, in_place),  # short prompts: the token loop
        (SERVE_BATCH, H, 2, K, torch.float32, unaligned),
        (SERVE_BATCH, H, 31, K, torch.bfloat16, in_place),
        (2, 3, 31, 16, torch.float32, in_place),
        (2, 3, 2, 32, torch.bfloat16, unaligned),
        (2, 3, 50, K, torch.float32, {}),  # ragged T
        (2, 3, 96, 32, torch.bfloat16, {}),
        (2, 3, 50, 16, torch.float32, {}),  # the smoke head size
        (2, 4, 64, 16, torch.bfloat16, zero),
        (1, 2, 32, K, torch.float32, dict(log_w=-50.0, s0=False)),  # extreme decay
        (2, 3, 40, 16, torch.float32, dict(log_w=-50.0)),
        (2, 3, 31, K, torch.float32, {}),  # the edges of the kernel's 32-token chunks
        (2, 3, 32, K, torch.bfloat16, fp32_y),
        (2, 3, 33, K, torch.float32, {}),
        (2, 3, 65, K, torch.bfloat16, {}),
        (3, 2, 33, 16, torch.float32, {}),  # V = 16: one 16-column block is the whole state
        (3, 2, 65, 16, torch.bfloat16, fp32_y),
        (1, 2, 65, 32, torch.float32, dict(log_w=-50.0)),
    ]
    main = {}
    for B, Hh, T, Kk, dtype, kw in cases:
        # model layout (B, T, H, K) viewed as (B, H, T, K), as ops.wkv6 passes it;
        # log_w = -exp(N(0, 1)) as tests/test_kernels.py draws it
        r, k, v = (randn(gen, (B, T, Hh, Kk), dtype).transpose(1, 2) for _ in range(3))
        if "log_w" in kw:
            lw = torch.full((B, T, Hh, Kk), kw["log_w"], device=DEVICE).transpose(1, 2)
        else:
            lw = -torch.exp(randn(gen, (B, T, Hh, Kk), torch.float32)).transpose(1, 2)
        u = randn(gen, (Hh, Kk), torch.float32)
        s0 = (randn(gen, (B, Hh, Kk, Kk), torch.float32) if kw.get("s0", True)
              else torch.zeros((B, Hh, Kk, Kk), device=DEVICE))
        state = kw.get("state", "new")
        if state == "unaligned":
            s0 = torch.cat([s0.new_zeros(1), s0.flatten()])[1:].view(s0.shape)
        out_dtype = kw.get("out_dtype")
        kernel = "wkv6" if T >= CHUNK else "wkv6_step"
        want_y, want_s = ref.wkv6_reference(r, k, v, lw, u, s0, out_dtype=out_dtype)
        before = (wkv6.chunk_launches, wkv6.step_launches)
        y, sf = wkv6(r, k, v, lw, u, s0, s_out=None if state == "new" else s0,
                     out_dtype=out_dtype)
        sync()
        ran = "wkv6" if wkv6.chunk_launches > before[0] else "wkv6_step"
        tol = 1e-4 if "log_w" in kw else WKV_TOL[y.dtype]  # fp32 y: both sides fp32
        s_tol = min(tol, WKV_TOL[torch.float32])  # the state is fp32 in every case
        err = (y.float() - want_y.float()).abs().max().item()
        s_err = (sf - want_s).abs().max().item()
        ok = (ran == kernel and y.dtype == want_y.dtype == (out_dtype or dtype)
              and (state == "new" or sf is s0) and torch.isfinite(y.float()).all().item()
              and torch.allclose(y.float(), want_y.float(), atol=tol, rtol=tol)
              and torch.allclose(sf, want_s, atol=s_tol, rtol=s_tol))
        log(f"  {kernel} B={B} H={Hh} T={T} K=V={Kk} {str(dtype)[6:]} "
            f"{'s0=0' if not kw.get('s0', True) else 's0 random'}"
            f"{' log_w=-50' if 'log_w' in kw else ''}"
            f"{' y ' + str(out_dtype)[6:] if out_dtype else ''}"
            f"{'' if state == 'new' else ', state ' + state}: max_abs_err y={err:.3g} (tol {tol}), "
            f"state={s_err:.3g} (tol {s_tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"wkv6 disagrees with its plain version: y {err}, state {s_err}")
        if kernel not in main:  # the first case of each kernel is its serving shape
            main[kernel] = dict(args=(r, k, v, lw, u, s0), err=err, out_dtype=out_dtype)

    out = []
    for kernel, what in (("wkv6", "prefill"), ("wkv6_step", "decode")):
        r, k, v, lw, u, s0 = main[kernel]["args"]
        out_dtype = main[kernel]["out_dtype"]
        B, Hh, T, Kk = r.shape
        ms = time_ms(lambda: wkv6(r, k, v, lw, u, s0, out_dtype=out_dtype))
        plain_ms = time_ms(lambda: ref.wkv6_reference(r, k, v, lw, u, s0, out_dtype=out_dtype),
                           reps=5 if T >= CHUNK else 30)
        # bytes: r, k, v, log_w, u and s0 read once; y (fp32) and the final state written once
        nbytes = ((r.numel() + k.numel() + v.numel()) * r.element_size() + lw.numel() * 4
                  + u.numel() * 4 + 2 * s0.numel() * 4
                  + v.numel() * (out_dtype or r.dtype).itemsize)
        flops = 4.0 * B * Hh * T * Kk * Kk  # k v^T, u-bonus, r.(S + ...), decay: ~4 per (k, v)
        bound_ms, bound_by = bound(nbytes, flops, torch.float32)  # the recurrence is fp32
        extra = {}
        if kernel == "wkv6_step":  # what a copy of the state takes in the same window
            copy = torch.empty_like(s0)
            extra["copy_ms"] = time_ms(lambda: copy.copy_(s0))
        log(f"  {kernel} at the {what} shape (B={B}, H={Hh}, T={T}, K=V={Kk}, bf16 r/k/v, "
            f"fp32 y): kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library: none (no single PyTorch call computes WKV6), "
            f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.4f} GFLOP fp32, "
            f"{nbytes / 1e6:.1f} MB)"
            + (f"; a copy of the state (copy_) {extra['copy_ms']:.4f} ms" if extra else ""))
        out.append(dict(name=kernel, route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
                        replaces="src/repro/kernels/rwkv6_wkv.py:37",
                        max_abs_err=main[kernel]["err"], ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, **extra))
    return out


def check_flash_bwd(gen) -> dict:
    """The forward's LSE and the backward kernel against their plain
    versions, timed at gemma-2b's training shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _forward, flash_attention_bwd

    cases = [  # (B, Hq, Hkv, Sq, Sk, D, dtype, options)
        (TRAIN_BATCH, 8, 1, TRAIN_SEQ, TRAIN_SEQ, 256, torch.bfloat16, {}),  # gemma-2b training
        (TRAIN_BATCH, 8, 1, TRAIN_SEQ, TRAIN_SEQ, 256, torch.float32, {}),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(window=64)),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(window=64)),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(softcap=30.0)),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(softcap=30.0)),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(causal=False)),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(window=32, softcap=50.0)),
        (1, 8, 2, 128, 256, 128, torch.float32, dict(window=100)),  # GQA, cross lengths
        (1, 8, 2, 256, 256, 128, torch.bfloat16, {}),
        (1, 2, 2, 1000, 1000, 64, torch.bfloat16, {}),  # ragged Sq = Sk
        (1, 2, 2, 1000, 1000, 128, torch.float32, {}),
        (1, 8, 1, 100, 173, 256, torch.bfloat16, dict(softcap=50.0)),
        (2, 4, 2, 77, 77, 16, torch.float32, dict(window=8, softcap=5.0)),
        (1, 2, 2, 100, 100, 32, torch.bfloat16, dict(causal=False, window=30)),
        (1, 2, 2, 1000, 1000, 256, torch.bfloat16, {}),  # 64-row tiles ending mid-tile
        (1, 8, 2, 300, 300, 256, torch.bfloat16, dict(window=100, softcap=50.0)),
    ]
    main = None
    for B, Hq, Hkv, Sq, Sk, D, dtype, kw in cases:
        q = randn(gen, (B, Sq, Hq, D), dtype).transpose(1, 2)
        k = randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
        v = randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
        dout = randn(gen, (B, Sq, Hq, D), dtype).transpose(1, 2)
        opts = dict(causal=True, window=None, softcap=None, scale=D ** -0.5) | kw
        out, lse = _forward(q, k, v, with_lse=True, **opts)
        _, want_lse = ref.mha_reference(q, k, v, return_lse=True, **kw)
        grads = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = ref.mha_backward_reference(q, k, v, out, lse, dout, **kw)
        sync()
        tol = BWD_TOL[dtype]
        lse_err = (lse - want_lse).abs().max().item()
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(grads, want)]
        ok = lse_err <= 1e-4 and all(
            torch.allclose(g.float(), w.float(), atol=tol, rtol=tol) for g, w in zip(grads, want))
        log(f"  flash_attention_bwd B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} "
            f"{str(dtype)[6:]} {kw or 'causal'}: lse err={lse_err:.3g} (tol 1e-4), "
            f"max_abs_err dq={errs[0]:.3g} dk={errs[1]:.3g} dv={errs[2]:.3g} (tol {tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {errs}")
        if main is None:
            main = dict(args=(q, k, v, out, lse, dout), err=max(errs), dtype=dtype)

    q, k, v, out, lse, dout = main["args"]
    B, Hq, S, D = q.shape
    again = flash_attention_bwd(q, k, v, out, lse, dout)
    sync()
    if not all(torch.equal(a, b) for a, b in zip(again, flash_attention_bwd(*main["args"]))):
        raise AssertionError("flash_attention_bwd: two calls on the same inputs differ")
    log("  flash_attention_bwd at the training shape: two calls give bit-identical dq, dk, dv")
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout))
    plain_ms = time_ms(lambda: ref.mha_backward_reference(q, k, v, out, lse, dout), reps=5)
    split = bwd_launch_split(main["args"])
    log("  flash_attention_bwd at the training shape, device ms per call by launch "
        "(torch.profiler over 5 back-to-back calls): "
        + ", ".join(f"{name} {t:.4f}" for name, t in split.items()))
    library_ms, backend = sdpa_backward_ms(q, k, v, dout)
    pairs = B * Hq * S * (S + 1) // 2  # causal (q, k) pairs this input needs
    flops = 10.0 * D * pairs  # q.k, dO.v, P^T dO, dS K, dS^T Q: 2 flops per multiply-add each
    # q, k, v, o, dO and the LSE read once; dq, dk, dv written once
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel() + dout.numel()) \
        * q.element_size() + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, flops, main["dtype"])
    log(f"  flash_attention_bwd at the training shape (B={B}, Hq={Hq}, Hkv={k.shape[1]}, S={S}, "
        f"D={D}, bf16, causal): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(scaled_dot_product_attention backward, {backend} backend) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms "
        f"by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention.py:40",
                max_abs_err=main["err"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, library_backend=backend,
                ms_by_launch=split)


def bwd_launch_split(args, calls: int = 5) -> dict:
    """Device ms per call of each kernel that ``flash_attention_bwd(*args)``
    launches, from torch.profiler over ``calls`` back-to-back calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention_bwd

    flash_attention_bwd(*args)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flash_attention_bwd(*args)
        sync()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            hit = re.search(r"\w+_kernel(<[^>]*>)?", e.name)
            name = hit.group(0) if hit else e.name[:60]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    if not split:
        raise AssertionError("torch.profiler saw no device time in flash_attention_bwd")
    return split


def sdpa_backward_ms(q, k, v, dout) -> tuple:
    """The yardstick: SDPA's backward through autograd (timed only: the port
    never calls it) under each backend alone, and as PyTorch dispatches it by
    default.  Returns (ms, backend): the flash backend's time or, where flash
    refuses the shape, that of the first backend that takes it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def forward(backend):
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
            return leaves, F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                          enable_gqa=True)

    def grad_ms(leaves, out):
        return time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        with warnings.catch_warnings(record=True) as why:  # a refusal warns its reasons
            warnings.simplefilter("always")
            try:
                leaves, out = forward(backend)
            except RuntimeError as err:  # this backend does not take the shape
                reasons = [str(w.message).split(" (Triggered internally")[0] for w in why]
                times[backend.name] = f"refused ({' '.join(reasons or [str(err)])[:240]})"
                continue
        times[backend.name] = grad_ms(leaves, out)
        del leaves, out
    default = grad_ms(*forward(None))
    log("  scaled_dot_product_attention backward at the training shape, by backend: "
        + ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else f"{n} {t}"
                    for n, t in times.items()) + f"; default dispatch {default:.4f} ms")
    served = next(((n, t) for n, t in times.items() if isinstance(t, float)), None)
    if served is None:
        raise AssertionError("no scaled_dot_product_attention backend takes the training shape")
    return served[1], served[0]


def check_rmsnorm_bwd(gen, d_model: int) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    rows_main = TRAIN_BATCH * TRAIN_SEQ
    cases = [  # (rows, d, dtype, option)
        (rows_main, d_model, torch.bfloat16, None),  # gemma-2b training
        (rows_main, d_model, torch.float32, None),
        (rows_main - 1, d_model, torch.bfloat16, None),  # ragged last slice of rows
        (1000, 896, torch.float32, None),  # widths that are not powers of two
        (333, 3584, torch.bfloat16, None),
        (17, 8192, torch.bfloat16, None),
        (3, 5, torch.float32, None),
        (64, 16384, torch.bfloat16, None),  # the widest row the kernel takes
        (9, 16384, torch.float32, None),
        (300, d_model, torch.bfloat16, "unaligned x"),  # x 2 bytes past 16: scalar loads
        (300, d_model, torch.float32, "broadcast g"),  # autograd's gradient of a sum
    ]
    main = determinism_args = None
    for rows, d, dtype, option in cases:
        x, g = randn(gen, (rows, d), dtype), randn(gen, (rows, d), dtype)
        s = randn(gen, (d,), dtype)
        if option == "unaligned x":
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(rows, d)
        elif option == "broadcast g":
            g = randn(gen, (d,), dtype).expand(rows, d)
        dx, ds = rmsnorm_bwd(x, s, g)
        want_dx, want_ds = ref.rmsnorm_backward_reference(x, s, g)
        sync()
        tol = BWD_TOL[dtype]
        ds_scale = want_ds.float().abs().max().item()  # dscale sums `rows` products
        err = (dx.float() - want_dx.float()).abs().max().item()
        ds_err = (ds.float() - want_ds.float()).abs().max().item()
        ok = (dx.dtype == ds.dtype == dtype
              and torch.allclose(dx.float(), want_dx.float(), atol=tol, rtol=tol)
              and torch.allclose(ds.float(), want_ds.float(), atol=tol * ds_scale, rtol=tol))
        log(f"  rmsnorm_bwd rows={rows} d={d} {str(dtype)[6:]}{', ' + option if option else ''}: "
            f"max_abs_err dx={err:.3g} "
            f"(tol {tol}), dscale={ds_err:.3g} (tol {tol} x max|dscale| {ds_scale:.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rmsnorm_bwd disagrees with its plain version: {err}, {ds_err}")
        if main is None:
            main = dict(args=(x, s, g), err=err, dtype=dtype)
        if (rows, d) == (333, 3584):
            determinism_args = (x, s, g)

    for args in (main["args"], determinism_args):
        first, second = rmsnorm_bwd(*args), rmsnorm_bwd(*args)
        sync()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"rmsnorm_bwd at {tuple(args[0].shape)}: two calls differ")
        log(f"  rmsnorm_bwd at {tuple(args[0].shape)} {str(args[0].dtype)[6:]}: two calls give "
            f"bit-identical dx and dscale")
    x, s, g = main["args"]
    ms = time_ms(lambda: rmsnorm_bwd(x, s, g))
    plain_ms = time_ms(lambda: ref.rmsnorm_backward_reference(x, s, g))
    xl, sl = x.detach().requires_grad_(), s.detach().requires_grad_()
    y = F.rms_norm(xl, (x.shape[-1],), weight=sl, eps=1e-6)
    library_ms = time_ms(lambda: torch.autograd.grad(y, (xl, sl), g, retain_graph=True))
    o = torch.empty_like(x)
    copy_ms = time_ms(lambda: torch.add(x, g, out=o))  # reads x and g, writes dx's bytes
    # x and g read, dx written; scale read, dscale written
    nbytes = 3 * x.numel() * x.element_size() + 2 * s.numel() * s.element_size()
    flops = 11.0 * x.numel()  # x^2, two row sums, g s, x g s, r g s, x r^3 c, dx, g x r, column sum
    bound_ms, bound_by = bound(nbytes, flops, main["dtype"])
    log(f"  rmsnorm_bwd at the training shape ({x.shape[0]}, {x.shape[1]}) bf16: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (rms_norm backward) {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB); the same bytes "
        f"through torch.add(x, g) {copy_ms:.4f} ms")
    return dict(name="rmsnorm_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                replaces="src/repro/kernels/rmsnorm.py:17",
                max_abs_err=main["err"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, copy_ms=copy_ms)


# ---------------------------------------------------------------------------
# the model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def check_reference(cfg) -> None:
    from repro_torch.models import get_api
    from repro_torch.serve.engine import ServeEngine

    small = cfg.replace(num_layers=2, param_dtype="float32", compute_dtype="float32")
    cpu_api, gpu_api = get_api(small, device="cpu"), get_api(small, device=DEVICE)
    cpu_model = cpu_api.init(seed=1)
    gpu_model = gpu_api.init(seed=1)
    gpu_model.load_state_dict(cpu_model.state_dict())
    tokens = np.random.default_rng(1).integers(0, small.vocab_size, size=(2, 128))
    tol = 1e-3  # fp32 on both sides; sums over d=2048..16384 taken in another order on the card
    logits = {}
    with torch.inference_mode():
        for name, api, model in (("cpu", cpu_api, cpu_model), ("card", gpu_api, gpu_model)):
            toks = torch.from_numpy(tokens).to(api.device)
            full, _ = model(toks, mode="train")  # the path's kernels on the card
            _, cache = api.prefill(model, {"tokens": toks[:, :127]}, api.init_cache(2, 128),
                                   last_only=True)
            step, _ = api.decode(model, toks[:, 127:], cache)
            logits[name] = (full.cpu(), step.cpu())
    for i, what in enumerate(("full-sequence", "decode-step")):
        err = (logits["card"][i] - logits["cpu"][i]).abs().max().item()
        log(f"  {cfg.name} 2-layer full-width fp32 {what} logits, card vs CPU: "
            f"max_abs_err={err:.3g} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{what} logits on the card disagree with the CPU: {err}")
    out = {}
    for name, api, model in (("cpu", cpu_api, cpu_model), ("card", gpu_api, gpu_model)):
        out[name] = ServeEngine(api, model, batch=2, s_max=140).generate(
            {"tokens": tokens}, max_new_tokens=8)
    log(f"  greedy tokens card {out['card'].tolist()} / CPU {out['cpu'].tolist()}")
    if not np.array_equal(out["cpu"], out["card"]):
        raise AssertionError("greedy tokens on the card differ from the CPU")


TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
TRAIN_FAMILIES = (  # (family, substrings of kernel names), first match wins
    ("flash attention backward", ("flash_bwd", "group_sum")),
    ("flash attention forward", ("flash_fwd",)),
    ("rmsnorm", ("rmsnorm",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "CatArrayBatched", "fill")),
)


def check_train_reference(cfg) -> None:
    """One AdamW step of a full-width, 2-layer fp32 model on the card
    (forward and backward kernels) against the same step on the CPU (plain
    versions): the loss, every parameter's gradient, and the update where
    |g| > 1e-3 max|g| of its leaf (AdamW's first step is close to
    lr sign(g), so an entry near zero that rounds differently flips a whole
    update)."""
    from repro_torch.models import get_api
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update
    from repro_torch.train.trainstep import _accum_grads, batch_to_torch

    small = cfg.replace(num_layers=2, param_dtype="float32", compute_dtype="float32")
    cpu_api, gpu_api = get_api(small, device="cpu"), get_api(small, device=DEVICE)
    models = {"cpu": cpu_api.init(seed=1), "card": gpu_api.init(seed=1)}
    models["card"].load_state_dict(models["cpu"].state_dict())
    batch = SyntheticData(DataConfig(vocab_size=small.vocab_size, batch=1, seq=256)).batch_at(0)
    opt = OptConfig(**TRAIN_OPT)
    res = {}
    for name, api in (("cpu", cpu_api), ("card", gpu_api)):
        model = models[name]
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss, grads = _accum_grads(model, batch_to_torch(batch, api.device), 1)
        adamw_update(model, grads, adamw_init(model), opt)
        res[name] = dict(loss=loss.item(), grads={n: g.cpu() for n, g in grads.items()},
                         delta={n: (p.detach() - before[n]).cpu()
                                for n, p in model.named_parameters()})
        del before, grads
    tol = 1e-3  # fp32 on both sides; sums over d_ff, the vocab and S taken in another order
    loss_err = abs(res["card"]["loss"] - res["cpu"]["loss"])
    g_err, d_err = 0.0, 0.0
    for n, g in res["cpu"]["grads"].items():
        scale = g.abs().max().item()
        g_err = max(g_err, (res["card"]["grads"][n] - g).abs().max().item() / scale)
        big = g.abs() > 1e-3 * scale
        d_diff = res["card"]["delta"][n] - res["cpu"]["delta"][n]
        d_err = max(d_err, d_diff[big].abs().max().item())
    lr0 = float(TRAIN_OPT["lr"]) / TRAIN_OPT["warmup_steps"]
    log(f"  {cfg.name} 2-layer full-width fp32 train step (B=1, S=256), card vs CPU: loss "
        f"{res['card']['loss']:.6f} / {res['cpu']['loss']:.6f} (err {loss_err:.3g}, tol {tol}); "
        f"gradients max_abs_err / max|g| over {len(res['cpu']['grads'])} leaves {g_err:.3g} "
        f"(tol {tol}); update max_abs_err where |g| > 1e-3 max|g| {d_err:.3g} "
        f"(tol {1e-2 * lr0:.3g}, 1e-2 x lr)")
    if not (loss_err <= tol * abs(res["cpu"]["loss"]) and g_err <= tol and d_err <= 1e-2 * lr0):
        raise AssertionError("the train step on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# serving, full width
# ---------------------------------------------------------------------------

def expected_launches(cfg) -> dict:
    """Kernel launches one generate call implies: one prefill, then one
    decode step per further token."""
    passes = 1 + (MAX_NEW - 1)
    if cfg.family == "ssm":  # rwkv: one WKV6 per layer per pass; LayerNorm is plain torch
        return {"flash_attention": 0, "rmsnorm": 0, "wkv6": cfg.num_layers,  # chunked: prefill
                "wkv6_step": cfg.num_layers * (passes - 1)}  # one token a step: decode
    return {"flash_attention": cfg.num_layers,  # prefill only: decode is plain torch
            "rmsnorm": (2 * cfg.num_layers + 1) * passes, "wkv6": 0, "wkv6_step": 0}


def serve(cfg) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import get_api
    from repro_torch.serve.engine import ServeEngine

    api = get_api(cfg, device=DEVICE)
    t0 = time.perf_counter()
    model = api.init(seed=0)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B params "
        f"in {str(cfg.pdtype)[6:]}, initialised in {time.perf_counter() - t0:.1f} s")
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT_LEN)).astype(np.int64)
    eng = ServeEngine(api, model, batch=SERVE_BATCH, s_max=PROMPT_LEN + MAX_NEW)
    eng.generate({"tokens": tokens[:, :64]}, max_new_tokens=2)  # warm-up (Triton JIT, cuBLAS)

    flash_attention.launches = rmsnorm.launches = 0
    wkv6.launches = wkv6.chunk_launches = wkv6.step_launches = 0
    t0 = time.perf_counter()
    out = eng.generate({"tokens": tokens}, max_new_tokens=MAX_NEW)
    total_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "rmsnorm": rmsnorm.launches,
                "wkv6": wkv6.chunk_launches, "wkv6_step": wkv6.step_launches}
    if wkv6.launches != wkv6.chunk_launches + wkv6.step_launches:
        raise AssertionError(f"wkv6.launches {wkv6.launches} is not the sum of its kernels'")

    t = eng.timing
    prefill_ms = t["prefill_s"] * 1e3
    decode_ms = t["decode_s"] * 1e3 / t["decode_steps"]
    tok_s = SERVE_BATCH * MAX_NEW / total_s
    log(f"  generated {out.shape}: prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms/token, "
        f"{tok_s:.1f} tok/s over {total_s:.3f} s")
    log(f"  launches in that run: {launches}")
    expect = expected_launches(cfg)
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != {expect} implied by the path")
    if out.shape != (SERVE_BATCH, MAX_NEW) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids out of range: shape {out.shape}, "
                             f"[{out.min()}, {out.max()}]")
    with torch.inference_mode():
        cache = api.init_cache(SERVE_BATCH, PROMPT_LEN)
        logits, _ = api.prefill(model, {"tokens": torch.from_numpy(tokens).to(DEVICE)}, cache,
                                last_only=True)
    if logits.shape != (SERVE_BATCH, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits not finite or of shape {tuple(logits.shape)}")
    if not np.array_equal(logits[:, -1].argmax(-1).cpu().numpy(), out[:, 0]):
        raise AssertionError("a second prefill picks other first tokens")
    prof = eng.comm_profile()
    kv, fixed = prof["kv_bytes_per_token"], prof["fixed_state_bytes"]
    if cfg.family == "ssm":  # a recurrent state: x_prev twice in cdtype, the fp32 wkv state
        K = cfg.rwkv.head_dim
        expect_kv = 0.0
        expect_fixed = cfg.num_layers * (2 * cfg.d_model * cfg.cdtype.itemsize
                                         + (cfg.d_model // K) * K * K * 4)
    else:
        expect_kv = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * cfg.cdtype.itemsize
        expect_fixed = 0.0
    if (kv, fixed) != (expect_kv, expect_fixed):
        raise AssertionError(f"comm_profile kv_bytes_per_token {kv}, fixed_state_bytes {fixed} "
                             f"!= {expect_kv}, {expect_fixed}")
    log(f"  kv_bytes_per_token {kv:.0f}, fixed_state_bytes {fixed:.0f}")
    if cfg.family == "ssm":
        wkv_y_rounding_shift(api, model, torch.from_numpy(tokens).to(DEVICE))
    profile_phases(api, model, torch.from_numpy(tokens).to(DEVICE), decode_ms)
    return launches


def bf16_absorbs(p: torch.Tensor, bound: float) -> bool:
    """True if no entry of the bf16 tensor ``p`` can move by an update of at
    most ``bound``: it is below half the bf16 spacing just under every
    |entry| (2^(floor(log2 |p|) - 8), the finer side of a power of two)."""
    a = p.detach().float().abs()
    return bool((bound < 0.5 * torch.exp2(torch.floor(torch.log2(a)) - 8)).all())


def train(cfg) -> dict:
    """TRAIN_STEPS AdamW steps of the full model in bf16 through train_step;
    returns the kernels' launches in those steps."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.models import get_api
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.trainstep import (TrainHparams, _accum_grads, batch_to_torch,
                                             make_train_state, train_step)

    api = get_api(cfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(api, seed=0)
    model = state["model"]
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.num_layers} layers, {n_params / 1e9:.3f} B params in "
        f"{str(cfg.pdtype)[6:]}, fp32 AdamW moments, initialised in "
        f"{time.perf_counter() - t0:.1f} s; params and moments take "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    data = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                    mode="affine"))
    opt, hp = OptConfig(**TRAIN_OPT), TrainHparams(grad_accum=1)
    batches = [batch_to_torch(data.batch_at(i), DEVICE) for i in range(TRAIN_STEPS + 2)]

    flash_attention.launches = flash_attention_bwd.launches = 0
    rmsnorm.launches = rmsnorm_bwd.launches = 0
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        if i == 0:
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
        sync()
        t0 = time.perf_counter()
        metrics = train_step(model, state["opt"], batches[i], opt, hp)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        log(f"  step {i}: loss {losses[-1]:.4f}, lr {metrics['lr'].item():.3e}, grad_norm "
            f"{metrics['grad_norm'].item():.4g}, {step_ms[-1]:.1f} ms")
        if i == 0:
            lr0 = metrics["lr"].item()
            moved, absorbed, stuck = 0, [], []
            for n, p in model.named_parameters():
                if not torch.equal(p, before[n]):
                    moved += 1
                elif bf16_absorbs(before[n], lr0 * (1 + opt.weight_decay
                                                    * before[n].float().abs().max().item())):
                    absorbed.append(n)
                else:
                    stuck.append(n)
            del before
            log(f"  after step 0: {moved} of {moved + len(absorbed) + len(stuck)} parameters "
                f"changed; {len(absorbed)} unchanged because bf16 rounding absorbs any update "
                f"of at most lr (1 + wd max|p|) = {lr0 * (1 + opt.weight_decay):.3g} at their "
                f"values {sorted(set(absorbed))[:3]}...; {len(stuck)} unchanged otherwise {stuck}")
            if stuck:
                raise AssertionError(f"parameters unchanged after the first step: {stuck}")
    launches = {"flash_attention": flash_attention.launches,
                "flash_attention_bwd": flash_attention_bwd.launches,
                "rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm_bwd.launches}
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    expect = {"flash_attention": cfg.num_layers, "flash_attention_bwd": cfg.num_layers,
              "rmsnorm": 2 * cfg.num_layers + 1, "rmsnorm_bwd": 2 * cfg.num_layers + 1}
    med = statistics.median(step_ms[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / med * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  step {med:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}; step 0 {step_ms[0]:.1f} ms), "
        f"{tok_s:.0f} tok/s, peak device memory {peak:.2f} GiB")
    log(f"  launches per step: {per_step}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"a loss is not finite: {losses}")
    if per_step != expect:
        raise AssertionError(f"kernel launches per step {per_step} != {expect} implied by the path")
    profile_train_step(model, state["opt"], batches[TRAIN_STEPS], opt, hp, med)

    # one more step, split by CUDA events (outside the counted run): what
    # train_step does, its two parts timed apart
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    _, grads = _accum_grads(model, batches[TRAIN_STEPS + 1], hp.grad_accum)
    events[1].record()
    adamw_update(model, grads, state["opt"], opt)
    events[2].record()
    events[2].synchronize()
    del grads
    fwd_bwd, update = events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2])
    log(f"  one step split by CUDA events: loss and gradients {fwd_bwd:.1f} ms, AdamW update "
        f"{update:.1f} ms ({update / (fwd_bwd + update):.3f} of the step)")
    return launches


def profile_train_step(model, opt_state, batch, opt, hp, step_ms: float) -> None:
    """torch.profiler over one train step (outside the counted run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.trainstep import train_step

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(model, opt_state, batch, opt, hp)
        sync()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log("  profile train step: no device events (not measured)")
        return
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    log(f"  profile train step: {len(kern)} kernels, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / step_ms:.3f} of the unprofiled {step_ms:.1f} ms")
    families = {}  # device ms by kernel family, matched on the kernel's name
    for name, ms in by_name.items():
        fam = next((f for f, keys in TRAIN_FAMILIES if any(k in name for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + ms
    log("  by family: " + ", ".join(f"{f} {ms:.3f} ms"
                                    for f, ms in sorted(families.items(), key=lambda kv: -kv[1])))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {ms:8.3f} ms  {name[:100]}")
    # the RMSNorm backward's column sum (column_sum_kernel) falls under "other"
    names = sorted(n for n in by_name if "rmsnorm" in n or "column_sum" in n)
    log("  rmsnorm kernels and the backward's column sum: " + ", ".join(
        f"{by_name[n]:.3f} ms x{sum(e.name == n for e in kern)} {n[:60]}" for n in names))


def wkv_y_rounding_shift(api, model, tokens) -> None:
    """How far the bf16 prefill logits move when WKV6 hands the group norm y
    rounded to bf16 instead of the fp32 y that the model asks for (and that
    the JAX model normalises)."""
    from repro_torch.kernels import ops

    wkv6 = ops.wkv6
    with torch.inference_mode():
        logits = []
        for round_y in (False, True):
            if round_y:
                ops.wkv6 = lambda *a, out_dtype=None, **kw: wkv6(*a, **kw)
            try:
                out, _ = api.prefill(model, {"tokens": tokens},
                                     api.init_cache(tokens.shape[0], tokens.shape[1]))
            finally:
                ops.wkv6 = wkv6
            logits.append(out.float())
    diff = (logits[0] - logits[1]).abs()
    same = (logits[0].argmax(-1) == logits[1].argmax(-1)).float().mean().item()
    log(f"  prefill logits, fp32 y against y rounded to bf16: max_abs_diff {diff.max().item():.4g}, "
        f"mean_abs_diff {diff.mean().item():.4g} (logits max |{logits[0].abs().max().item():.4g}|), "
        f"argmax equal at {same:.4f} of positions")


def profile_phases(api, model, tokens, decode_ms: float, steps: int = 8) -> None:
    """torch.profiler over one prefill and ``steps`` decode steps (outside the
    counted run): device-busy time, kernels launched, and the top kernels by
    device time.  The idle share of a decode step is taken against the
    unprofiled decode time of the counted run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels_of(prof):
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    with torch.inference_mode():
        cache = api.init_cache(tokens.shape[0], tokens.shape[1] + steps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pre:
            logits, cache = api.prefill(model, {"tokens": tokens}, cache, last_only=True)
            tok = logits[:, -1].argmax(dim=-1)
            sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as dec:
            for _ in range(steps):
                logits, cache = api.decode(model, tok[:, None], cache)
                tok = logits[:, -1].argmax(dim=-1)
            sync()
    for what, prof, n in (("prefill", pre, 1), ("decode step", dec, steps)):
        kern = kernels_of(prof)
        if not kern:
            log(f"  profile {what}: no device events (not measured)")
            continue
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        extra = (f", idle share {1 - busy / decode_ms:.3f} of the unprofiled {decode_ms:.3f} ms"
                 if what == "decode step" else "")
        log(f"  profile {what}: {len(kern) / n:.0f} kernels, device busy {busy:.3f} ms{extra}")
        for name, ms in top:
            log(f"    {ms:8.3f} ms  {name[:100]}")


def ptxas_report(build_log: str) -> list:
    """One line per kernel instantiation from ``nvcc -Xptxas -v``: its name
    and template arguments, registers, shared memory and spills."""
    out, name = [], None
    for line in build_log.splitlines():
        hit = re.search(r"entry function '(\w+_kernel)I(\w+?)EEvNS_6ParamsE", line)
        if hit:  # Itanium mangling: <length><name>I<template arguments>E
            head = hit.group(1)
            name = next(head[-n:] for n in range(1, len(head)) if head[:-n].endswith(str(n)))
            args = re.findall(r"Li(-?\d+)E|Lb([01])E|(13__nv_bfloat16|S1_)|(f)", hit.group(2))
            name += "<" + ",".join(
                n or ({"1": "true", "0": "false"}[bo] if bo else "bf16" if b else "f32")
                for n, bo, b, _ in args) + ">"
            spills = ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            out.append(f"{name}: {line.split('Used', 1)[1].strip()}; {spills}")
            name = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch import configs
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {device_name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("build:")
    t0 = time.perf_counter()
    times = build.build_all()
    log(f"  built {sorted(times)} in {time.perf_counter() - t0:.1f} s")
    for source in sorted(times):
        for line in ptxas_report(build.build_log(source)):
            log(f"    {source}: {line}")

    gemma, rwkv = (configs.get_config(a) for a in ARCHS)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    log("kernels:")
    floor_ms = launch_floor_ms()
    log(f"  launch floor: one launch of a one-element kernel (add_) takes {floor_ms:.4f} ms "
        f"in time_ms's window")
    kernels = [check_flash(gen), check_rmsnorm(gen, gemma.d_model), *check_wkv6(gen, rwkv),
               check_flash_bwd(gen), check_rmsnorm_bwd(gen, gemma.d_model)]
    for k in kernels:
        k["launch_floor_ms"] = floor_ms
    torch.cuda.empty_cache()
    log("reference:")
    for cfg in (gemma, rwkv):
        check_reference(cfg)
        torch.cuda.empty_cache()
    check_train_reference(gemma)
    torch.cuda.empty_cache()
    log("serve:")
    runs = {}
    for cfg in (gemma, rwkv):
        torch.cuda.reset_peak_memory_stats()
        runs[cfg.name] = serve(cfg)
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    log("train:")
    trained = train(gemma)
    # each kernel's launches in the run of the path that drives it; the
    # forward kernels run in gemma-2b's serving and training alike
    paths = {f"serve {gemma.name}": runs[gemma.name], f"serve {rwkv.name}": runs[rwkv.name],
             f"train {gemma.name}": trained}
    driven_by = {"flash_attention": f"serve {gemma.name}", "rmsnorm": f"serve {gemma.name}",
                 "wkv6": f"serve {rwkv.name}", "wkv6_step": f"serve {rwkv.name}",
                 "flash_attention_bwd": f"train {gemma.name}",
                 "rmsnorm_bwd": f"train {gemma.name}"}
    for k in kernels:
        k["launches"] = paths[driven_by[k["name"]]][k["name"]]
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items() if n.get(k["name"])}
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
