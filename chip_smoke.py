"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: the card's name and power limit;
2. build: compiles the CUDA kernel sources of ``src/repro_torch/kernels/csrc``;
3. kernels: each hand-written kernel (flash attention, RMSNorm, the chunked
   and the short-sequence WKV6) against its plain PyTorch version on CUDA
   tensors, at the serving paths'
   shapes (flash attention also at grok-1's and jamba's prefill, whisper's
   encoder (4 x 12 heads x 1500 frames, full attention), its cross-attention
   over 1500 frames from a 416-token prefill and from a decode step, its
   decoder's causal self-attention over the 416-token prompt, and
   internvl2's prefill of 256 patches + 1024 tokens (GQA 14/2); bf16 flash
   cases are also held against their outputs' scale; RMSNorm at
   the MoE, hybrid and VLM models' widths) and at the other options of the
   TPU kernel it replaces, with times
   of the kernel, the plain version and one PyTorch library call where there
   is one, beside the least time the card could take;
   qwen2.5-14b's training at TP 4 gives flash attention (forward and
   backward) a rank's shape, 4 x 10 q heads / 2 kv heads x 1024, D 128,
   and RMSNorm (forward and backward) d 5120 over 4096 rows;
   The backward kernels of flash attention, RMSNorm and WKV6 are held
   against their plain versions the same way, at the training paths' shapes
   (flash attention's also at whisper's encoder, cross- and decoder
   self-attention, internvl2's GQA 14/2 and grok-1's GQA 48/8 with softcap
   30, held against the gradients' scale too; RMSNorm's at the MoE and VLM
   widths) and at the other options; each gives bit-identical gradients in
   two calls; flash
   attention's and WKV6's backward times are split by launch (torch.profiler;
   WKV6's: the state sweeps, the chunks, the carry of dlog_w), and flash's
   yardstick is SDPA's backward under the flash backend (or the backend that
   takes the shape where flash refuses it, named).  Two floors of the timing
   window are printed: one launch of a one-element kernel, and, beside the
   RMSNorm backward and the WKV6 decode step, a PyTorch call that moves the
   bytes the kernel must move;
4. reference: a full-width, 2-layer fp32 gemma-2b and rwkv6-1.6b,
   deepseek-v3-671b at full width cut to 2 layers (one dense, one MoE) and
   16 experts (top-8 kept), jamba-1.5-large-398b at full width cut to 2
   layers (its attention layer and a Mamba layer with MoE) and 3 experts
   (top-2 kept), whisper-small (with 1500 frames) cut to 2 encoder and 2
   decoder layers and internvl2-1b (with 256 patches) cut to 2 layers,
   each drawn on the card
   and copied to the CPU, on the card (kernels) against the same weights
   on the CPU (plain versions): logits, the decode step's logits and greedy
   tokens, and for the MoE models the routing decisions and the picks
   dropped at capacity that differ; then
   one AdamW step on the card against the same step on the CPU, in fp32, of
   gemma-2b, rwkv6-1.6b, whisper-small (2 + 2) and internvl2-1b cut to 2
   layers, deepseek-v3 cut to its MoE layer (16 experts) and grok-1 as the
   train phase cuts it, one row of 128 tokens:
   the loss, every parameter's gradient, the parameter update and the MoE
   models' routing decisions that differ, after a check that the host and
   the card hold 16 bytes a parameter;
5. serve: full-width gemma-2b (18 layers), rwkv6-1.6b (24 layers),
   deepseek-v3-671b cut to 4 layers (3 dense, 1 MoE: MLA, 256 experts),
   grok-1-314b cut to 2 layers (GQA 48/8 with softcap, 8 experts) and
   jamba-1.5-large-398b cut to one unit (1 GQA + 7 Mamba layers, MoE on 4)
   and 8 of its 16 experts (top-2 kept), and whisper-small and internvl2-1b
   at full width and depth, bf16,
   random weights from a fixed seed, each serving batch 4 x prompt 1024 +
   32 new tokens through ``ServeEngine.generate`` (whisper: 1500 frames
   and a prompt of 416, which fills its 448-token text context; internvl2:
   256 patches before the prompt), with the kernels' launch
   counts of each run (flash attention and RMSNorm on gemma-2b's,
   grok-1's, jamba's and internvl2's paths, flash attention on whisper's
   encoder, prefill and every decode step's cross-attention, RMSNorm on
   deepseek-v3's, whose MLA
   attention is plain torch, the chunked WKV6 kernel in rwkv6's prefill and
   the decode-step one in its decode steps), ``comm_profile`` against the
   analytic bytes (whisper's encoder output and internvl2's vision-prefix
   slots as fixed bytes), whisper's and internvl2's parameter counts
   against the config, and for the MoE models a second run that must give
   the same tokens; for jamba the selective-scan kernel's launches (7 a
   pass) and the Mamba mixers' share of the prefill;
6. train: full-width, full-depth gemma-2b, rwkv6-1.6b, whisper-small
   (1500 frames, its 448-token text context) and internvl2-1b (256 patches
   before the tokens), and deepseek-v3-671b cut to 2 layers (first_dense 1)
   and 16 experts (top-8 kept) and grok-1-314b cut to 1 layer and 4 of 8
   experts (top-2 kept), in bf16 with fp32 AdamW moments, random weights
   from a fixed seed, each 6 AdamW steps of batch 4 x 1024 tokens (whisper:
   448) of the synthetic affine data through ``train.trainstep.train_step``:
   the loss of every step (finite) and of the last step's batch after that
   step (below the step's), step ms,
   tok/s, peak device memory, the launches per step of the kernels on the
   path (flash attention and RMSNorm, forward and backward; the chunked
   WKV6 kernel and its backward for rwkv6), whether two gradient passes
   from one state are bit-identical, and a profile of one step;
7. launcher: the train launcher (``launch.train``): its control-plane line
   (job demand, MDMCF, LTRR) for gemma-2b and rwkv6-1.6b at 2 and 4 pods,
   then its data-plane loop on rwkv6-1.6b at full width cut to 2 layers
   (bf16, batch 4 x 1024): run A takes steps 0-3 with a background
   checkpoint after step 1 and the final one after step 3, run B restores a
   state of another seed from step 1 and takes steps 2-3, and B's losses
   and every parameter, moment and step must equal A's bit for bit; with
   the checkpoint's bytes on disk, the snapshot, write and restore times,
   the step time with and without a background write in flight, and the
   WKV6 launches of each run;
8. dist: the distributed train step over the data axes
   (``train.trainstep.make_train_step``) over NCCL at world 1, mesh (pod 1,
   data 1, model 1), where the int8 quantizer still runs: fp32 gemma-2b at
   full width cut to 2 layers through the hierarchical step with ZeRO-1
   and ``compress`` against the same step over gloo on the CPU (entries
   that meet a tie of the quantizer are counted and held to a looser
   bound), and the hierarchical step with ZeRO-1 against the
   single-device ``train_step``; then full gemma-2b in bf16 for 6 steps
   through the hierarchical step with ZeRO-1 and ``compress``: step ms
   beside the train phase's single-device step, peak memory, collective
   calls and bytes per mesh axis per step (held against the bytes the
   leaves imply) and the kernels' launches per step; on a host of 2 or 4
   cards, one rank a card on mesh (pod 2, data world / 2, model 1) against
   the single-device step on the whole batch (on one card it says that
   this part did not run).

9. tp: the model axis, tensor and expert parallelism
   (``dist.tensor_parallel``): qwen2.5-14b at full width cut to 2 layers in
   fp32, one row of 128 tokens, one hierarchical step with ZeRO-1 on mesh
   (pod 1, data 1, model 2), two ranks on one card over gloo with CUDA
   tensors (a check: NCCL refuses two ranks on one card, and the launcher
   takes one card a rank), each rank's loss, grad norm, parameter slices
   and moment slices against the single-device ``train_step`` on the card
   from the same seed; on a host of 4 or more cards the same check on
   (1, 1, 4) over NCCL, one rank a card, then full qwen2.5-14b (48 layers)
   in bf16, batch 4 x 1024, 6 hierarchical steps with ZeRO-1: step ms,
   tok/s, peak memory per rank, the kernels' launches per step against
   the path's, collective calls and bytes per mesh axis, and the link
   between the cards (``nvidia-smi topo -m``).

10. fsdp: ZeRO-3 over the data axes (``dist.fsdp``): gemma2-9b at full
   width cut to 2 layers (a local and a global layer) in fp32, one row of
   128 tokens a rank, one flat step with ``fsdp`` on mesh (pod 1, data 2,
   model 1), two ranks on one card over gloo with CUDA tensors (a check),
   each rank's loss, grad norm, parameter blocks and moment blocks against
   the single-device ``train_step`` on the card from the same seed and
   global batch; on a host of 4 or more cards the same check over NCCL on
   (1, 4, 1) and (2, 2, 1), then full gemma2-9b (42 layers) in bf16 with
   fp32 moments, batch 8 x 1024 (2 rows a rank), 6 flat FSDP steps on
   (1, 4, 1): the losses (the last batch's falls after its step), step
   ms, tok/s, peak memory on every rank, the kernels' launches a step
   against the path's, the DP group's collective calls and bytes against
   those the leaves imply, and the forward and backward alone against
   the rest of the step.

11. serve_tp: sharded serving (prefill and greedy decode on every rank of
   a mesh, ``ServeEngine(..., mesh=)``): on one card two ranks over gloo
   with CUDA tensors, fp32, against the single-device model on the same
   card from the same seed, 2 rows of 128 tokens + 4 new (+ 2 under
   ``fsdp``, whose every pass gathers the fp32 table twice): qwen2.5-14b and
   gemma-2b cut to 2 layers and deepseek-v3 as the reference phase cuts it
   at (1, 1, 2), gemma2-9b cut to 2 layers with ``fsdp`` at (1, 2, 1);
   each rank's logits, the greedy tokens gathered over the DP group, the
   MoE routing decisions, and the rank's cache bytes against those
   ``cache_specs`` gives it.  On a host of 4 or more cards the same over
   NCCL at (1, 1, 4) and (1, 2, 2) (gemma2-9b at (1, 4, 1) and (1, 2, 2)),
   then full qwen2.5-14b and deepseek-v3 cut to 4 layers in bf16 at TP 4,
   batch 4 x 1024 + 32: prefill ms, decode ms/token, tok/s, peak memory
   on every rank, launches, the model axis's collectives of a prefill and
   of a decode step by kind and shape, and qwen2.5-14b's greedy tokens
   against the whole model served on rank 0's card (recorded, not held).

qwen2.5-14b (48 layers, GQA 40/8, D 128, d 5120, q/k/v biases) serves
whole on one card in the serve phase, its prefill's flash shape (4 x 40 /
8 heads x 1024) runs in the kernels phase, and its parameters are held
against ``param_counts()``.

gemma2-9b (local/global attention, softcap 50, GQA 16/8, D 256, d 3584)
also runs in the kernels phase (flash forward at its prefill with and
without the window, its backward at an FSDP rank's 2 rows, RMSNorm at d
3584 both ways), the reference phase (2 layers, fp32, and one AdamW step)
and the serve phase (42 layers, parameters against ``param_counts()``).

12. fsdp_families: ZeRO-3 for rwkv6, jamba, whisper and the VLM: on one
   card two gloo ranks at (1, 2, 1), fp32, against the single-device model
   on the card: rwkv6-1.6b and internvl2-1b cut to 2 layers and
   whisper-small to 2 + 2, each served (prefill and 4 greedy decode steps)
   and one flat FSDP step; jamba cut to one Mamba layer with its dense MLP,
   one flat FSDP step (two ranks on one card keep twice what autograd holds
   of the gathered weights, and gloo gathers through the host).  On a host
   of 4 or more
   cards the same over NCCL at (1, 4, 1) and (1, 2, 2), jamba's unit at 2
   experts served and its 2-layer cut trained, then bf16 at full width at
   (1, 4, 1): jamba's 16-expert unit served with ``fsdp`` (4 x 1024 + 8),
   its 2-expert unit 6 flat FSDP steps of 4 x 1024, rwkv6-1.6b,
   whisper-small and internvl2-1b 2 steps each.  The kernels phase holds
   the selective scan and its backward (port-side: the JAX package has no
   Pallas kernel for the scan) against their plain versions at jamba's
   prefill and training shape, a TP-4 rank's channels, a decode step, S
   100 and 127 and decays near 0 and 1.

``--only dist`` runs the device and build phases and then the dist phase
alone; ``--only ranks`` its multi-rank check alone; ``--only tp`` the tp
phase alone (on a 4-card call, the NCCL check and the bf16 run); ``--only
fsdp`` the fsdp phase alone (on a 4-card call, the NCCL checks and the
bf16 run); ``--only serve_tp`` the serve_tp phase alone (on a 4-card call,
the NCCL checks and the bf16 runs at TP 4); ``--only fsdp_families`` the
selective-scan kernels and the fsdp_families phase (on a 4-card call, the
NCCL checks and the bf16 runs).

The line before the last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: 80 GB HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor core / fp32 CUDA core
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # the JAX kernel tests' tolerances
# bf16 attention over many keys gives outputs far below TOL's atol (std
# ~ sqrt(e / Sk): ~0.04 at Sk = 1500), so its error is also held against
# the output's own scale: at most 2**-6 of max|output|, 2 to 4 bf16 steps
# of the largest value (each side rounds P and the output once)
FLASH_BF16_SCALED = 2.0 ** -6
# backward kernels against their plain versions: fp32 sums of up to a few
# thousand products in another order; bf16: both sides compute in fp32 from
# the same bf16 inputs and round each gradient once
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
WKV_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}  # 1e-4 at log_w = -50, as in JAX
ARCHS = ("gemma-2b", "rwkv6-1.6b")
MOE_ARCHS = ("deepseek-v3-671b", "grok-1-314b")
HYBRID_ARCH = "jamba-1.5-large-398b"
WHISPER_ARCH, VLM_ARCH = "whisper-small", "internvl2-1b"
# depth cut to fit one card (jamba: one 8-layer unit of its 72 layers)
SERVE_LAYERS = {"deepseek-v3-671b": 4, "grok-1-314b": 2, HYBRID_ARCH: 8}
# experts cut to fit one card, top-k kept (jamba: 8 of 16, 25.4 B params in bf16)
SERVE_EXPERTS = {HYBRID_ARCH: 8}
SERVE_BATCH, PROMPT_LEN, MAX_NEW = 4, 1024, 32
WHISPER_CONTEXT = 448  # whisper's real text context (the config's 32768 rows size a dry run)
# whisper's prompt and new tokens fill its text context
SERVE_PROMPT = {WHISPER_ARCH: WHISPER_CONTEXT - MAX_NEW}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6
TRAIN_TEXT = {WHISPER_ARCH: WHISPER_CONTEXT}  # whisper trains on 1500 frames and 448 tokens
FSDP_ARCH = "gemma2-9b"
FSDP_ROWS = 2  # a rank's rows of the FSDP cell's global batch of 8 x 1024 on 4 cards
GEMMA2_WINDOW = 4096  # gemma2-9b's local layers' sliding window
LAUNCH_LAYERS, LAUNCH_STEPS = 2, 4  # the launcher phase: two checkpoints of 4.55 GB


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

def flash_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(q, k) pairs one head attends: all Sq x Sk, or under the causal mask
    (q and k positions both from 0) min(i + 1, Sk) for query i."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + (Sq - n) * Sk


def time_flash(case: dict, what: str, library: bool = True, **kw) -> dict:
    """The kernel, its plain version and SDPA (``is_causal`` as the case,
    ``enable_gqa=True``) on one checked case, beside the bound: q.k and p.v
    over the pairs this input needs, q, k, v read and o written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    q, k, v = case["q"], case["k"], case["v"]
    B, Hq, Sq, D = q.shape
    Sk, causal = k.shape[2], kw.get("causal", True)
    ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    plain_ms = time_ms(lambda: ref.mha_reference(q, k, v, **kw))
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True))
    library_ms = sdpa_ms if library else None
    flops = 4.0 * D * B * Hq * flash_pairs(Sq, Sk, causal)  # 2 flops per multiply-add
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    lib = (f"library (scaled_dot_product_attention, enable_gqa=True) {library_ms:.4f} ms"
           if library else "library: none (scaled_dot_product_attention has no softcap); "
           f"yardstick: scaled_dot_product_attention at this shape without the softcap "
           f"{sdpa_ms:.4f} ms")
    log(f"  flash_attention at {what} (B={B}, Hq={Hq}, Hkv={k.shape[1]}, Sq={Sq}, Sk={Sk}, "
        f"D={D}, {str(q.dtype)[6:]}, {kw or 'causal'}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {lib}, bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=case["err"],
                **({} if library else {"sdpa_without_softcap_ms": sdpa_ms}))


def check_flash(gen) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    from repro_torch import configs

    full = dict(causal=False)
    enc, nv = configs.get_config(WHISPER_ARCH).encoder_seq, configs.get_config(VLM_ARCH).vision_tokens
    prompt = SERVE_PROMPT[WHISPER_ARCH]
    cases = [  # (B, Hq, Hkv, Sq, Sk, D, dtype, options, the path it times or None)
        (SERVE_BATCH, 8, 1, PROMPT_LEN, PROMPT_LEN, 256, torch.bfloat16, {}, "main"),
        (SERVE_BATCH, 8, 1, PROMPT_LEN, PROMPT_LEN, 256, torch.float32, {}, None),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(causal=False), None),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(causal=False), None),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(window=64), None),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(window=64), None),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(softcap=30.0), None),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(softcap=30.0), None),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(window=32, softcap=50.0), None),
        (1, 4, 2, 256, 256, 64, torch.bfloat16, dict(window=32, softcap=50.0), None),
        (2, 4, 2, 256, 256, 64, torch.bfloat16, {}, None),
        (1, 8, 2, 128, 256, 128, torch.float32, {}, None),  # GQA, cross lengths
        (1, 8, 2, 128, 256, 128, torch.bfloat16, dict(window=100), None),
        (1, 2, 2, 100, 100, 32, torch.float32, {}, None),  # ragged Sq/Sk
        (1, 2, 2, 100, 100, 32, torch.bfloat16, {}, None),
        (1, 8, 1, 100, 173, 256, torch.bfloat16, dict(softcap=50.0), None),
        (2, 4, 2, 77, 77, 16, torch.float32, dict(window=8), None),  # smoke head_dim
        (2, 4, 2, 77, 77, 16, torch.bfloat16, dict(window=8), None),
        (SERVE_BATCH, 48, 8, PROMPT_LEN, PROMPT_LEN, 128, torch.bfloat16,
         dict(softcap=30.0), "grok-1's prefill"),
        (SERVE_BATCH, 64, 8, PROMPT_LEN, PROMPT_LEN, 128, torch.bfloat16, {},
         "jamba's prefill"),
        (SERVE_BATCH, 12, 12, enc, enc, 64, torch.bfloat16, full, "whisper's encoder"),
        (SERVE_BATCH, 12, 12, prompt, enc, 64, torch.bfloat16, full,
         "whisper's prefill cross-attention"),
        (SERVE_BATCH, 12, 12, 1, enc, 64, torch.bfloat16, full,
         "whisper's decode-step cross-attention"),
        (1, 4, 2, 100, 300, 64, torch.float32, full, None),  # full attention, Sq != Sk
        (SERVE_BATCH, 14, 2, nv + PROMPT_LEN, nv + PROMPT_LEN, 64,
         torch.bfloat16, {}, "internvl2's prefill"),
        (SERVE_BATCH, 12, 12, prompt, prompt, 64, torch.bfloat16, {},
         "whisper's decoder self-attention"),  # 6.5 tiles of 64: a ragged causal tile
        (TRAIN_BATCH, 10, 2, TRAIN_SEQ, TRAIN_SEQ, 128, torch.bfloat16, {},
         "qwen2.5-14b's TP-4 training"),  # a rank's 10 of 40 q heads, 2 of 8 kv heads
        (SERVE_BATCH, 40, 8, PROMPT_LEN, PROMPT_LEN, 128, torch.bfloat16, {},
         "qwen2.5-14b's prefill"),  # the whole model on one card: all 40 / 8 heads
        # gemma2-9b's prefill: its local layers' window of 4096 masks nothing at 1024
        (SERVE_BATCH, 16, 8, PROMPT_LEN, PROMPT_LEN, 256, torch.bfloat16,
         dict(window=GEMMA2_WINDOW, softcap=50.0), "gemma2-9b's prefill, local layer"),
        (SERVE_BATCH, 16, 8, PROMPT_LEN, PROMPT_LEN, 256, torch.bfloat16, dict(softcap=50.0),
         "gemma2-9b's prefill, global layer"),
    ]
    timed = {}
    for B, Hq, Hkv, Sq, Sk, D, dtype, kw, what in cases:
        # model layout (B, S, H, D) viewed as (B, H, S, D), as ops.attention passes it
        q = randn(gen, (B, Sq, Hq, D), dtype).transpose(1, 2)
        k = randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
        v = randn(gen, (B, Sk, Hkv, D), dtype).transpose(1, 2)
        out = flash_attention(q, k, v, **kw)
        expect = ref.mha_reference(q, k, v, **kw)
        sync()
        err = (out.float() - expect.float()).abs().max().item()
        ok = torch.allclose(out.float(), expect.float(), atol=TOL[dtype], rtol=TOL[dtype])
        scaled = ""
        if dtype == torch.bfloat16:
            top = expect.float().abs().max().item()
            ok = ok and err <= FLASH_BF16_SCALED * top
            scaled = f", {err / top:.3g} of max|out| {top:.3g} (tol {FLASH_BF16_SCALED:.4g})"
        log(f"  flash_attention B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} "
            f"{str(dtype)[6:]} {kw or 'causal'}: max_abs_err={err:.3g} (tol {TOL[dtype]})"
            f"{scaled} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version: {err}")
        if what is not None:
            timed[what] = (dict(q=q, k=k, v=v, err=err), kw)
        del q, k, v, out, expect

    at = {what: time_flash(case, what, library="softcap" not in kw, **kw)
          for what, (case, kw) in timed.items() if what != "main"}
    main = time_flash(timed["main"][0], "the prefill shape")
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:40", **main,
                at_grok_prefill=at["grok-1's prefill"], at_jamba_prefill=at["jamba's prefill"],
                at_whisper_encoder=at["whisper's encoder"],
                at_whisper_cross_prefill=at["whisper's prefill cross-attention"],
                at_whisper_cross_decode=at["whisper's decode-step cross-attention"],
                at_whisper_decoder_self=at["whisper's decoder self-attention"],
                at_internvl2_prefill=at["internvl2's prefill"],
                at_qwen_tp4_train=at["qwen2.5-14b's TP-4 training"],
                at_qwen_prefill=at["qwen2.5-14b's prefill"],
                at_gemma2_prefill_local=at["gemma2-9b's prefill, local layer"],
                at_gemma2_prefill_global=at["gemma2-9b's prefill, global layer"])


def check_rmsnorm(gen, d_model: int) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    from repro_torch import configs

    rows_main = SERVE_BATCH * PROMPT_LEN
    vlm_rows = SERVE_BATCH * (configs.get_config(VLM_ARCH).vision_tokens + PROMPT_LEN)
    cases = [  # (rows, d, dtype)
        (rows_main, d_model, torch.bfloat16),  # gemma-2b prefill
        (rows_main, d_model, torch.float32),
        (SERVE_BATCH, d_model, torch.bfloat16),  # gemma-2b decode step
        (rows_main - 1, d_model, torch.bfloat16),  # ragged last block of rows
        (1000, 896, torch.float32),  # widths that are not powers of two
        (333, 3584, torch.bfloat16),
        (64, 768, torch.float32),
        (17, 8192, torch.bfloat16),
        (rows_main, 7168, torch.bfloat16),  # deepseek-v3 prefill: ln1, ln2, final
        (rows_main, 1536, torch.bfloat16),  # its q_norm
        (rows_main, 512, torch.bfloat16),  # its kv_norm
        (rows_main, 6144, torch.bfloat16),  # grok-1 prefill
        (SERVE_BATCH, 7168, torch.bfloat16),  # decode steps
        (SERVE_BATCH, 1536, torch.bfloat16),
        (SERVE_BATCH, 512, torch.bfloat16),
        (SERVE_BATCH, 6144, torch.bfloat16),
        (rows_main, 8192, torch.bfloat16),  # jamba prefill: ln1, ln2, final
        (SERVE_BATCH, 8192, torch.bfloat16),  # its decode steps
        (300, 512, torch.float32),
        (300, 1536, torch.float32),
        (vlm_rows, 896, torch.bfloat16),  # internvl2 prefill: 256 patches + 1024 tokens
        (SERVE_BATCH, 896, torch.bfloat16),  # its decode steps
        (rows_main, 5120, torch.bfloat16),  # qwen2.5-14b's TP-4 training (4 x 1024 rows)
        (rows_main, 3584, torch.bfloat16),  # gemma2-9b prefill
        (SERVE_BATCH, 3584, torch.bfloat16),  # its decode steps
        (FSDP_ROWS * TRAIN_SEQ, 3584, torch.bfloat16),  # a rank's rows of its FSDP training
    ]
    main = None
    widths = {}  # the new paths' widths at their prefill rows
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
        elif (rows == rows_main and d in (512, 1536, 3584, 5120, 6144, 7168, 8192)
              or (rows, d) == (vlm_rows, 896)):
            widths[d] = (x, s)
        elif (rows, d) == (FSDP_ROWS * TRAIN_SEQ, 3584):
            widths["3584 (FSDP rank)"] = (x, s)

    by_width = {}
    for d, (x, s) in sorted(widths.items(), key=lambda kv: str(kv[0]).zfill(20)):
        nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
        by_width[d] = dict(ms=time_ms(lambda: rmsnorm(x, s)),
                           plain_ms=time_ms(lambda: ref.rmsnorm_reference(x, s)),
                           library_ms=time_ms(lambda: F.rms_norm(x, (x.shape[-1],), weight=s,
                                                                 eps=1e-6)),
                           bound_ms=bound(nbytes, 4.0 * x.numel(), x.dtype)[0])
    log("  rmsnorm at the MoE, hybrid, VLM and gemma2-9b paths' prefill widths, qwen2.5-14b's "
        "TP-4 training and a gemma2-9b FSDP rank's training rows (bf16): " + "; ".join(
        f"d={d} ({widths[d][0].shape[0]} rows) kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms" for d, t in by_width.items()))

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
                bound_by=bound_by, library_ms=library_ms, by_width=by_width)


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
        timed = time_wkv6(main[kernel]["args"], main[kernel]["out_dtype"], main[kernel]["err"],
                          kernel, f"the {what} shape")
        out.append(dict(name=kernel, route="cuda", source="src/repro_torch/kernels/csrc/wkv6.cu",
                        replaces="src/repro/kernels/rwkv6_wkv.py:37", **timed))
    return out


def time_wkv6(args, out_dtype, err: float, kernel: str, what: str) -> dict:
    """One WKV6 kernel (the chunked one or the decode step) and its plain
    version on one checked case, beside the bound; the decode step also
    beside a copy of its state."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import CHUNK, wkv6

    r, k, v, lw, u, s0 = args
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
    log(f"  {kernel} at {what} (B={B}, H={Hh}, T={T}, K=V={Kk}, bf16 r/k/v, "
        f"fp32 y): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library: none (no single PyTorch call computes WKV6), "
        f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.4f} GFLOP fp32, "
        f"{nbytes / 1e6:.1f} MB)"
        + (f"; a copy of the state (copy_) {extra['copy_ms']:.4f} ms" if extra else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, **extra)


def time_flash_bwd(args, what: str, err: float, library: bool = True,
                   every_backend: bool = False, **kw) -> dict:
    """The backward kernel, its plain version and SDPA's backward (where a
    backend takes the shape) on one checked case, beside the bound: five
    products per (q, k) pair this input needs; q, k, v, o, dO and the LSE
    read once, dq, dk and dv written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q, k, v, out, lse, dout = args
    B, Hq, Sq, D = q.shape
    Sk, causal = k.shape[2], kw.get("causal", True)
    ms = time_ms(lambda: flash_attention_bwd(q, k, v, out, lse, dout, **kw))
    plain_ms = time_ms(lambda: ref.mha_backward_reference(q, k, v, out, lse, dout, **kw), reps=5)
    library_ms, backend = (sdpa_backward_ms(q, k, v, dout, what, causal, every_backend)
                           if library else (None, None))
    yardstick = None
    if not library:  # SDPA has no softcap: its backward at the shape without it, a yardstick
        yardstick = sdpa_backward_ms(q, k, v, dout, f"{what} without the softcap", causal)
    # q.k, dO.v, P^T dO, dS K, dS^T Q: 2 flops per multiply-add each
    flops = 10.0 * D * B * Hq * flash_pairs(Sq, Sk, causal)
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel() + dout.numel()) \
        * q.element_size() + lse.numel() * 4
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    lib = (f"library (scaled_dot_product_attention backward, {backend} backend) "
           f"{library_ms:.4f} ms" if library
           else "library: none (scaled_dot_product_attention has no softcap); yardstick: its "
           f"backward without the softcap {yardstick[0]:.4f} ms ({yardstick[1]} backend)")
    log(f"  flash_attention_bwd at {what} (B={B}, Hq={Hq}, Hkv={k.shape[1]}, Sq={Sq}, Sk={Sk}, "
        f"D={D}, {str(q.dtype)[6:]}, {kw or 'causal'}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {lib}, bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_backend=backend,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                **({} if library else {"sdpa_without_softcap_ms": yardstick[0]}))


def check_flash_bwd(gen) -> dict:
    """The forward's LSE and the backward kernel against their plain
    versions, timed at gemma-2b's training shape and at the training shapes
    of whisper-small, internvl2-1b and grok-1; the bf16 cases of those paths
    are also held against the gradients' own scale, as the forward's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _forward, flash_attention_bwd

    from repro_torch import configs

    enc, nv = configs.get_config(WHISPER_ARCH).encoder_seq, configs.get_config(VLM_ARCH).vision_tokens
    text, full, bf16 = WHISPER_CONTEXT, dict(causal=False), torch.bfloat16
    cases = [  # (B, Hq, Hkv, Sq, Sk, D, dtype, options, the training path it times or None)
        (TRAIN_BATCH, 8, 1, TRAIN_SEQ, TRAIN_SEQ, 256, bf16, {}, "main"),  # gemma-2b training
        (TRAIN_BATCH, 8, 1, TRAIN_SEQ, TRAIN_SEQ, 256, torch.float32, {}, None),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(window=64), None),
        (1, 4, 2, 256, 256, 64, bf16, dict(window=64), None),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(softcap=30.0), None),
        (1, 4, 2, 256, 256, 64, bf16, dict(softcap=30.0), None),
        (1, 4, 2, 256, 256, 64, torch.float32, dict(causal=False), None),
        (1, 4, 2, 256, 256, 64, bf16, dict(window=32, softcap=50.0), None),
        (1, 8, 2, 128, 256, 128, torch.float32, dict(window=100), None),  # GQA, cross lengths
        (1, 8, 2, 256, 256, 128, bf16, {}, None),
        (1, 2, 2, 1000, 1000, 64, bf16, {}, None),  # ragged Sq = Sk
        (1, 2, 2, 1000, 1000, 128, torch.float32, {}, None),
        (1, 8, 1, 100, 173, 256, bf16, dict(softcap=50.0), None),
        (2, 4, 2, 77, 77, 16, torch.float32, dict(window=8, softcap=5.0), None),
        (1, 2, 2, 100, 100, 32, bf16, dict(causal=False, window=30), None),
        (1, 2, 2, 1000, 1000, 256, bf16, {}, None),  # 64-row tiles ending mid-tile
        (1, 8, 2, 300, 300, 256, bf16, dict(window=100, softcap=50.0), None),
        # the new training paths: 1500 = 23.4 tiles of 64, Sq != Sk without a
        # mask, 448 = 7 tiles, 7 and 6 q heads a kv head, softcap at D = 128
        (TRAIN_BATCH, 12, 12, enc, enc, 64, bf16, full, "whisper's encoder"),
        (TRAIN_BATCH, 12, 12, text, enc, 64, bf16, full, "whisper's cross-attention"),
        (TRAIN_BATCH, 12, 12, text, text, 64, bf16, {}, "whisper's decoder self-attention"),
        (TRAIN_BATCH, 14, 2, nv + TRAIN_SEQ, nv + TRAIN_SEQ, 64, bf16, {}, "internvl2's training"),
        (TRAIN_BATCH, 48, 8, TRAIN_SEQ, TRAIN_SEQ, 128, bf16, dict(softcap=30.0),
         "grok-1's training"),
        (TRAIN_BATCH, 10, 2, TRAIN_SEQ, TRAIN_SEQ, 128, bf16, {},
         "qwen2.5-14b's TP-4 training"),  # a rank's 10 of 40 q heads, 2 of 8 kv heads
        # a gemma2-9b FSDP rank's 2 rows: softcap 50 at D = 256, GQA 16/8
        (FSDP_ROWS, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 256, bf16,
         dict(window=GEMMA2_WINDOW, softcap=50.0), "gemma2-9b's FSDP training, local layer"),
        (FSDP_ROWS, 16, 8, TRAIN_SEQ, TRAIN_SEQ, 256, bf16, dict(softcap=50.0),
         "gemma2-9b's FSDP training, global layer"),
    ]
    timed = {}
    for B, Hq, Hkv, Sq, Sk, D, dtype, kw, what in cases:
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
        scaled = ""
        if what not in (None, "main"):  # also against each gradient's largest entry
            tops = [w.float().abs().max().item() for w in want]
            ok = ok and all(e <= FLASH_BF16_SCALED * t for e, t in zip(errs, tops))
            scaled = (", of max|g| " + " ".join(f"{e / t:.3g}" for e, t in zip(errs, tops))
                      + f" (tol {FLASH_BF16_SCALED:.4g})")
        log(f"  flash_attention_bwd B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} D={D} "
            f"{str(dtype)[6:]} {kw or 'causal'}: lse err={lse_err:.3g} (tol 1e-4), "
            f"max_abs_err dq={errs[0]:.3g} dk={errs[1]:.3g} dv={errs[2]:.3g} (tol {tol}){scaled} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash_attention_bwd disagrees with its plain version: {errs}")
        if what is not None:
            timed[what] = (dict(args=(q, k, v, out, lse, dout), err=max(errs)), kw)
        del q, k, v, dout, out, lse, grads, want

    at = {what: time_flash_bwd(case["args"], what, case["err"], library="softcap" not in kw, **kw)
          for what, (case, kw) in timed.items() if what != "main"}
    args = timed["main"][0]["args"]
    again = flash_attention_bwd(*args)
    sync()
    if not all(torch.equal(a, b) for a, b in zip(again, flash_attention_bwd(*args))):
        raise AssertionError("flash_attention_bwd: two calls on the same inputs differ")
    log("  flash_attention_bwd at the training shape: two calls give bit-identical dq, dk, dv")
    split = launch_split(lambda: flash_attention_bwd(*args), "flash_attention_bwd")
    log("  flash_attention_bwd at the training shape, device ms per call by launch "
        "(torch.profiler over 5 back-to-back calls): "
        + ", ".join(f"{name} {t:.4f}" for name, t in split.items()))
    main = time_flash_bwd(args, "gemma-2b's training shape", timed["main"][0]["err"],
                          every_backend=True)
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                replaces="src/repro/kernels/flash_attention.py:40", **main, ms_by_launch=split,
                at_whisper_encoder=at["whisper's encoder"],
                at_whisper_cross=at["whisper's cross-attention"],
                at_whisper_decoder_self=at["whisper's decoder self-attention"],
                at_internvl2_train=at["internvl2's training"],
                at_grok_train=at["grok-1's training"],
                at_qwen_tp4_train=at["qwen2.5-14b's TP-4 training"],
                at_gemma2_fsdp_train_local=at["gemma2-9b's FSDP training, local layer"],
                at_gemma2_fsdp_train_global=at["gemma2-9b's FSDP training, global layer"])


def launch_split(fn, what: str, calls: int = 5) -> dict:
    """Device ms per call of each kernel that ``fn()`` launches, from
    torch.profiler over ``calls`` back-to-back calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            hit = re.search(r"\w+_kernel(<[^>]*>)?", e.name)
            name = hit.group(0) if hit else e.name[:60]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    if not split:
        raise AssertionError(f"torch.profiler saw no device time in {what}")
    return split


def sdpa_backward_ms(q, k, v, dout, what: str, causal: bool = True,
                     every_backend: bool = True) -> tuple:
    """The yardstick: SDPA's backward through autograd (timed only: the port
    never calls it).  With ``every_backend``, under each backend alone and as
    PyTorch dispatches it by default; else the backends in order until one
    takes the shape.  Returns (ms, backend): the flash backend's time or,
    where flash refuses the shape, that of the first backend that takes it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def forward(backend):
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
            return leaves, F.scaled_dot_product_attention(*leaves, is_causal=causal,
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
        if not every_backend:
            break
    default = f"; default dispatch {grad_ms(*forward(None)):.4f} ms" if every_backend else ""
    log(f"  scaled_dot_product_attention backward at {what}, by backend: "
        + ", ".join(f"{n} {t:.4f} ms" if isinstance(t, float) else f"{n} {t}"
                    for n, t in times.items()) + default)
    served = next(((n, t) for n, t in times.items() if isinstance(t, float)), None)
    if served is None:
        raise AssertionError(f"no scaled_dot_product_attention backend takes {what}")
    return served[1], served[0]


def check_rmsnorm_bwd(gen, d_model: int) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd

    from repro_torch import configs

    rows_main = TRAIN_BATCH * TRAIN_SEQ
    vlm_rows = TRAIN_BATCH * (configs.get_config(VLM_ARCH).vision_tokens + TRAIN_SEQ)
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
        # the new training paths: teams of 32, 64 (56 threads live), 128 and 512
        (rows_main, 7168, torch.bfloat16, "train"),  # deepseek-v3: ln1, ln2, final
        (rows_main, 1536, torch.bfloat16, "train"),  # its q_norm
        (rows_main, 512, torch.bfloat16, "train"),  # its kv_norm
        (rows_main, 6144, torch.bfloat16, "train"),  # grok-1
        (vlm_rows, 896, torch.bfloat16, "train"),  # internvl2: 256 patches + 1024 tokens
        (rows_main, 5120, torch.bfloat16, "train"),  # qwen2.5-14b at TP 4: ln1, ln2, final
        (FSDP_ROWS * TRAIN_SEQ, 3584, torch.bfloat16, "train"),  # a gemma2-9b FSDP rank
    ]
    main = determinism_args = None
    widths = {}  # the new training paths' widths
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
        log(f"  rmsnorm_bwd rows={rows} d={d} {str(dtype)[6:]}"
            f"{', ' + option if option and option != 'train' else ''}: "
            f"max_abs_err dx={err:.3g} "
            f"(tol {tol}), dscale={ds_err:.3g} (tol {tol} x max|dscale| {ds_scale:.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"rmsnorm_bwd disagrees with its plain version: {err}, {ds_err}")
        if main is None:
            main = dict(args=(x, s, g), err=err, dtype=dtype)
        if (rows, d) == (333, 3584):
            determinism_args = (x, s, g)
        if option == "train":
            widths[d] = dict(args=(x, s, g), err=err)

    by_width = {}
    for d, case in sorted(widths.items()):
        x, s, g = case["args"]
        xl, sl = x.detach().requires_grad_(), s.detach().requires_grad_()
        y = F.rms_norm(xl, (d,), weight=sl, eps=1e-6)
        nbytes = 3 * x.numel() * x.element_size() + 2 * s.numel() * s.element_size()
        t_bound, t_by = bound(nbytes, 11.0 * x.numel(), x.dtype)
        by_width[d] = dict(rows=x.shape[0], ms=time_ms(lambda: rmsnorm_bwd(x, s, g)),
                           plain_ms=time_ms(lambda: ref.rmsnorm_backward_reference(x, s, g)),
                           library_ms=time_ms(lambda: torch.autograd.grad(
                               y, (xl, sl), g, retain_graph=True)),
                           bound_ms=t_bound, bound_by=t_by, max_abs_err=case["err"])
        del xl, sl, y
    log("  rmsnorm_bwd at the MoE, VLM, qwen2.5-14b TP-4 and gemma2-9b FSDP training paths' "
        "widths (bf16): "
        + "; ".join(
        f"d={d} ({t['rows']} rows) kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
        f"library (rms_norm backward) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
        f"by {t['bound_by']}"
        for d, t in by_width.items()))

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
                bound_by=bound_by, library_ms=library_ms, copy_ms=copy_ms, by_width=by_width)


def wkv6_grads_err(got, want, r) -> tuple:
    """(largest error of each gradient relative to its largest entry, the
    largest absolute error of any, ok):
    dr, dk and dv within WKV_TOL of r's dtype, dlog_w, du and ds0 within the
    fp32 one.  dlog_w is a difference of suffix sums whose common terms are
    as large as r dr and cancel where the decay is strong (log_w = -50), so
    its scale is the larger of its own largest entry and r dr's."""
    floor = (r.float() * want[0].float()).abs().max().item()
    errs, abs_err, ok = [], 0.0, True
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.float().abs().max().item()
        if i == 3:
            scale = max(scale, floor)
        tol = WKV_TOL[r.dtype] if i < 3 else WKV_TOL[torch.float32]
        err = (g.float() - w.float()).abs().max().item()
        errs.append(err / max(scale, 1e-30))
        abs_err = max(abs_err, err)
        ok = (ok and g.dtype == w.dtype and bool(torch.isfinite(g.float()).all())
              and torch.allclose(g.float(), w.float(), atol=tol * scale, rtol=tol))
    return errs, abs_err, ok


def check_wkv6_bwd(gen, cfg) -> dict:
    """The WKV6 backward kernel against its plain version, timed at
    rwkv6-1.6b's training shape as the model calls it (zero s0, no gradient
    of the final state, fp32 dy from the fp32 y)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6_bwd

    K = cfg.rwkv.head_dim
    H = cfg.d_model // K
    bf16, f32 = torch.bfloat16, torch.float32
    model = dict(s0=False, ds_final=False)  # the rwkv6 model's call
    cases = [  # (B, H, T, K, r/k/v dtype, dy dtype, options)
        (TRAIN_BATCH, H, TRAIN_SEQ, K, bf16, f32, model),  # rwkv6-1.6b training
        (TRAIN_BATCH, H, TRAIN_SEQ, K, bf16, f32, {}),
        (TRAIN_BATCH, H, TRAIN_SEQ, K, f32, f32, {}),
        (2, 3, 1, K, f32, f32, {}),  # the lengths of a staged chunk's edges
        (2, 3, 31, 32, f32, f32, {}),
        (2, 3, 45, 16, f32, f32, {}),
        (2, 3, 45, K, bf16, bf16, {}),  # a bf16 y
        (3, 2, 77, 32, bf16, f32, {}),
        (2, 3, 1, 16, bf16, f32, model),
        (2, 3, 31, 16, f32, f32, dict(log_w=-50.0)),  # extreme decay
        (1, 2, 45, 32, f32, f32, dict(log_w=-50.0)),
        (2, 3, 45, K, f32, f32, dict(layout="(B, H, T, K)")),  # contiguous, not the model's
        (2, 3, 32, K, f32, f32, {}),  # one whole chunk of the kernels' 32 tokens
        (2, 3, 33, K, bf16, f32, {}),  # a chunk and one token
        (1, 4, 1000, K, bf16, f32, {}),  # several chunks, a ragged tail
        (1, 4, 1000, K, f32, f32, dict(log_w=-50.0)),
        (2, 3, 100, 16, f32, f32, {}),
        (2, 3, 100, 32, bf16, f32, {}),
        (2, 3, 77, 32, f32, f32, dict(layout="unaligned")),  # plain loads, not cp.async
        (2, 3, 77, K, bf16, bf16, dict(layout="unaligned")),
    ]
    main = None
    for B, Hh, T, Kk, dtype, dy_dtype, kw in cases:
        def draw(dt, fill=None):
            n = B * T * Hh * Kk
            x = (randn(gen, (n + 1,), dt) if fill is None
                 else torch.full((n + 1,), fill, device=DEVICE, dtype=dt))
            x = (x[1:] if kw.get("layout") == "unaligned" else x[:n]).view(B, T, Hh, Kk)
            return x.transpose(1, 2).contiguous() if "layout" in kw and kw["layout"] != "unaligned" \
                else x.transpose(1, 2)
        r, k, v = (draw(dtype) for _ in range(3))
        lw = draw(f32, kw["log_w"]) if "log_w" in kw else -torch.exp(draw(f32))
        u = randn(gen, (Hh, Kk), f32)
        s0 = (randn(gen, (B, Hh, Kk, Kk), f32) if kw.get("s0", True)
              else torch.zeros((B, Hh, Kk, Kk), device=DEVICE))
        dy = draw(dy_dtype)
        ds = randn(gen, (B, Hh, Kk, Kk), f32) if kw.get("ds_final", True) else None
        args = (r, k, v, lw, u, s0, dy, ds)
        got = wkv6_bwd(*args)
        want = ref.wkv6_backward_reference(*args)
        sync()
        errs, abs_err, ok = wkv6_grads_err(got, want, r)
        log(f"  wkv6_bwd B={B} H={Hh} T={T} K=V={Kk} {str(dtype)[6:]} dy {str(dy_dtype)[6:]}"
            f"{' s0 random' if kw.get('s0', True) else ' s0=0'}"
            f"{' ds_final random' if ds is not None else ' no ds_final'}"
            f"{' log_w=-50' if 'log_w' in kw else ''} "
            f"{kw.get('layout', '(B, T, H, K) view').replace('unaligned', '(B, T, H, K) view one element in')}: "
            + " ".join(f"{n}={e:.3g}" for n, e in zip(("dr", "dk", "dv", "dlog_w", "du", "ds0"),
                                                       errs))
            + f" (relative to max|g|; tol {WKV_TOL[dtype]} for dr/dk/dv, "
              f"{WKV_TOL[f32]} for the rest) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"wkv6_bwd disagrees with its plain version: {errs}")
        if main is None:
            main = dict(args=args, err=abs_err, dtype=dtype)

    args = main["args"]
    r, k, v, lw, u, s0, dy, _ = args
    first, second = wkv6_bwd(*args), wkv6_bwd(*args)
    sync()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("wkv6_bwd: two calls on the same inputs differ")
    log("  wkv6_bwd at the training shape: two calls give bit-identical dr, dk, dv, dlog_w, du "
        "and ds0")
    split = launch_split(lambda: wkv6_bwd(*args), "wkv6_bwd")
    log("  wkv6_bwd at the training shape, device ms per call by launch (torch.profiler over 5 "
        "back-to-back calls): " + ", ".join(f"{name} {t:.4f}" for name, t in split.items()))
    return dict(name="wkv6_bwd", route="cuda", source="src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                replaces="src/repro/kernels/rwkv6_wkv.py:37",
                **time_wkv6_bwd(args, main["err"], "the training shape"), ms_by_launch=split)


def time_wkv6_bwd(args, err: float, what: str) -> dict:
    """The WKV6 backward kernel and its plain version on one checked case
    as the model calls it (zero s0, no ds_final), beside the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wkv6 import wkv6_bwd

    r, k, v, lw, u, s0, dy, _ = args
    B, Hh, T, Kk = r.shape
    ms = time_ms(lambda: wkv6_bwd(*args))
    plain_ms = time_ms(lambda: ref.wkv6_backward_reference(*args), reps=5)
    # bytes: r, k, v, log_w, u, s0 and dy read once (no ds_final); dr, dk, dv,
    # dlog_w, du and ds0 written once
    nbytes = (2 * (r.numel() + k.numel() + v.numel()) * r.element_size() + 2 * lw.numel() * 4
              + u.numel() * 4 + 2 * s0.numel() * 4 + dy.numel() * dy.element_size()
              + Hh * Kk * 4)
    # per token and state entry: S rebuilt (3), S dy (2), G v (2), G^T k (2), G updated (3)
    flops = 12.0 * B * Hh * T * Kk * Kk
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)  # the recurrence is fp32
    log(f"  wkv6_bwd at {what} (B={B}, H={Hh}, T={T}, K=V={Kk}, bf16 r/k/v, fp32 dy, "
        f"zero s0, no ds_final): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library: none "
        f"(no single PyTorch call computes WKV6's gradient), bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops / 1e9:.2f} GFLOP fp32, {nbytes / 1e6:.1f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


SCAN_TOL = 1e-5  # the scan's fp32 output, relative to max|y|: sums in another order
SCAN_BWD_TOL = 1e-4  # each fp32 gradient relative to its max: the CPU tests' bound


def scan_inputs(gen, B: int, S: int, D: int, N: int, decay: str = "model",
                h0: bool = False) -> tuple:
    """(dt, dtx, B, C, A, h0) as the Mamba mixer hands them to the scan:
    dt = softplus of a unit normal, dtx = dt x a unit normal, B and C unit
    normals, A = -(1 .. N) on every channel (JAX's S4D-real init), h0 zero
    (a prefill) or a unit normal.  ``decay`` "near 0" makes dt 5 to 10
    (exp(dt A) < 7e-3), "near 1" 1e-5 to 1e-4 (exp(dt A) > 0.998)."""
    f32 = torch.float32
    if decay == "near 0":
        dt = 5.0 + 5.0 * torch.rand((B, S, D), generator=gen, device=DEVICE)
    elif decay == "near 1":
        dt = 1e-5 + 9e-5 * torch.rand((B, S, D), generator=gen, device=DEVICE)
    else:
        dt = F.softplus(randn(gen, (B, S, D), f32))
    dtx = dt * randn(gen, (B, S, D), f32)
    Bm, Cm = randn(gen, (B, S, N), f32), randn(gen, (B, S, N), f32)
    A = -torch.arange(1, N + 1, dtype=f32, device=DEVICE).expand(D, N).contiguous()
    h = randn(gen, (B, D, N), f32) if h0 else torch.zeros((B, D, N), device=DEVICE)
    return dt, dtx, Bm, Cm, A, h


SCAN_STATE_TOKENS = 64  # tokens between the saved states a bound counts: JAX's chunk


def scan_bytes(B: int, S: int, D: int, N: int, backward: bool) -> tuple:
    """(bytes, fp32 operations) of the scan, each input read once and each
    output written once.  Forward: dt and dtx read and y written (B, S, D),
    B and C read, A read, h0 read and h_S written; an exp and three
    operations per token and state.  Backward: dt, dtx and dy read, ddt and
    ddtx written, B and C read, dB and dC written, A read and dA written,
    the saved states (B, S / 64, D, N) read and dh0 written (no gradient of
    h_S, as the model's call); the chunk run again (4) and the reverse step
    (12) per token and state.  The states are counted at JAX's chunk of
    ``SCAN_STATE_TOKENS``, whatever the kernels keep, so that the bound does
    not move with their design."""
    bsd, bsn, dn, bdn = B * S * D, B * S * N, D * N, B * D * N
    if not backward:
        return 4 * (3 * bsd + 2 * bsn + dn + 2 * bdn), 4.0 * bsd * N
    states = B * -(-S // SCAN_STATE_TOKENS) * D * N
    return 4 * (5 * bsd + 4 * bsn + 2 * dn + states + bdn), 16.0 * bsd * N


def check_selective_scan(gen, cfg) -> list:
    """The selective-scan kernel and its backward against their plain
    versions (``ref.selective_scan_reference``, JAX's chunked doubling scan,
    and ``ref.selective_scan_backward_reference``) on the card: at jamba's
    prefill and training shape (B 4, S 1024, d_in 16384, N 16), a TP-4
    rank's (d_in 4096), an FSDP rank's one row (B 1), a decode step (S 1,
    from a random state), S 100, 127, 64 and 65 (JAX's chunk rule gives
    chunks of 4, 1, 64 and 5 to the plain version), with decays near 0 and
    near 1, and at S 15 and 16, where the forward goes from 4 states a
    thread to 8.  y within SCAN_TOL of max|y|, each gradient within
    SCAN_BWD_TOL of its max; two backward calls bit-identical at jamba's
    shape and at the TP-4 rank's; each timed at
    the three training shapes and the forward at the decode step (median of
    30, CUDA events) beside its bound and the plain version.  Returns the two kernels'
    entries (jamba's prefill shape)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import (_launch, fwd_states, selective_scan,
                                                    selective_scan_bwd)

    mc = cfg.mamba
    D, N = mc.expand * cfg.d_model, mc.d_state
    cases = [  # (what, B, S, d_in, decay, random h0)
        ("jamba's prefill and training", TRAIN_BATCH, TRAIN_SEQ, D, "model", False),
        ("a TP-4 rank's", TRAIN_BATCH, TRAIN_SEQ, D // 4, "model", False),
        ("an FSDP rank's row", 1, TRAIN_SEQ, D, "model", False),
        ("a decode step", SERVE_BATCH, 1, D, "model", True),
        ("S 100", 2, 100, D // 4, "model", True),
        ("S 127", 2, 127, D // 4, "model", True),
        ("S 64", 2, 64, D // 4, "model", True),
        ("S 65", 2, 65, D // 4, "model", True),
        ("decays near 0", TRAIN_BATCH, TRAIN_SEQ, D // 4, "near 0", True),
        ("decays near 1", TRAIN_BATCH, TRAIN_SEQ, D // 4, "near 1", True),
        ("S 15", 2, 15, D // 4, "model", True),
        ("S 16", 2, 16, D // 4, "model", True),
    ]
    timed = {}
    for what, B, S, d_in, decay, h0 in cases:
        args = scan_inputs(gen, B, S, d_in, N, decay, h0)
        y, h = selective_scan(*args)
        y_p, h_p = ref.selective_scan_reference(*args)
        dy = randn(gen, (B, S, d_in), torch.float32)
        dh = None if not h0 else randn(gen, (B, d_in, N), torch.float32)
        got = selective_scan_bwd(*args, dy, dh)
        want = ref.selective_scan_backward_reference(*args, dy, dh)
        sync()
        top = y_p.abs().max().item()
        y_err = max((y - y_p).abs().max().item(), (h - h_p).abs().max().item()) / top
        g_errs = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                  for a, b in zip(got, want)]
        ok = y_err <= SCAN_TOL and max(g_errs) <= SCAN_BWD_TOL
        log(f"  selective_scan {what} (B={B}, S={S}, d_in={d_in}, N={N}, decays {decay}, "
            f"h0 {'random' if h0 else 'zero'}; forward states a thread "
            f"{fwd_states(S, N)}): y and h_S at {y_err:.3g} of max|y| (tol "
            f"{SCAN_TOL}); backward " + " ".join(
                f"{n}={e:.3g}" for n, e in zip(("ddt", "ddtx", "dB", "dC", "dA", "dh0"), g_errs))
            + f" of each max|g| (tol {SCAN_BWD_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"selective_scan {what}: the kernels disagree with their plain "
                                 f"versions: y {y_err}, gradients {g_errs}")
        if (S == TRAIN_SEQ and decay == "model") or S == 1:
            timed[what] = (args, dy, (y - y_p).abs().max().item(),
                           max((a - b).abs().max().item() for a, b in zip(got, want)))
        del y, h, y_p, h_p, got, want
        torch.cuda.empty_cache()
    for what in ("jamba's prefill and training", "a TP-4 rank's"):
        args, dy, _, _ = timed[what]
        first, second = (selective_scan_bwd(*args, dy) for _ in range(2))
        sync()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"selective_scan_bwd at {what} shape: two calls on the same "
                                 "inputs differ")
        log(f"  selective_scan_bwd at {what} shape: two calls give bit-identical ddt, ddtx, "
            "dB, dC, dA and dh0")
        del first, second
    out = {}
    for what, (args, dy, y_err, g_err) in timed.items():
        B, S, d_in = args[0].shape
        hs = _launch(*args, keep=True)[2] if S > 1 else None  # the training forward's states
        for name, fn, plain, err, backward, reps in (
                ("selective_scan", lambda: selective_scan(*args),
                 lambda: ref.selective_scan_reference(*args), y_err, False, 5),
                ("selective_scan_bwd", lambda: selective_scan_bwd(*args, dy, hs=hs),
                 lambda: ref.selective_scan_backward_reference(*args, dy), g_err, True, 3)):
            if backward and S == 1:
                continue  # a decode step takes no gradient
            nbytes, flops = scan_bytes(B, S, d_in, N, backward)
            bound_ms, bound_by = bound(nbytes, flops, torch.float32)
            t = dict(max_abs_err=err, ms=time_ms(fn), plain_ms=time_ms(plain, reps=reps),
                     bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            log(f"  {name} at {what} shape (B={B}, S={S}, d_in={d_in}, N={N}): kernel "
                f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library: none (no single "
                f"PyTorch call computes the selective scan), bound {bound_ms:.4f} ms by "
                f"{bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP fp32)")
            out.setdefault(name, {})[what] = t
        del hs
        torch.cuda.empty_cache()
    main = "jamba's prefill and training"
    more = {"at_tp4_rank": "a TP-4 rank's", "at_fsdp_row": "an FSDP rank's row",
            "at_decode_step": "a decode step"}
    return [dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{name}.cu",
                 replaces="none: the JAX package computes the scan in XLA "
                          "(src/repro/models/ssm.py:148), no Pallas kernel",
                 **out[name][main],
                 **{key: out[name][what] for key, what in more.items() if what in out[name]})
            for name in ("selective_scan", "selective_scan_bwd")]


# ---------------------------------------------------------------------------
# the model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def moe_reference_config(cfg):
    """deepseek-v3 at full width for the card-vs-CPU check: fp32 MoE at 256
    experts is ~46 GB a side, so 2 layers (``first_dense`` 1: one dense, one
    MoE layer) and 16 experts, top-8 kept."""
    return cfg.replace(num_layers=2,
                       moe=dataclasses.replace(cfg.moe, first_dense=1, num_experts=16))


def moe_train_config(cfg):
    """The MoE models cut for training on one card, whose state takes 12
    bytes a parameter (bf16 parameters and gradients, fp32 m and v), and for
    their fp32 train reference: deepseek-v3 as its reference above (3.37 B
    parameters, 40.5 GB of state); grok-1 to 1 layer and 4 of its 8
    experts, top-2 kept (3.31 B, 39.7 GB)."""
    if cfg.attn_kind == "mla":
        return moe_reference_config(cfg)
    return cfg.replace(num_layers=1, moe=dataclasses.replace(cfg.moe, num_experts=4))


def one_moe_layer(cfg):
    """deepseek-v3's train cut at one layer, its MoE layer (``first_dense``
    0), for the fp32 train reference, whose CPU step set the one-card run's
    time (81.7–125.8 s at 2 layers)."""
    return cfg.replace(num_layers=1, moe=dataclasses.replace(cfg.moe, first_dense=0))


def moe_cut(cfg) -> str:
    from repro_torch import configs

    full = configs.get_config(cfg.name)
    return (f"cut to {cfg.num_layers} of {full.num_layers} layers"
            + (f" (first_dense {cfg.moe.first_dense})" if cfg.moe.first_dense else "")
            + f" and {cfg.moe.num_experts} of {full.moe.num_experts} experts "
              f"(top-{cfg.moe.top_k} kept)")


@contextlib.contextmanager
def routing_recorded(calls: list):
    """While open, appends (expert_idx, dropped) of every MoE routing call to
    ``calls``, on the CPU: the picks and those past their expert's capacity."""
    from repro_torch.models import moe

    route = moe.route

    def recorded(mod, xt, cfg_, capacity=None, rows_dp=None):
        r = route(mod, xt, cfg_, capacity, rows_dp)
        calls.append((r.expert_idx.detach().cpu(), (r.slot == r.dispatch.numel()).cpu()))
        return r

    moe.route = recorded
    try:
        yield calls
    finally:
        moe.route = route


def log_routing(routed: dict) -> None:
    """The routing decisions and capacity drops that differ between the
    card's and the CPU's recorded calls."""
    if [t.shape for t, _ in routed["cpu"]] != [t.shape for t, _ in routed["card"]]:
        raise AssertionError("the card and the CPU routed different numbers of tokens")
    pairs = list(zip(routed["cpu"], routed["card"]))
    differ = sum(int((a != b).sum()) for (a, _), (b, _) in pairs)
    drop_differ = sum(int((a != b).sum()) for (_, a), (_, b) in pairs)
    total = sum(t.numel() for t, _ in routed["cpu"])
    drops = [sum(int(d.sum()) for _, d in routed[n]) for n in ("card", "cpu")]
    log(f"  routing decisions (token, k) of {len(routed['cpu'])} MoE calls that differ "
        f"between card and CPU: {differ} of {total}; picks dropped at capacity: card "
        f"{drops[0]}, CPU {drops[1]}, {drop_differ} of them differ")


def jamba_two_layers(cfg):
    """jamba at full width cut to 2 layers: its attention layer and one Mamba
    layer with MoE (the block pattern's first and a Mamba layer; the pattern
    asks for 8, so it is cut to ("attn", "mamba"))."""
    return cfg.replace(num_layers=2, block_pattern=("attn", "mamba"))


def hybrid_reference_config(cfg):
    """jamba at full width for the card-vs-CPU check: :func:`jamba_two_layers`
    with 3 experts, top-2 kept, so that the router chooses and capacity can
    drop picks; 3.9 B fp32 parameters, 15.5 GB a side (one whole unit was
    13.3 B, 53.2 GB, and its CPU side took 101-157 s of the one-card run)."""
    return jamba_two_layers(cfg).replace(moe=dataclasses.replace(cfg.moe, num_experts=3))


def release_host_memory() -> None:
    """Hands the host memory that the CPU side freed back to the system:
    glibc keeps freed chunks in its arenas, so without this most of an fp32
    MoE reference's tens of GB stay out of MemAvailable, which the next
    reference's memory check reads."""
    import ctypes

    ctypes.CDLL("libc.so.6").malloc_trim(0)


HOST_MEMORY_WAIT_S = 90


def host_available_bytes(need: float = 0.0) -> int:
    """MemAvailable, read again once a second after ``release_host_memory``
    until it reaches ``need`` bytes or HOST_MEMORY_WAIT_S pass: right after
    an fp32 reference of ~53 GB a side, 30–40 GB of it were still out of
    MemAvailable and came back within ~20 s, so a check made at once may
    read too little for the next reference."""
    def read():
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("/proc/meminfo has no MemAvailable line")

    t0 = time.monotonic()
    free = read()
    while free < need and time.monotonic() - t0 < HOST_MEMORY_WAIT_S:
        time.sleep(1.0)
        release_host_memory()
        free = read()
    if time.monotonic() - t0 >= 1.0:
        log(f"  waited {time.monotonic() - t0:.0f} s for {need / 1e9:.1f} GB of host memory: "
            f"{free / 1e9:.1f} GB available")
    return free


def check_reference(cfg, cut: str = "2-layer", full_depth: bool = False) -> None:
    """The model, cut to 2 layers or one unit of its block pattern if that
    is longer (or at ``full_depth``), on the card against the same weights
    on the CPU.  The weights are drawn on the card and copied to the CPU
    (drawing ~10 B fp32 values on the host is slow), after a check that the
    host can hold them."""
    from repro_torch.models import get_api, modality_inputs
    from repro_torch.models.registry import model_class
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    small = cfg.replace(param_dtype="float32", compute_dtype="float32")
    if not full_depth:
        small = small.replace(num_layers=max(2, len(cfg.block_pattern or ())))
    cpu_api, gpu_api = get_api(small, device="cpu"), get_api(small, device=DEVICE)
    cls = model_class(small)
    need = 4 * sum(p.numel() for p in cls(small, torch.device("meta")).parameters())
    free = host_available_bytes(1.25 * need)
    log(f"  {cfg.name} {cut} fp32: {need / 1e9:.2f} GB of weights a side; host memory "
        f"available {free / 1e9:.1f} GB")
    if free < 1.25 * need:
        raise RuntimeError(f"the CPU side needs {need / 1e9:.2f} GB and more for its "
                           f"activations; the host has {free / 1e9:.1f} GB available")
    gpu_model = gpu_api.init(seed=1)
    cpu_model = cls(small, torch.device("cpu"))
    cpu_model.load_state_dict(gpu_model.state_dict())
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, small.vocab_size, size=(2, 128))
    extra = modality_inputs(small, rng, 2)
    tol = 1e-3  # fp32 on both sides; sums over d=2048..18432 taken in another order on the card
    logits, routed = {}, {"cpu": [], "card": []}
    with torch.inference_mode():
        for name, api, model in (("cpu", cpu_api, cpu_model), ("card", gpu_api, gpu_model)):
            toks = torch.from_numpy(tokens).to(api.device)
            inputs = {k: torch.from_numpy(v).to(api.device) for k, v in extra.items()}
            with routing_recorded(routed[name]):
                full, _ = model(toks, mode="train", **inputs)  # the path's kernels on the card
                _, cache = api.prefill(model, {"tokens": toks[:, :127], **inputs},
                                       api.init_cache(2, 128), last_only=True)
                step, _ = api.decode(model, toks[:, 127:], cache)
            logits[name] = (full.cpu(), step.cpu())
    for i, what in enumerate(("full-sequence", "decode-step")):
        err = (logits["card"][i] - logits["cpu"][i]).abs().max().item()
        log(f"  {cfg.name} {cut} full-width fp32 {what} logits, card vs CPU: "
            f"max_abs_err={err:.3g} (tol {tol})")
        if not err <= tol:
            raise AssertionError(f"{what} logits on the card disagree with the CPU: {err}")
    if small.moe is not None:
        log_routing(routed)
    out = {}
    for name, api, model in (("cpu", cpu_api, cpu_model), ("card", gpu_api, gpu_model)):
        out[name] = ServeEngine(api, model, batch=2, s_max=140).generate(
            {"tokens": tokens, **extra}, max_new_tokens=8)
    log(f"  greedy tokens card {out['card'].tolist()} / CPU {out['cpu'].tolist()}")
    if not np.array_equal(out["cpu"], out["card"]):
        raise AssertionError("greedy tokens on the card differ from the CPU")
    log(f"  {cfg.name} reference: {time.perf_counter() - t0:.1f} s")


TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
# tokens of the fp32 train reference's one row (256 until the one-card run
# outgrew its time: the CPU side's steps take most of the reference phase)
TRAIN_REF_SEQ = 128
# whisper's and internvl2's depth in the reference phase (full depth until
# the one-card run outgrew its time; the serve and train phases keep it)
REF_LAYERS = 2
TRAIN_FAMILIES = (  # (family, substrings of kernel names), first match wins
    ("selective scan backward", ("selective_scan_bwd",)),
    ("selective scan forward", ("selective_scan_fwd",)),
    ("wkv6 backward", ("wkv6_bwd",)),
    ("wkv6 forward", ("wkv6_",)),
    ("flash attention backward", ("flash_bwd", "group_sum")),
    ("flash attention forward", ("flash_fwd",)),
    ("rmsnorm", ("rmsnorm",)),
    ("matmul", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("reduction", ("reduce_kernel",)),
    ("elementwise and copies", ("elementwise", "copy", "CatArrayBatched", "fill")),
)


def check_train_reference(cfg, cut: str) -> None:
    """One AdamW step of ``cfg`` (full width, cut in depth or experts by the
    caller) in fp32 on the card (forward and backward kernels) against the
    same step on the CPU (plain versions), on one synthetic batch of 1 x
    TRAIN_REF_SEQ tokens (with whisper's frames or the VLM's patches): the
    loss, every parameter's gradient, and the update where |g| > 1e-3 max|g|
    of its leaf (AdamW's first step is close to lr sign(g), so an entry near
    zero that rounds differently flips a whole update); for the MoE models
    the routing decisions that differ.  The weights are drawn on the card and
    copied to the CPU.  The CPU steps first (its parameters, gradients and
    moments: 16 bytes a parameter on the host), keeps its gradients and
    update and a copy of the weights; then the card steps (16 bytes a
    parameter there) and is compared leaf by leaf.  Raises if either side
    lacks the memory."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6_bwd
    from repro_torch.models import get_api
    from repro_torch.models.registry import model_class
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig, adamw_init, adamw_update
    from repro_torch.train.trainstep import _accum_grads, batch_to_torch

    t0 = time.perf_counter()
    counters = {"flash_attention_bwd": flash_attention_bwd, "rmsnorm_bwd": rmsnorm_bwd,
                "wkv6_bwd": wkv6_bwd}
    small = cfg.replace(param_dtype="float32", compute_dtype="float32")
    cls = model_class(small)
    n = sum(p.numel() for p in cls(small, torch.device("meta")).parameters())
    need, card_free = 16 * n, torch.cuda.mem_get_info()[0]
    free = host_available_bytes(1.25 * need)
    log(f"  {cfg.name} {cut} fp32 train step: {n / 1e9:.3f} B parameters, {need / 1e9:.2f} GB "
        f"of parameters, gradients and AdamW moments a side; host memory available "
        f"{free / 1e9:.1f} GB, card {card_free / 1e9:.1f} GB")
    if free < 1.25 * need or card_free < 1.1 * need:
        raise RuntimeError(f"the step needs {need / 1e9:.2f} GB a side and more for its "
                           f"activations and the update's temporaries; the host has "
                           f"{free / 1e9:.1f} GB available, the card {card_free / 1e9:.1f} GB")
    gpu_model = get_api(small, device=DEVICE).init(seed=1)
    cpu_model = cls(small, torch.device("cpu"))
    cpu_model.load_state_dict(gpu_model.state_dict())
    batch = SyntheticData(DataConfig(vocab_size=small.vocab_size, batch=1, seq=TRAIN_REF_SEQ),
                          model_cfg=small).batch_at(0)
    opt = OptConfig(**TRAIN_OPT)
    routed = {"cpu": [], "card": []}

    def step(name, model, device):
        with routing_recorded(routed[name]):
            loss, grads = _accum_grads(model, batch_to_torch(batch, device), 1)
        state = adamw_init(model)
        adamw_update(model, grads, state, opt)
        return loss.item(), grads

    t1 = time.perf_counter()
    loss_cpu, g_cpu = step("cpu", cpu_model, "cpu")
    card = dict(gpu_model.named_parameters())
    before = {m: p.detach().to("cpu", copy=True) for m, p in card.items()}
    d_cpu = {m: p.detach() - before[m] for m, p in cpu_model.named_parameters()}
    del cpu_model
    t2 = time.perf_counter()
    launched = {k: f.launches for k, f in counters.items()}
    loss_card, g_card = step("card", gpu_model, DEVICE)
    sync()
    launched = {k: f.launches - launched[k] for k, f in counters.items()}
    t3 = time.perf_counter()

    # compared on the card, a leaf at a time: the CPU's sides are copied over
    tol = 1e-3  # fp32 on both sides; sums over d_ff, the vocab and S taken in another order
    loss_err, g_err, d_err, zero = abs(loss_card - loss_cpu), 0.0, 0.0, []
    for m, p in card.items():
        g, gc = g_cpu[m].to(DEVICE), g_card[m]
        scale = g.abs().max().item()
        if scale == 0.0:  # a leaf this batch does not reach: zero on both sides
            zero.append(m)
            g_err = max(g_err, float("inf") if gc.any() else 0.0)
            continue
        g_err = max(g_err, (gc - g).abs().max().item() / scale)
        big = g.abs() > 1e-3 * scale
        d_diff = (p.detach() - before[m].to(DEVICE)) - d_cpu[m].to(DEVICE)
        d_err = max(d_err, d_diff[big].abs().max().item())
    del g_card, before, d_cpu, g_cpu, g, gc
    lr0 = float(TRAIN_OPT["lr"]) / TRAIN_OPT["warmup_steps"]
    extra = {"audio": f" and {small.encoder_seq} frames", "vlm": f" after {small.vision_tokens} "
             "patches"}.get(small.family, "")
    log(f"  {cfg.name} {cut} full-width fp32 train step (B=1, S={TRAIN_REF_SEQ}{extra}), card "
        f"vs CPU: loss {loss_card:.6f} / {loss_cpu:.6f} (err {loss_err:.3g}, tol {tol}); "
        f"gradients max_abs_err / max|g| over {len(card)} leaves {g_err:.3g} (tol {tol})"
        f"{f', {len(zero)} leaves with zero gradient on both sides' if zero else ''}; update "
        f"max_abs_err where |g| > 1e-3 max|g| {d_err:.3g} (tol {1e-2 * lr0:.3g}, 1e-2 x lr)")
    log(f"  backward kernel launches in the card's step: {launched}")
    if small.moe is not None:
        log_routing(routed)
    if not (loss_err <= tol * abs(loss_cpu) and g_err <= tol and d_err <= 1e-2 * lr0):
        raise AssertionError("the train step on the card disagrees with the CPU")
    if not any(launched.values()):
        raise AssertionError("the train step on the card launched no backward kernel")
    log(f"  {cfg.name} train reference: {time.perf_counter() - t0:.1f} s (set-up "
        f"{t1 - t0:.1f}, the CPU's step {t2 - t1:.1f}, the card's {t3 - t2:.1f}, the "
        f"comparison {time.perf_counter() - t3:.1f})")


# ---------------------------------------------------------------------------
# serving, full width
# ---------------------------------------------------------------------------

def expected_launches(cfg, path: str = "serve", new: int = MAX_NEW) -> dict:
    """Kernel launches the path implies: for "serve", one generate call of
    ``new`` tokens (one prefill, then one decode step per further token);
    for "train", one train step (one forward and one backward pass)."""
    L = cfg.num_layers
    mamba = L - attention_layers(cfg) if cfg.family == "hybrid" else 0  # one scan a Mamba layer
    if path == "train":  # each forward kernel's backward runs once per forward launch
        if cfg.family == "ssm":  # rwkv: one WKV6 per layer each way; LayerNorm is plain torch
            flash, norm, wkv = 0, 0, L
        elif cfg.family == "audio":  # the encoder, each decoder layer's self- and
            flash, norm, wkv = cfg.encoder_layers + 2 * L, 0, 0  # cross-attention; LayerNorm
        elif cfg.attn_kind == "mla":  # attention plain torch; q_norm and kv_norm beside ln1, ln2
            flash, norm, wkv = 0, 4 * L + 1, 0
        elif cfg.family == "hybrid":  # flash in the attention layers, the scan in the others
            flash, norm, wkv = attention_layers(cfg), 2 * L + 1, 0
        else:  # dense, MoE with GQA, the VLM's LM
            flash, norm, wkv = L, 2 * L + 1, 0
        return {"flash_attention": flash, "flash_attention_bwd": flash, "rmsnorm": norm,
                "rmsnorm_bwd": norm, "wkv6": wkv, "wkv6_step": 0, "wkv6_bwd": wkv,
                "selective_scan": mamba, "selective_scan_bwd": mamba}
    passes = 1 + (new - 1)
    if cfg.family == "audio":  # flash: the encoder, then each decoder layer's self- and
        # cross-attention in prefill, and its cross-attention at every decode step
        return {"flash_attention": cfg.encoder_layers + 2 * L + L * (passes - 1),
                "rmsnorm": 0, "wkv6": 0, "wkv6_step": 0,  # LayerNorm is plain torch
                "selective_scan": 0}
    if cfg.family == "ssm":  # rwkv: one WKV6 per layer per pass; LayerNorm is plain torch
        return {"flash_attention": 0, "rmsnorm": 0, "wkv6": L,  # chunked: prefill
                "wkv6_step": L * (passes - 1), "selective_scan": 0}  # one token a step: decode
    if cfg.attn_kind == "mla":  # attention plain torch; q_norm and kv_norm beside ln1, ln2
        return {"flash_attention": 0, "rmsnorm": (4 * L + 1) * passes, "wkv6": 0,
                "wkv6_step": 0, "selective_scan": 0}
    if cfg.family == "hybrid":  # flash in the attention layers' prefill; the scan kernel in
        # every Mamba layer, prefill and decode steps alike
        return {"flash_attention": attention_layers(cfg), "rmsnorm": (2 * L + 1) * passes,
                "wkv6": 0, "wkv6_step": 0, "selective_scan": mamba * passes}
    return {"flash_attention": L,  # prefill only (the VLM's too): decode is plain torch
            "rmsnorm": (2 * L + 1) * passes, "wkv6": 0, "wkv6_step": 0, "selective_scan": 0}


def analytic_params(cfg) -> int:
    """Parameters of whisper's and the VLM's trees counted from the config:
    attention (q, k, v, o and the qkv bias), MLP, norms, embedding tables
    (whisper's 32768-row position table too) and the VLM's projector."""
    d, hd, hq, hkv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    attn = d * hd * (2 * hq + 2 * hkv) + (hd * (hq + 2 * hkv) if cfg.qkv_bias else 0)
    mlp = (3 if cfg.mlp_kind in ("swiglu", "geglu") else 2) * d * cfg.d_ff
    norm = 2 * d if cfg.norm_kind == "layernorm" else d
    if cfg.family == "audio":
        cross = 4 * d * hq * hd
        return ((cfg.vocab_size + cfg.max_target_positions) * d
                + cfg.encoder_layers * (attn + mlp + 2 * norm) + norm
                + cfg.num_layers * (attn + cross + mlp + 3 * norm) + norm)
    return (cfg.vision_dim * d + d * d + cfg.vocab_size * d
            + cfg.num_layers * (attn + mlp + 2 * norm) + norm)


def attention_layers(cfg) -> int:
    """Layers of a hybrid pattern that hold a KV cache (jamba: 1 in 8)."""
    return sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "attn"
               for i in range(cfg.num_layers))


def serve(cfg) -> dict:
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.wkv6 import wkv6
    from repro_torch.models import get_api, modality_inputs
    from repro_torch.serve.engine import ServeEngine

    api = get_api(cfg, device=DEVICE)
    t0 = time.perf_counter()
    model = api.init(seed=0)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    cut = (f" (cut to {cfg.num_layers} layers: {sum(not b.moe for b in model.layers)} dense, "
           f"{sum(b.moe for b in model.layers)} MoE of {cfg.moe.num_experts} experts, "
           f"top-{cfg.moe.top_k})" if cfg.moe is not None else "")
    if cfg.family == "hybrid":
        full = configs.get_config(cfg.name)
        cut += (f" [{cfg.num_layers - attention_layers(cfg)} Mamba and "
                f"{attention_layers(cfg)} attention layers; cuts: depth {full.num_layers} -> "
                f"{cfg.num_layers}, experts {full.moe.num_experts} -> {cfg.moe.num_experts}]")
    if cfg.family == "audio":
        cut = f" (decoder) + {cfg.encoder_layers} encoder layers, full depth"
    if cfg.family == "vlm":
        cut = f" (the LM, full depth) + the projector {cfg.vision_dim} -> {cfg.d_model}"
    log(f"  {cfg.name}: {cfg.num_layers} layers{cut}, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params in {str(cfg.pdtype)[6:]}, initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    if cfg.family in ("audio", "vlm") and n_params != analytic_params(cfg):
        raise AssertionError(f"{n_params} parameters != {analytic_params(cfg)} from the config")
    if cfg.name in (FSDP_ARCH, TP_ARCH):  # param_counts() leaves out norms and biases
        bias = cfg.num_layers * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
            if cfg.qkv_bias else 0
        counted = cfg.param_counts()[0] + (2 * cfg.num_layers + 1) * cfg.d_model + bias
        log(f"  parameters {n_params:,} = param_counts() {cfg.param_counts()[0]:,} + "
            f"{2 * cfg.num_layers + 1} norm scales of {cfg.d_model}"
            + (f" + {bias:,} q/k/v biases" if bias else "")
            + f": {'ok' if n_params == counted else 'FAIL'}")
        if n_params != counted:
            raise AssertionError(f"{n_params} parameters != {counted} from param_counts()")
    prompt = SERVE_PROMPT.get(cfg.name, PROMPT_LEN)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, prompt)).astype(np.int64)
    extra = modality_inputs(cfg, rng, SERVE_BATCH)
    batch = {"tokens": torch.from_numpy(tokens).to(DEVICE),  # as generate moves them
             **{k: torch.from_numpy(v).to(DEVICE) for k, v in extra.items()}}
    eng = ServeEngine(api, model, batch=SERVE_BATCH, s_max=prompt + MAX_NEW)
    eng.generate({"tokens": tokens[:, :64], **extra},  # warm-up (Triton JIT, cuBLAS)
                 max_new_tokens=2)

    flash_attention.launches = rmsnorm.launches = selective_scan.launches = 0
    wkv6.launches = wkv6.chunk_launches = wkv6.step_launches = 0
    t0 = time.perf_counter()
    out = eng.generate({"tokens": tokens, **extra}, max_new_tokens=MAX_NEW)
    total_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "rmsnorm": rmsnorm.launches,
                "wkv6": wkv6.chunk_launches, "wkv6_step": wkv6.step_launches,
                "selective_scan": selective_scan.launches}
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
        logits, _ = api.prefill(model, batch, api.init_cache(SERVE_BATCH, prompt),
                                last_only=True)
    if logits.shape != (SERVE_BATCH, 1, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits not finite or of shape {tuple(logits.shape)}")
    if not np.array_equal(logits[:, -1].argmax(-1).cpu().numpy(), out[:, 0]):
        raise AssertionError("a second prefill picks other first tokens")
    if cfg.moe is not None:  # the combine adds in one fixed order: no atomics
        again = eng.generate({"tokens": tokens, **extra}, max_new_tokens=MAX_NEW)
        if not np.array_equal(again, out):
            raise AssertionError("two MoE serve runs gave different tokens")
        log(f"  a second run gives the same {out.size} tokens")
    prof = eng.comm_profile()
    kv, fixed = prof["kv_bytes_per_token"], prof["fixed_state_bytes"]
    if cfg.family == "ssm":  # a recurrent state: x_prev twice in cdtype, the fp32 wkv state
        K = cfg.rwkv.head_dim
        expect_kv = 0.0
        expect_fixed = cfg.num_layers * (2 * cfg.d_model * cfg.cdtype.itemsize
                                         + (cfg.d_model // K) * K * K * 4)
    elif cfg.family == "hybrid":  # KV in the attention layers; conv_buf and fp32 scan state
        mc = cfg.mamba
        d_in = mc.expand * cfg.d_model
        n_attn = attention_layers(cfg)
        expect_kv = n_attn * 2 * cfg.num_kv_heads * cfg.head_dim * cfg.cdtype.itemsize
        expect_fixed = (cfg.num_layers - n_attn) * ((mc.d_conv - 1) * d_in * cfg.cdtype.itemsize
                                                    + d_in * mc.d_state * 4)
    elif cfg.family == "audio":  # decoder KV; the encoder output is fixed
        expect_kv = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * cfg.cdtype.itemsize
        expect_fixed = float(cfg.encoder_seq * cfg.d_model * cfg.cdtype.itemsize)
    elif cfg.family == "vlm":  # the vision prefix's slots are fixed
        expect_kv = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * cfg.cdtype.itemsize
        expect_fixed = float(cfg.vision_tokens * expect_kv)
    elif cfg.attn_kind == "mla":  # the compressed cache: c_kv and k_rope
        expect_kv = cfg.num_layers * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) \
            * cfg.cdtype.itemsize
        expect_fixed = 0.0
    else:
        expect_kv = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * cfg.cdtype.itemsize
        expect_fixed = 0.0
    if (kv, fixed) != (expect_kv, expect_fixed):
        raise AssertionError(f"comm_profile kv_bytes_per_token {kv}, fixed_state_bytes {fixed} "
                             f"!= {expect_kv}, {expect_fixed}")
    log(f"  kv_bytes_per_token {kv:.0f}, fixed_state_bytes {fixed:.0f}")
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if cfg.family in ("audio", "vlm"):  # the encoder, the position table, the projector
        unread = ("enc_layers.", "enc_ln.", "pos", "proj.")
        read = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                   if not n.startswith(unread))
        log(f"  weights {weight_bytes / 1e9:.3f} GB; a decode step reads the decoder's "
            f"{read / 1e9:.3f} GB at least once: {read / HBM_BYTES_PER_S * 1e3:.3f} ms at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    else:
        log(f"  a decode step reads every weight at least once (every expert's too: all E "
            f"slots are computed, as in JAX): {weight_bytes / 1e9:.2f} GB, "
            f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    if cfg.family == "ssm":
        wkv_y_rounding_shift(api, model, batch["tokens"])
    if cfg.attn_kind == "mla":
        mla_attention_ms(cfg)
    profile_phases(api, model, batch, decode_ms)
    return launches


def mla_attention_ms(cfg) -> None:
    """MLA's expanded attention at the prefill shape, one layer: the port's
    plain torch (``_sdpa_chunked``: fp32 scores, causal mask, softmax, P·V)
    against scaled_dot_product_attention on the same inputs and the bound.
    The flash kernel takes only v.shape == k.shape (Dq 192, Dv 128 here)."""
    from repro_torch.models.attention import _sdpa_chunked

    m, H = cfg.mla, cfg.num_heads
    dq, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    q, k = (randn(gen, (SERVE_BATCH, PROMPT_LEN, H, dq), torch.bfloat16) for _ in range(2))
    v = randn(gen, (SERVE_BATCH, PROMPT_LEN, H, dv), torch.bfloat16)
    scale = dq ** -0.5
    ms = time_ms(lambda: _sdpa_chunked(q, k, v, scale), reps=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

    try:
        err = (sdpa().transpose(1, 2).float() - _sdpa_chunked(q, k, v, scale).float()).abs().max()
        library = f"{time_ms(sdpa, reps=10):.4f} ms (max_abs_diff {err.item():.3g})"
    except RuntimeError as e:  # no backend takes the shape
        library = f"refused ({str(e)[:120]})"
    pairs = SERVE_BATCH * H * PROMPT_LEN * (PROMPT_LEN + 1) // 2
    flops = 2.0 * pairs * (dq + dv)  # q.k and p.v
    nbytes = (q.numel() + k.numel() + 2 * v.numel()) * 2  # q, k, v read; the output (v's shape) written
    bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
    log(f"  MLA attention at the prefill shape, one layer (B={SERVE_BATCH}, H={H}, S={PROMPT_LEN}, "
        f"Dq={dq}, Dv={dv}, bf16, causal): plain torch (the port's path) {ms:.4f} ms, library "
        f"(scaled_dot_product_attention) {library}, bound {bound_ms:.4f} ms by {bound_by} "
        f"({flops / 1e9:.2f} GFLOP)")


def bf16_absorbs(p: torch.Tensor, bound: float) -> bool:
    """True if no entry of the bf16 tensor ``p`` can move by an update of at
    most ``bound``: it is below half the bf16 spacing just under every
    |entry| (2^(floor(log2 |p|) - 8), the finer side of a power of two)."""
    a = p.detach().float().abs()
    return bool((bound < 0.5 * torch.exp2(torch.floor(torch.log2(a)) - 8)).all())


def train(cfg, cut: str = "") -> dict:
    """TRAIN_STEPS AdamW steps of the model in bf16 through train_step, with
    finite losses and a loss on the last step's batch that falls by that
    step; then
    two gradient passes from one state on one batch, compared bit for bit;
    returns the kernels' launches in the counted steps and the median step
    ms."""
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
    seq = TRAIN_TEXT.get(cfg.name, TRAIN_SEQ)
    inputs = {"audio": f" and {cfg.encoder_seq} frames",
              "vlm": f" after {cfg.vision_tokens} patches"}.get(cfg.family, "")
    log(f"  {cfg.name}{' ' + cut if cut else ''}: {cfg.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, "
        f"{n_params / 1e9:.3f} B params in {str(cfg.pdtype)[6:]}, fp32 AdamW moments, "
        f"initialised in {time.perf_counter() - t0:.1f} s; params and moments take "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; batch {TRAIN_BATCH} x {seq} "
        f"tokens{inputs}")
    data = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq=seq,
                                    mode="affine"), model_cfg=cfg)
    opt, hp = OptConfig(**TRAIN_OPT), TrainHparams(grad_accum=1)
    batches = [batch_to_torch(data.batch_at(i), DEVICE) for i in range(TRAIN_STEPS + 2)]

    tp_zero_counts()
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
    launches = tp_launch_counts()
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    expect = expected_launches(cfg, "train")
    med = statistics.median(step_ms[1:])
    tok_s = TRAIN_BATCH * seq / med * 1e3  # the text tokens the loss reads
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  losses {[round(x, 4) for x in losses]}")
    log(f"  step {med:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}; step 0 {step_ms[0]:.1f} ms), "
        f"{tok_s:.0f} tok/s, peak device memory {peak:.2f} GiB")
    log(f"  launches per step: {per_step}")
    # the affine data's batches share almost no token (each row walks a
    # cycle of the rule from a new start), so 6 steps lower no other batch's
    # loss; the descent shows on the batch a step was computed from
    with torch.no_grad():
        again = api.loss(model, batches[TRAIN_STEPS - 1]).item()
    log(f"  loss on the last step's batch: {losses[-1]:.4f} in the step, {again:.4f} after it")
    if not (all(np.isfinite(losses)) and again < losses[-1]):
        raise AssertionError(f"the losses are not finite or do not fall: {losses}, then {again}")
    if per_step != expect:
        raise AssertionError(f"kernel launches per step {per_step} != {expect} implied by the path")
    check_repeatable_grads(model, batches[TRAIN_STEPS], hp)
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
    return launches, med


def check_repeatable_grads(model, batch, hp) -> None:
    """Two gradient passes from the model's current state on one batch,
    compared bit for bit (outside the counted run).  Where they differ, a
    third pass under ``torch.use_deterministic_algorithms(warn_only=True)``
    lists the ops PyTorch names as nondeterministic.  A difference is a
    finding, printed, not a failure."""
    from repro_torch.train.trainstep import _accum_grads

    first = _accum_grads(model, batch, hp.grad_accum)[1]
    second = _accum_grads(model, batch, hp.grad_accum)[1]
    differ = [n for n, g in first.items() if not torch.equal(g, second[n])]
    if not differ:
        log(f"  two gradient passes from one state on one batch: all {len(first)} gradients "
            f"bit-identical")
        return
    worst = max((first[n].float() - second[n].float()).abs().max().item()
                / max(first[n].float().abs().max().item(), 1e-30) for n in differ)
    del first, second
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            _accum_grads(model, batch, hp.grad_accum)
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" (Triggered internally")[0][:160] for w in caught
                      if "determinis" in str(w.message)})
    log(f"  two gradient passes from one state on one batch: {len(differ)} gradients differ "
        f"(largest difference {worst:.3g} of the leaf's max|g|): {differ[:8]}; ops PyTorch "
        f"flags as nondeterministic in a third pass: {flagged or 'none'}")


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
    names = sorted(n for n in by_name if any(x in n for x in ("rmsnorm", "column_sum", "wkv6")))
    log("  rmsnorm or wkv6 kernels (and the RMSNorm backward's column sum): " + ", ".join(
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


def profile_phases(api, model, batch, decode_ms: float, steps: int = 8) -> None:
    """torch.profiler over one prefill and ``steps`` decode steps (outside the
    counted run): device-busy time, kernels launched, and the top kernels by
    device time.  The idle share of a decode step is taken against the
    unprofiled decode time of the counted run.  For a model with Mamba
    layers, CUDA events around each Mamba mixer in the profiled prefill give
    the mixers' share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.ssm import Mamba

    def kernels_of(prof):
        return [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    spans, hooks = [], []

    def opened(mod, args):
        spans.append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
        spans[-1][0].record()

    def closed(mod, args, out):
        spans[-1][1].record()

    mixers = [m for m in model.modules() if isinstance(m, Mamba)]
    with torch.inference_mode():
        cache = api.init_cache(batch["tokens"].shape[0], batch["tokens"].shape[1] + steps)
        whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for m in mixers:
            hooks += [m.register_forward_pre_hook(opened), m.register_forward_hook(closed)]
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pre:
                whole[0].record()
                logits, cache = api.prefill(model, batch, cache, last_only=True)
                whole[1].record()
                tok = logits[:, -1].argmax(dim=-1)
                sync()
        finally:
            for h in hooks:
                h.remove()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as dec:
            for _ in range(steps):
                logits, cache = api.decode(model, tok[:, None], cache)
                tok = logits[:, -1].argmax(dim=-1)
            sync()
    busy_of = {}
    for what, prof, n in (("prefill", pre, 1), ("decode step", dec, steps)):
        kern = kernels_of(prof)
        if not kern:
            log(f"  profile {what}: no device events (not measured)")
            continue
        # a collective kernel spins on the card until the other ranks reach it
        # (and runs beside the compute stream), so it is not busy time
        coll = sum(e.time_range.elapsed_us() for e in kern if "nccl" in e.name.lower()) / 1e3 / n
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / n - coll
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        extra = (f", idle share {1 - busy / decode_ms:.3f} of the unprofiled {decode_ms:.3f} ms"
                 if what == "decode step" else "")
        if coll:
            extra += (f" (collective kernels, {coll:.3f} ms from launch to end, left out of "
                      "the busy time: they wait for the other ranks)")
        log(f"  profile {what}: {len(kern) / n:.0f} kernels, device busy {busy:.3f} ms{extra}")
        for name, ms in top:
            log(f"    {ms:8.3f} ms  {name[:100]}")
        busy_of[what] = busy
    if mixers:
        mixer_ms = sum(a.elapsed_time(b) for a, b in spans)
        prefill_ms = whole[0].elapsed_time(whole[1])
        busy = busy_of.get("prefill")
        log(f"  the {len(spans)} Mamba mixers in the profiled prefill (CUDA events around each): "
            f"{mixer_ms:.3f} ms of the prefill's {prefill_ms:.3f} ms from its first launch to "
            f"its last, a share of {mixer_ms / prefill_ms:.3f}"
            + (f"; {mixer_ms / busy:.3f} of its device busy" if busy else ""))


# ---------------------------------------------------------------------------
# the train launcher: control plane, checkpoints and resume
# ---------------------------------------------------------------------------

def launcher(rwkv) -> dict:
    """The train launcher's control-plane line for both models at 2 and 4
    pods, then its data-plane loop (``launch.train.train_loop``) on
    rwkv6-1.6b at full width, cut to LAUNCH_LAYERS layers so that two
    checkpoints fit a smoke run: run A takes steps 0-3 with a background
    save after step 1 and the final save after step 3; run B restores a
    state of another seed from step 1 and takes steps 2-3.  B's losses and
    final state must equal A's bit for bit.  Returns the WKV6 launches of
    each run."""
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
    from repro_torch.launch.train import control_plane, control_plane_line, train_loop
    from repro_torch.models.transformer import DecoderLM

    for arch in ARCHS:
        for pods in (2, 4):
            cp = control_plane(arch, pods)
            log("  " + control_plane_line(arch, cp))
            # a ring of n >= 2 pods has n hops of `links` per spine group
            want = cp["spec"].num_ocs_groups * pods * cp["plan"].ocs_links_per_ring_hop
            realized = cp["config"].realized_bidirectional().sum() // 2
            if cp["demand_links"] != want or realized != want or abs(cp["ltrr"] - 1) > 1e-9:
                raise AssertionError(f"control plane of {arch} on {pods} pods: demand "
                                     f"{cp['demand_links']}, realized {realized}, LTRR "
                                     f"{cp['ltrr']}; want {want} links at LTRR 1")

    cfg = rwkv.replace(num_layers=LAUNCH_LAYERS)
    n_params = sum(p.numel() for p in DecoderLM(cfg, torch.device("meta")).parameters())
    ckpt_bytes = 3 * 4 * n_params  # params (bf16 stored as f32), m and v in f32
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(ckpt).free
        log(f"  {cfg.name} cut to {cfg.num_layers} layers: {n_params / 1e9:.3f} B params, "
            f"{ckpt_bytes / 1e9:.2f} GB a checkpoint; {free / 1e9:.1f} GB free in {ckpt}")
        if free < 2 * ckpt_bytes:
            raise RuntimeError(f"two checkpoints ({2 * ckpt_bytes / 1e9:.2f} GB) do not fit "
                               f"in the {free / 1e9:.1f} GB free in {ckpt}")
        kw = dict(steps=LAUNCH_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_OPT["lr"],
                  log_every=1, device=DEVICE, ckpt_dir=ckpt, ckpt_every=2)
        runs, launches = {}, {}
        for run, seed in (("A", 0), ("B", 1)):
            if run == "B":  # B resumes from step 1, the latest once A's final is gone
                for ext in ("npz", "json"):
                    os.remove(os.path.join(ckpt, f"step_{LAUNCH_STEPS - 1}.{ext}"))
            torch.cuda.empty_cache()
            wkv6.launches = wkv6.chunk_launches = wkv6.step_launches = wkv6_bwd.launches = 0
            runs[run] = train_loop(cfg, seed=seed, **kw)
            sync()
            launches[f"launcher {cfg.name} run {run}"] = {
                "wkv6": wkv6.chunk_launches, "wkv6_step": wkv6.step_launches,
                "wkv6_bwd": wkv6_bwd.launches}
            if run == "A":
                on_disk = sum(os.path.getsize(os.path.join(ckpt, f"step_1.{ext}"))
                              for ext in ("npz", "json"))
        a, b = runs["A"], runs["B"]

        saved = [s["step"] for s in a["saves"]], [s["step"] for s in b["saves"]]
        if saved != ([1, LAUNCH_STEPS - 1], [LAUNCH_STEPS - 1]) or b["restore_s"] is None:
            raise AssertionError(f"saves {saved}, restore {b['restore_s']}: not the plan")
        steps_b = list(range(2, LAUNCH_STEPS))
        if [r["step"] for r in b["log"]] != steps_b:
            raise AssertionError(f"run B took steps {[r['step'] for r in b['log']]}")
        losses_a = [r["loss"] for r in a["log"]]
        losses_b = [r["loss"] for r in b["log"]]
        log(f"  run A losses {losses_a}; run B (restored from step 1) losses {losses_b}")
        if not all(np.isfinite(losses_a)) or losses_b != losses_a[2:]:
            raise AssertionError(f"run B's losses {losses_b} != run A's {losses_a[2:]}")
        sa, sb = a["state"], b["state"]
        pairs = [(f"params/{n}", p, dict(sb["model"].named_parameters())[n])
                 for n, p in sa["model"].named_parameters()]
        pairs += [(f"opt/{k}/{n}", t, sb["opt"][k][n]) for k in ("m", "v")
                  for n, t in sa["opt"][k].items()]
        pairs.append(("opt/step", sa["opt"]["step"], sb["opt"]["step"]))
        differ = [name for name, x, y in pairs if not torch.equal(x, y)]
        if differ:
            raise AssertionError(f"run B's state differs from run A's in {len(differ)} of "
                                 f"{len(pairs)} leaves: {differ[:5]}")
        log(f"  run B equals run A bit for bit: losses of steps {steps_b} and all {len(pairs)} "
            f"leaves (params, m, v, step)")

        writer = a["saves"][0]["writer"]
        with_write = [r["ms"] for r in a["log"] if r["writing"]]
        without = [r["ms"] for r in a["log"][1:] + b["log"] if not r["writing"]]
        log(f"  checkpoint of step 1: {on_disk} bytes on disk; snapshot (blocking) "
            f"{a['saves'][0]['blocked_s'] * 1e3:.1f} ms, background write {writer.seconds:.2f} s; "
            f"final save (blocking) {a['saves'][1]['blocked_s']:.2f} s (A), "
            f"{b['saves'][0]['blocked_s']:.2f} s (B); restore {b['restore_s']:.2f} s")
        log(f"  step ms with a background write in flight {[round(x, 1) for x in with_write]}, "
            f"without {[round(x, 1) for x in without]} (A's steps 1..{LAUNCH_STEPS - 1}, "
            f"B's {steps_b}; step 0 {a['log'][0]['ms']:.1f} ms)")
        log(f"  launches: {launches}")
        for run, n in launches.items():
            steps = LAUNCH_STEPS if run.endswith("A") else len(steps_b)
            want = {"wkv6": cfg.num_layers * steps, "wkv6_step": 0,
                    "wkv6_bwd": cfg.num_layers * steps}
            if n != want:
                raise AssertionError(f"{run}: launches {n} != {want} implied by the path")
        if not with_write:
            raise AssertionError("no step ran while the background write was in flight")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# the distributed train step over the data axes
# ---------------------------------------------------------------------------

DIST_MESH = ((1, 1, 1), ("pod", "data", "model"))  # a world of one; the quantizer still runs
# the card's and the CPU's fp32 gradients differ by up to ~3e-5 of a leaf's
# max|g| (the train references): 127 x that moves x = gs / scale * 127 of the
# int8 quantizer by ~4e-3, so an entry within 1e-2 of k + 1/2 may round
# either way on the two sides
DIST_TIE_MARGIN = 1e-2
DIST_RANK_TIMEOUT_S = 600


def jax_keyed(tensors, cfg):
    """(JAX key, tensor) of the port's named tensors (parameters or moments),
    a stacked group of layers along its leading axis, one leaf at a time."""
    from repro_torch.models.convert import jax_leaves

    for key, names in jax_leaves(tensors, cfg).items():
        yield key, (torch.stack([tensors[n].detach() for n in names])
                    if isinstance(names, tuple) else tensors[names].detach())


@contextlib.contextmanager
def quantizer_recorded(calls: list):
    """While open, appends (the entries within DIST_TIE_MARGIN of a rounding
    tie, on the CPU; the scale) of every call of the int8 quantizer."""
    from repro_torch.train import trainstep

    quantize = trainstep.quantize_int8

    def recorded(gs, scale):
        x = (gs / scale * 127.0).abs()
        calls.append((((x - torch.floor(x) - 0.5).abs() < DIST_TIE_MARGIN).cpu(), scale.item()))
        return quantize(gs, scale)

    trainstep.quantize_int8 = recorded
    try:
        yield calls
    finally:
        trainstep.quantize_int8 = quantize


def dist_step(cfg, hp, device: str, weights: dict, batch: dict, record=None):
    """One step of the distributed step of ``hp`` on a world of one
    (DIST_MESH: NCCL on the card, gloo on the CPU) from ``weights``, the
    quantizer's calls appended to ``record``: (metrics, state, step).  The
    process group is left when it returns."""
    from repro_torch.launch.mesh import make_mesh, shutdown
    from repro_torch.models import get_api
    from repro_torch.models.registry import model_class
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import batch_to_torch, make_train_step

    mesh = make_mesh(*DIST_MESH, device=device)
    try:
        step = make_train_step(get_api(cfg, device=device), cfg, OptConfig(**TRAIN_OPT), mesh,
                               hp, batch)
        model = model_class(cfg)(cfg, torch.device(device))
        model.load_state_dict(weights)
        state = {"model": model, "opt": step.init_opt()}
        with quantizer_recorded(record) if record is not None else contextlib.nullcontext():
            metrics = step(state, batch_to_torch(batch, device))
        metrics = {k: v.item() for k, v in metrics.items()}
    finally:
        shutdown()
    return metrics, state, step


def check_dist_reference(cfg, smi: str) -> None:
    """The distributed steps at world 1 (DIST_MESH), fp32, ``cfg`` at full
    width cut to 2 layers, one batch of 1 x TRAIN_REF_SEQ tokens:

    * the hierarchical step with ZeRO-1 and ``compress`` over NCCL on the
      card against the same step over gloo on the CPU: loss, grad norm,
      every parameter and moment; an entry that the CPU's quantizer met
      within DIST_TIE_MARGIN of a rounding tie may round the other way on
      the card, and only those are held to the looser bounds (the update
      lr (1 + wd |p|) instead of 1e-2 lr; one quantum of m);
    * the hierarchical step with ZeRO-1 on the card against the
      single-device ``train_step`` on the card."""
    from repro_torch.models import get_api
    from repro_torch.models.registry import model_class
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import TrainHparams, batch_to_torch, train_step

    t0 = time.perf_counter()
    small = cfg.replace(num_layers=2, param_dtype="float32", compute_dtype="float32")
    n = sum(p.numel() for p in model_class(small)(small, torch.device("meta")).parameters())
    need, card_free = 24 * n, torch.cuda.mem_get_info()[0]
    free = host_available_bytes(1.25 * need)
    log(f"  {cfg.name} 2-layer fp32, world 1: {n / 1e9:.3f} B parameters; {need / 1e9:.2f} GB "
        f"a side for the weights, a model, its gradients and moments; host memory available "
        f"{free / 1e9:.1f} GB, card {card_free / 1e9:.1f} GB")
    if free < 1.25 * need or card_free < 1.5 * need:
        raise RuntimeError(f"the world-1 references need {need / 1e9:.2f} GB a side")
    weights = {k: v.cpu() for k, v in get_api(small, device=DEVICE).init(seed=1)
               .state_dict().items()}
    batch = SyntheticData(DataConfig(vocab_size=small.vocab_size, batch=1, seq=TRAIN_REF_SEQ),
                          model_cfg=small).batch_at(0)
    opt = OptConfig(**TRAIN_OPT)
    b1 = opt.beta1

    compress = TrainHparams(hierarchical=True, zero1=True, compress=True)
    ties = []
    t1 = time.perf_counter()
    cpu, cpu_state, _ = dist_step(small, compress, "cpu", weights, batch, ties)
    t2 = time.perf_counter()
    card, card_state, step = dist_step(small, compress, DEVICE, weights, batch)
    t3 = time.perf_counter()
    lr = card["lr"]
    named = {"cpu": dict(cpu_state["model"].named_parameters()),
             "card": dict(card_state["model"].named_parameters())}
    if len(ties) != len(step.dims):
        raise AssertionError(f"the quantizer ran {len(ties)} times for {len(step.dims)} leaves")
    p_err = tie_err = m_err = 0.0
    near = moved = total = 0
    for (key, p_card), (_, p_cpu), (tie, scale) in zip(
            jax_keyed(named["card"], small), jax_keyed(named["cpu"], small), ties):
        tie = tie.to(DEVICE)
        d = (p_card - p_cpu.to(DEVICE)).abs()
        p_err = max(p_err, d[~tie].max().item() if (~tie).any() else 0.0)
        bound = lr * (1 + opt.weight_decay * p_card.abs()) + 1e-2 * lr
        if tie.any():
            tie_err = max(tie_err, (d[tie] / bound[tie]).max().item())
        near, moved, total = near + int(tie.sum()), moved + int((d[tie] > 1e-2 * lr).sum()), \
            total + d.numel()
        m_cpu = cpu_state["opt"]["m"][key].to(DEVICE)
        dm = (card_state["opt"]["m"][key] - m_cpu).abs()
        loose = (1e-3 * m_cpu.abs().max()).clamp(min=1e-30) + tie * ((1 - b1) * scale / 127
                                                                     * (1 + 1e-3))
        m_err = max(m_err, (dm / loose).max().item())
    del named, cpu_state, card_state
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_err = abs(card["grad_norm"] - cpu["grad_norm"]) / cpu["grad_norm"]
    log(f"  hierarchical step, ZeRO-1 and compress, NCCL on the card vs gloo on the CPU: loss "
        f"{card['loss']:.6f} / {cpu['loss']:.6f} (rel err {loss_err:.3g}, tol 1e-3), grad norm "
        f"{card['grad_norm']:.6g} / {cpu['grad_norm']:.6g} (rel err {norm_err:.3g}, tol 1e-3); "
        f"parameters max_abs_err {p_err:.3g} off the quantizer's ties (tol {1e-2 * lr:.3g}, "
        f"1e-2 x lr); {near} of {total} entries within {DIST_TIE_MARGIN} of a tie, {moved} of "
        f"them moved by more than 1e-2 x lr, worst at {tie_err:.3g} of lr (1 + wd |p|) + "
        f"1e-2 lr; moments m at {m_err:.3g} of their bound (1e-3 max|m|, plus one quantum "
        f"at a tie)")
    if not (loss_err <= 1e-3 and norm_err <= 1e-3 and p_err <= 1e-2 * lr and tie_err <= 1
            and m_err <= 1):
        raise AssertionError("the compressed hierarchical step on the card disagrees with the CPU")

    t4 = time.perf_counter()
    hier, hier_state, _ = dist_step(small, TrainHparams(hierarchical=True, zero1=True), DEVICE,
                                    weights, batch)
    model = model_class(small)(small, torch.device(DEVICE))
    model.load_state_dict(weights)
    opt_state = adamw_init(model)
    single = {k: v.item() for k, v in train_step(model, opt_state, batch_to_torch(batch, DEVICE),
                                                 opt).items()}
    sync()
    p_err = m_err = 0.0
    for (key, p_h), (_, p_s), (_, m_s) in zip(
            jax_keyed(dict(hier_state["model"].named_parameters()), small),
            jax_keyed(dict(model.named_parameters()), small), jax_keyed(opt_state["m"], small)):
        p_err = max(p_err, (p_h - p_s).abs().max().item())
        m_h = hier_state["opt"]["m"][key]
        m_err = max(m_err, ((m_h - m_s).abs().max() / m_s.abs().max().clamp(min=1e-30)).item())
    del hier_state, model, opt_state
    loss_err = abs(hier["loss"] - single["loss"]) / abs(single["loss"])
    norm_err = abs(hier["grad_norm"] - single["grad_norm"]) / single["grad_norm"]
    log(f"  hierarchical step with ZeRO-1 (NCCL, world 1) vs the single-device train_step, both "
        f"on the card: loss {hier['loss']:.6f} / {single['loss']:.6f} (rel err {loss_err:.3g}, "
        f"tol 1e-6), grad norm rel err {norm_err:.3g} (tol 1e-5), parameters max_abs_err "
        f"{p_err:.3g} (tol {1e-2 * lr:.3g}, 1e-2 x lr), moments m max_abs_err / max|m| "
        f"{m_err:.3g} (tol 1e-5)")
    if not (loss_err <= 1e-6 and norm_err <= 1e-5 and p_err <= 1e-2 * lr and m_err <= 1e-5):
        raise AssertionError("the hierarchical step disagrees with the single-device step")
    log(f"  world-1 references: {time.perf_counter() - t0:.1f} s (set-up {t1 - t0:.1f}, the "
        f"CPU's compressed step {t2 - t1:.1f}, the card's {t3 - t2:.1f}, the comparison "
        f"{t4 - t3:.1f}, hierarchical vs single {time.perf_counter() - t4:.1f}); {smi}")


def dist_train(cfg, smi: str, single_ms) -> dict:
    """``cfg`` at full width in bf16 trained TRAIN_STEPS steps through the
    hierarchical step with ZeRO-1 and ``compress`` over NCCL at world 1
    (DIST_MESH), batch TRAIN_BATCH x TRAIN_SEQ of the affine data: finite
    losses and a loss on the last step's batch that falls by that step; step
    ms beside the single-device step's (``single_ms``, the train phase's in
    this call), peak memory, collective calls and bytes per mesh axis per
    step (held against the bytes the leaves imply), the kernels' launches
    per step against the path's.  Returns the launches."""
    from repro_torch.launch.mesh import make_mesh, shutdown
    from repro_torch.models import get_api
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import TrainHparams, batch_to_torch, make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(*DIST_MESH, device=DEVICE)
    try:
        api = get_api(cfg, device=DEVICE)
        data = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH,
                                        seq=TRAIN_SEQ, mode="affine"), model_cfg=cfg)
        hp = TrainHparams(hierarchical=True, zero1=True, compress=True)
        step = make_train_step(api, cfg, OptConfig(**TRAIN_OPT), mesh, hp, data.batch_at(0))
        t0 = time.perf_counter()
        state = step.init_state(seed=0)
        sync()
        n_params = sum(p.numel() for p in state["model"].parameters())
        log(f"  {cfg.name}: {n_params / 1e9:.3f} B params in {str(cfg.pdtype)[6:]}, "
            f"{len(step.leaves)} JAX leaves, mesh {dict(zip(*reversed(DIST_MESH)))} over NCCL, "
            f"initialised in {time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x {TRAIN_SEQ}")
        batches = [batch_to_torch(data.batch_at(i), DEVICE) for i in range(TRAIN_STEPS)]
        tp_zero_counts()
        losses, ms, comms = [], [], []
        for i in range(TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            metrics = step(state, batches[i])
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            comms.append(step.comm)
        launches = tp_launch_counts()
        with torch.no_grad():
            again = api.loss(state["model"], batches[-1]).item()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        shutdown()
    med = statistics.median(ms[1:])
    leaves = len(step.leaves)
    # every leaf is cut at data 1: a reduce-scatter of fp32 gradients and an
    # all-gather of bf16 parameters over data, the squares' one all-reduce;
    # over pod the max and the int32 values (4 bytes an entry, as fp32)
    want = {"pod+data": {"calls": 1, "bytes": 4},
            "data": {"calls": 2 * leaves + 1,
                     "bytes": (4 + cfg.pdtype.itemsize) * n_params + 4 * leaves},
            "pod": {"calls": 2 * leaves, "bytes": 4 * n_params + 4 * leaves}}
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    log(f"  losses {[round(x, 4) for x in losses]}; loss on the last step's batch after it "
        f"{again:.4f}")
    log(f"  step {med:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}; step 0 {ms[0]:.1f} ms) "
        f"beside the single-device train_step's "
        f"{'not measured in this run' if single_ms is None else f'{single_ms:.1f} ms'} "
        f"(train phase); {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.0f} tok/s, peak device memory "
        f"{peak:.2f} GiB; {smi}")
    log(f"  collectives per step (calls, bytes of the tensors handed in): {comms[-1]}")
    log(f"  launches per step: {per_step}")
    if not (all(np.isfinite(losses)) and again < losses[-1]):
        raise AssertionError(f"the losses are not finite or do not fall: {losses}, then {again}")
    if any(c != want for c in comms):
        raise AssertionError(f"collectives {comms[-1]} != {want} implied by the leaves")
    if per_step != expected_launches(cfg, "train"):
        raise AssertionError(f"kernel launches per step {per_step} != "
                             f"{expected_launches(cfg, 'train')} implied by the path")
    return launches


def dist_ranks(count: int) -> None:
    """The multi-rank check on a host of several cards: world 4 (mesh
    (pod 2, data 2, model 1)) or 2 (pod 2), one rank a card, each this
    script with ``--dist-rank`` (:func:`dist_rank`); rank 0's log is
    printed.  Every rank is killed if one fails or the time runs out."""
    if count < 2:
        log("  multi-rank check: did not run, the host shows 1 card and NCCL takes one card a "
            "rank (two ranks on one card: tools/dist_one_card_probe.py)")
        return
    world = 4 if count >= 4 else 2
    workdir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    torch.cuda.empty_cache()
    procs = []
    try:
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log"), "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
                     "--dist-world", str(world), "--dist-dir", workdir],
                    stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DIST_RANK_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        with open(os.path.join(workdir, "rank0.log")) as f:
            for line in f.read().splitlines():
                log(f"    {line}")
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        # the first rank that failed by itself (the others are killed after it)
        for r, _ in sorted(failed, key=lambda f: f[1] < 0)[:1]:
            if r:
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    log(f"    rank {r}: {f.read()[-3000:]}")
        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        raise AssertionError(f"the multi-rank check failed: ranks and exit codes {failed}")


def dist_rank(rank: int, world: int, workdir: str) -> int:
    """One rank of :func:`dist_ranks`: fp32 gemma-2b at full width cut to 2
    layers, one row of TRAIN_REF_SEQ tokens a rank, the hierarchical step
    with ZeRO-1, then with ``compress`` too, from the same weights; rank 0
    holds both against the single-device ``train_step`` on the whole batch
    on its card: the loss, the grad norm, the parameters where |g| > 1e-3
    max|g| of the leaf, the moments; with ``compress``, the gradient read
    back from m within half a quantum a pod of the exact one."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, shutdown
    from repro_torch.models import get_api
    from repro_torch.models.registry import model_class
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import TrainHparams, batch_to_torch, make_train_step, \
        train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shape = (2, world // 2, 1)
    mesh = make_mesh(shape, ("pod", "data", "model"), device=f"cuda:{rank}",
                     init_method=f"file://{workdir}/store", world_size=world, rank=rank)
    try:
        cfg = configs.get_config(ARCHS[0]).replace(num_layers=2, param_dtype="float32",
                                                  compute_dtype="float32")
        batch = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=world,
                                         seq=TRAIN_REF_SEQ), model_cfg=cfg).batch_at(0)
        api, opt = get_api(cfg, device=mesh.device), OptConfig(**TRAIN_OPT)
        b1, pods = opt.beta1, shape[0]
        runs, init = {}, None
        for name, hp in (("exact", TrainHparams(hierarchical=True, zero1=True)),
                         ("compress", TrainHparams(hierarchical=True, zero1=True, compress=True))):
            step = make_train_step(api, cfg, opt, mesh, hp, batch)
            if init is None:
                state = step.init_state(seed=1)  # rank 0's weights on every rank
                init = {n: p.detach().clone() for n, p in state["model"].named_parameters()}
            else:
                state["model"].load_state_dict(init)
                state["opt"] = step.init_opt()
            scales = []
            t0 = time.perf_counter()
            with quantizer_recorded(scales):
                metrics = {k: v.item() for k, v in step(state, batch_to_torch(
                    batch, mesh.device)).items()}
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            m_full = {k: step.gather(k, t) for k, t in state["opt"]["m"].items()}
            params = {k: t.clone() for k, t in jax_keyed(dict(state["model"].named_parameters()),
                                                           cfg)}
            runs[name] = (metrics, params if rank == 0 else None, m_full if rank == 0 else None,
                          [s for _, s in scales])
            if rank == 0:
                log(f"{name}: loss {metrics['loss']:.6f}, grad norm {metrics['grad_norm']:.6g}, "
                    f"{ms:.1f} ms (first call), collectives {step.comm}")
        if rank != 0:
            return 0
        model = model_class(cfg)(cfg, mesh.device)
        model.load_state_dict(init)
        opt_state = adamw_init(model)
        ref = {k: v.item() for k, v in train_step(model, opt_state, batch_to_torch(
            batch, mesh.device), opt).items()}
        lr = ref["lr"]
        clip = {n: min(1.0, opt.clip_norm / max(m["grad_norm"], 1e-9))
                for n, (m, *_) in {**runs, "ref": (ref,)}.items()}
        ok = True
        for name, (metrics, params, m_full, scales) in runs.items():
            loss_err = abs(metrics["loss"] - ref["loss"]) / abs(ref["loss"])
            p_err = g_err = 0.0
            for i, ((key, p_ref), (_, m_ref)) in enumerate(zip(
                    jax_keyed(dict(model.named_parameters()), cfg),
                    jax_keyed(opt_state["m"], cfg))):
                g_ref = m_ref / ((1 - b1) * clip["ref"])
                g = m_full[key] / ((1 - b1) * clip[name])
                if name == "exact":
                    big = g_ref.abs() > 1e-3 * g_ref.abs().max()
                    p_err = max(p_err, (params[key] - p_ref).abs()[big].max().item())
                    bound = 1e-3 * g_ref.abs().max()
                else:  # half a quantum a pod, averaged over the ranks
                    bound = pods * scales[i] / 254 / world * (1 + 1e-3) + 1e-3 * g_ref.abs().max()
                g_err = max(g_err, ((g - g_ref).abs().max() / bound).item())
            norm_err = abs(metrics["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
            good = loss_err <= 1e-5 and g_err <= 1 and (
                name == "compress" or (norm_err <= 1e-4 and p_err <= 1e-2 * lr))
            ok &= good
            log(f"{name} vs the single-device step on the whole batch ({world} x "
                f"{TRAIN_REF_SEQ} tokens): loss rel err {loss_err:.3g} (tol 1e-5), grad norm "
                f"{metrics['grad_norm']:.6g} / {ref['grad_norm']:.6g} (rel err {norm_err:.3g}"
                f"{', tol 1e-4' if name == 'exact' else ', the quantizer moves it'}), gradient "
                f"read from m at {g_err:.3g} of its bound ("
                f"{'1e-3 max|g|' if name == 'exact' else 'half a quantum a pod + 1e-3 max|g|'})"
                + (f", parameters where |g| > 1e-3 max|g| max_abs_err {p_err:.3g} (tol "
                   f"{1e-2 * lr:.3g})" if name == "exact" else "") + f": {'ok' if good else 'FAIL'}")
        return 0 if ok else 1
    finally:
        shutdown()


# ---------------------------------------------------------------------------
# the model axis: tensor and expert parallelism
# ---------------------------------------------------------------------------

TP_ARCH = "qwen2.5-14b"
TP_RANK_TIMEOUT_S = 600
TP_REF_LAYERS = 2  # the fp32 check's cut of qwen2.5-14b's 48 layers


def tp_ranks(cards: int, smi: str) -> dict:
    """The ``tp:`` phase: ranks of the model axis, each this script with
    ``--tp-rank`` (:func:`tp_rank`).  On one card two ranks over gloo with
    CUDA tensors (NCCL refuses two ranks on one card:
    ``tools/dist_one_card_probe.py``), mesh (1, 1, 2): a check, not the
    launcher's path.  On a host of 4 or more cards four ranks over NCCL, one
    a card, mesh (1, 1, 4), then full qwen2.5-14b in bf16.  Returns rank 0's
    kernel launches per path."""
    world, backend = (4, "nccl") if cards >= 4 else (2, "gloo")
    launched = spawn_ranks("--tp-rank", world, backend, TP_RANK_TIMEOUT_S, "tp")
    log(f"  {smi}")
    return launched


def tp_launch_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd

    if wkv6.launches != wkv6.chunk_launches + wkv6.step_launches:
        raise AssertionError(f"wkv6.launches {wkv6.launches} is not the sum of its kernels'")
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm_bwd.launches,
            "wkv6": wkv6.chunk_launches, "wkv6_step": wkv6.step_launches,
            "wkv6_bwd": wkv6_bwd.launches, "selective_scan": selective_scan.launches,
            "selective_scan_bwd": selective_scan_bwd.launches}


def tp_zero_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.selective_scan import selective_scan, selective_scan_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd

    flash_attention.launches = flash_attention_bwd.launches = 0
    rmsnorm.launches = rmsnorm_bwd.launches = 0
    wkv6.launches = wkv6.chunk_launches = wkv6.step_launches = wkv6_bwd.launches = 0
    selective_scan.launches = selective_scan_bwd.launches = 0


def tp_check(mesh, rank: int, world: int, sequential: bool) -> dict:
    """qwen2.5-14b at full width cut to TP_REF_LAYERS layers in fp32, one
    row of TRAIN_REF_SEQ tokens, one hierarchical step with ZeRO-1
    (:func:`model_axis_step_check`).  Returns the kernels' launches of the
    step."""
    from repro_torch import configs
    from repro_torch.train.trainstep import TrainHparams

    cfg = configs.get_config(TP_ARCH).replace(num_layers=TP_REF_LAYERS, param_dtype="float32",
                                              compute_dtype="float32")
    return model_axis_step_check(mesh, rank, world, sequential, cfg,
                                 TrainHparams(hierarchical=True, zero1=True), 1)


def model_axis_step_check(mesh, rank: int, world: int, sequential: bool, cfg, hp,
                          rows: int) -> dict:
    """``cfg`` (fp32), ``rows`` rows of TRAIN_REF_SEQ tokens (and the
    family's frames or patches): one step ``hp`` on the mesh against the
    single-device ``train_step`` on the same card from the same seed
    (``init_state`` gives each rank its slices of the weights ``api.init``
    draws) on the same global batch.  Each rank holds its slices: the loss,
    the grad norm, the parameters where |g| > 1e-3 max|g| of the leaf, and
    the gradient read from its moment shard within 1e-3 max|g|.  With
    ``sequential`` (ranks sharing a card) the ranks build the reference one
    after the other.  Returns the kernels' launches of the step."""
    from repro_torch.models import get_api
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import batch_to_torch, make_train_step, train_step

    batch = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=rows, seq=TRAIN_REF_SEQ),
                          model_cfg=cfg).batch_at(0)
    opt = OptConfig(**TRAIN_OPT)
    b1, dev = opt.beta1, mesh.device
    t0 = time.perf_counter()
    step = make_train_step(get_api(cfg, dev, mesh=mesh), cfg, opt, mesh, hp, batch)
    # the reference first, keeping this rank's slices of its parameters and
    # moments (the whole model, its gradients and moments are 16 bytes a
    # parameter: ranks sharing a card take turns)
    keep = {}
    for turn in range(world if sequential else 1):
        if sequential:
            torch.distributed.barrier()
        if sequential and turn != rank:
            continue
        model = get_api(cfg, dev).init(seed=1)
        opt_state = adamw_init(model)
        ref = {k: v.item() for k, v in train_step(model, opt_state, batch_to_torch(
            batch, dev), opt).items()}
        g_of = (1 - b1) * min(1.0, opt.clip_norm / max(ref["grad_norm"], 1e-9))
        for (key, p_ref), (_, m_ref) in zip(jax_keyed(dict(model.named_parameters()), cfg),
                                            jax_keyed(opt_state["m"], cfg)):
            # the parameters' model slice (whole over the data axes without
            # fsdp) and its gradient, and the rank's shard of that gradient
            keep[key] = (step.model_slice(key, p_ref).clone(),
                         step.model_slice(key, m_ref) / g_of, step.shard(key, m_ref) / g_of,
                         (m_ref.abs().max() / g_of).item())
        del model, opt_state, p_ref, m_ref
        torch.cuda.empty_cache()
    if sequential:
        torch.distributed.barrier()
    t1 = time.perf_counter()
    state = step.init_state(seed=1)
    tp_zero_counts()
    metrics = {k: v.item() for k, v in step(state, batch_to_torch(batch, dev)).items()}
    launches = tp_launch_counts()
    t2 = time.perf_counter()
    comm = step.comm
    named = {n: p.detach() for n, p in state["model"].named_parameters()}
    held = sum(p.numel() for p in named.values())
    g_tp = (1 - b1) * min(1.0, opt.clip_norm / max(metrics["grad_norm"], 1e-9))
    lr, p_err, g_err = ref["lr"], 0.0, 0.0
    for key, names in step.leaves.items():
        mine = (torch.stack([named[n] for n in names]) if isinstance(names, tuple)
                else named[names])
        p_ref, g_ref, g_shard, top = keep.pop(key)
        big = g_ref.abs() > 1e-3 * top
        if big.any():
            p_err = max(p_err, (mine - p_ref)[big].abs().max().item())
        g = state["opt"]["m"][key] / g_tp  # the rank's shard of the moments
        g_err = max(g_err, ((g - g_shard).abs().max() / (1e-3 * top)).item())
        del mine, p_ref, g_ref, g_shard
    loss_err = abs(metrics["loss"] - ref["loss"]) / abs(ref["loss"])
    norm_err = abs(metrics["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    ok = (loss_err <= 1e-5 and norm_err <= 1e-4 and p_err <= 1e-2 * lr
          and g_err <= 1)
    log(f"rank {rank} of mesh {tuple(mesh.shape)} ({mesh.device}): {cfg.name} at full width cut "
        f"to {cfg.num_layers} layers, fp32, {rows} x {TRAIN_REF_SEQ} tokens; holds "
        f"{held / 1e9:.3f} B of {sum(int(np.prod(s)) for s in step.shapes.values()) / 1e9:.3f} B "
        f"parameters; the reference {t1 - t0:.1f} s, init_state and the step {t2 - t1:.1f} s "
        f"(first call); {'hierarchical' if hp.hierarchical else 'flat'} step with ZeRO-1 "
        f"vs the single-device train_step on the card: loss {metrics['loss']:.6f} / "
        f"{ref['loss']:.6f} (rel err {loss_err:.3g}, tol 1e-5), grad norm "
        f"{metrics['grad_norm']:.6g} / {ref['grad_norm']:.6g} (rel err {norm_err:.3g}, tol 1e-4), "
        f"its parameter slices where |g| > 1e-3 max|g| max_abs_err {p_err:.3g} (tol "
        f"{1e-2 * lr:.3g}, 1e-2 x lr), its moment slices' gradient at {g_err:.3g} of "
        f"1e-3 max|g|: {'ok' if ok else 'FAIL'}")
    if rank == 0:
        log(f"collectives of the step per axis (calls, bytes handed in): {comm}; launches "
            f"{launches}")
    if not ok:
        raise AssertionError(f"rank {rank}: the model-axis step disagrees with the single-device "
                             "step")
    return launches


def tp_train(mesh, rank: int, world: int, cfg=None) -> dict:
    """Full ``cfg`` (qwen2.5-14b by default) in bf16 on the mesh (one rank
    a card), batch TRAIN_BATCH x TRAIN_SEQ (whisper: TRAIN_TEXT) of the
    affine data, TRAIN_STEPS hierarchical steps with ZeRO-1: step ms
    (median of steps 1..), tok/s, peak memory a rank, the kernels' launches
    a step against the path's, ``comm`` per axis, the model axis's
    collectives of a step by kind and shape, and (other than qwen2.5-14b,
    whose step is split by :func:`tp_step_parts`) the device's busy and
    idle time in one profiled step.  Full depth; a cut would be printed.
    Returns the launches."""
    from repro_torch import configs
    from repro_torch.models import get_api
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import TrainHparams, batch_to_torch, make_train_step

    cfg = cfg or configs.get_config(TP_ARCH)
    seq = TRAIN_TEXT.get(cfg.name, TRAIN_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq=seq,
                                    mode="affine"), model_cfg=cfg)
    step = make_train_step(get_api(cfg, mesh.device, mesh=mesh), cfg, OptConfig(**TRAIN_OPT),
                           mesh, TrainHparams(hierarchical=True, zero1=True), data.batch_at(0))
    t0 = time.perf_counter()
    state = step.init_state(seed=0)
    torch.cuda.synchronize()
    held = sum(p.numel() for p in state["model"].parameters())
    if rank == 0:
        log(f"{cfg.name}: {cfg.num_layers} layers (full depth), bf16, {held / 1e9:.3f} B of "
            f"{sum(int(np.prod(s)) for s in step.shapes.values()) / 1e9:.3f} B parameters a rank, "
            f"initialised in {time.perf_counter() - t0:.1f} s; batch {TRAIN_BATCH} x {seq} on mesh "
            f"{tuple(mesh.shape)}")
    batches = [batch_to_torch(data.batch_at(i), mesh.device) for i in range(TRAIN_STEPS)]
    tp_zero_counts()
    losses, ms = [], []
    for i in range(TRAIN_STEPS):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        if i == TRAIN_STEPS - 1:  # the last step records each model-axis collective
            step.axis.log = []
        t0 = time.perf_counter()
        metrics = step(state, batches[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = tp_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(ms[1:])
    # the last step's collectives, before tp_step_parts' pass adds to them
    comm, calls = json.loads(json.dumps(step.comm)), step.axis.log
    step.axis.log = None
    parts = (tp_step_parts(step, state, batches[0], med) if cfg.name == TP_ARCH
             else step_busy(step, state, batches[0], med))
    if rank == 0:
        log(parts)
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    want = {k: v for k, v in expected_launches(cfg, "train").items() if k in per_step}
    by_kind = {}
    for what, shape, nbytes in calls:
        c = by_kind.setdefault((what, shape), [0, 0])
        c[0], c[1] = c[0] + 1, c[1] + nbytes
    if rank == 0:
        log("model-axis collectives of the forward and backward of one step by kind and shape "
            "(calls, bytes), largest first: "
            + "; ".join(f"{w} {s}: {n}, {b}" for (w, s), (n, b) in
                        sorted(by_kind.items(), key=lambda kv: -kv[1][1])))
        log(f"losses {[round(x, 4) for x in losses]}")
        log(f"step {med:.1f} ms (median of steps 1..{TRAIN_STEPS - 1}; step 0 {ms[0]:.1f} ms), "
            f"{TRAIN_BATCH * seq / med * 1e3:.0f} tok/s, peak device memory {peak:.2f} GiB "
            f"on rank 0; launches per step {per_step}; collectives per step (calls, bytes handed "
            f"in) {comm}")
    peaks = [torch.zeros((), device=mesh.device) for _ in range(world)]
    torch.distributed.all_gather(peaks, torch.tensor(peak, device=mesh.device))
    if rank == 0:
        log(f"peak device memory per rank: {[round(p.item(), 2) for p in peaks]} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"the losses are not finite: {losses}")
    if per_step != want:
        raise AssertionError(f"kernel launches per step {per_step} != {want} implied by the path")
    return launches


def step_busy(step, state, batch, step_ms: float) -> str:
    """The device's busy time in one profiled step (torch.profiler; the
    collective kernels, which wait for the other ranks, left out) against
    the unprofiled median step: its idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.distributed.barrier()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return "profile of a step: no device events (busy and idle not measured)"
    coll = sum(e.time_range.elapsed_us() for e in kern if "nccl" in e.name.lower()) / 1e3
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 - coll
    return (f"profile of one step: {len(kern)} kernels, device busy {busy:.1f} ms, idle share "
            f"{1 - busy / step_ms:.3f} of the unprofiled {step_ms:.1f} ms (collective kernels "
            f"{coll:.1f} ms from launch to end, left out of the busy time)")


def tp_step_parts(step, state, batch, step_ms: float) -> str:
    """Where a model-axis step's time goes: one forward and backward alone
    (``_accum_grads``, the model axis's collectives in it), the rest of the
    step (the data axes' collectives and AdamW on the rank's slices), and a
    residual all-reduce over ``model`` alone (median of 20, CUDA events)."""
    from repro_torch.train.trainstep import _accum_grads

    cfg = step.cfg
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = _accum_grads(state["model"], step.local_batch(batch), 1)
    torch.cuda.synchronize()
    fwd_bwd = (time.perf_counter() - t0) * 1e3
    del loss, grads
    x = torch.zeros((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), dtype=cfg.cdtype, device=step.mesh.device)
    group = step.groups["model"]
    times = []
    for _ in range(23):
        torch.distributed.barrier(group=group)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.distributed.all_reduce(x, group=group)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ar = statistics.median(times[3:])
    per_step = 4 * cfg.num_layers
    return (f"a step's parts: forward and backward alone {fwd_bwd:.1f} ms, the rest of the step "
            f"(data axes, AdamW on the slices) {step_ms - fwd_bwd:.1f} ms; one residual "
            f"all-reduce over model ({tuple(x.shape)} {str(x.dtype)[6:]}, "
            f"{x.numel() * x.element_size() / 1e6:.1f} MB) {ar:.3f} ms, x {per_step} a step "
            f"(4 a layer) = {ar * per_step:.1f} ms")


def tp_rank(rank: int, world: int, backend: str, workdir: str) -> int:
    """One rank of :func:`tp_ranks`: the fp32 check, then on 4 cards the
    bf16 run; rank 0 writes the launches of each path."""
    from repro_torch.launch.mesh import make_mesh, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_card = backend == "gloo"
    mesh = make_mesh((1, 1, world), ("pod", "data", "model"),
                     device="cuda:0" if one_card else f"cuda:{rank}",
                     init_method=f"file://{workdir}/store", world_size=world, rank=rank,
                     **({"backend": "gloo"} if one_card else {}))
    try:
        what = ("2 ranks on one card over gloo (a check, not the launcher's path)" if one_card
                else f"{world} ranks over NCCL, one a card")
        if rank == 0:
            log(f"mesh (pod, data, model) = {tuple(mesh.shape)}, {what}")
            if not one_card:
                for argv in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "-s", "-i", "0"]):
                    res = subprocess.run(argv, capture_output=True, text=True, timeout=60)
                    log(f"{' '.join(argv)}: " + (res.stdout + res.stderr).strip()[:1500])
        launched = {f"tp {TP_ARCH} fp32 {TP_REF_LAYERS}-layer check, mesh {tuple(mesh.shape)}":
                    tp_check(mesh, rank, world, sequential=one_card)}
        if not one_card:
            launched[f"tp {TP_ARCH} bf16 train, mesh {tuple(mesh.shape)}"] = \
                tp_train(mesh, rank, world)
        if rank == 0:
            with open(os.path.join(workdir, "launches.json"), "w") as f:
                json.dump(launched, f)
        return 0
    finally:
        shutdown()


FSDP_RANK_TIMEOUT_S = 900
FSDP_REF_LAYERS = 2  # the fp32 check's cut of gemma2-9b: one unit, a local and a global layer
FSDP_STEPS = 6


def spawn_ranks(flag: str, world: int, backend: str, timeout_s: float, what: str) -> dict:
    """Ranks of a multi-rank phase, each this script with ``flag`` (its rank),
    ``--rank-world``, ``--rank-backend`` and ``--dist-dir``; rank 0's log is
    printed.  Every rank is killed if one fails or the time runs out.
    Returns the kernel launches rank 0 wrote per path."""
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{what}_")
    torch.cuda.empty_cache()
    procs, t0 = [], time.perf_counter()
    try:
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log"), "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), flag, str(r),
                     "--rank-world", str(world), "--rank-backend", backend, "--dist-dir", workdir],
                    stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        with open(os.path.join(workdir, "rank0.log")) as f:
            for line in f.read().splitlines():
                log(f"    {line}")
        failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        # the first rank that failed by itself (the others are killed after it)
        for r, _ in sorted(failed, key=lambda f: f[1] < 0)[:1]:
            if r:
                with open(os.path.join(workdir, f"rank{r}.log")) as f:
                    log(f"    rank {r}: {f.read()[-3000:]}")
        launched = {}
        if not failed:
            with open(os.path.join(workdir, "launches.json")) as f:
                launched = json.load(f)
        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        raise AssertionError(f"the {what} phase failed: ranks and exit codes {failed}")
    log(f"  {what} phase: {world} ranks over {backend} in {time.perf_counter() - t0:.1f} s")
    return launched


def fsdp_ranks(cards: int, smi: str) -> dict:
    """The ``fsdp:`` phase: ZeRO-3 over the data axes (``dist.fsdp``), ranks
    each this script with ``--fsdp-rank`` (:func:`fsdp_rank`).  On one card
    two ranks over gloo with CUDA tensors, mesh (1, 2, 1): a check, not the
    launcher's path.  On a host of 4 or more cards four ranks over NCCL, one
    a card: the check at (1, 4, 1) and (2, 2, 1), then full gemma2-9b in
    bf16 at (1, 4, 1).  Returns rank 0's kernel launches per path."""
    world, backend = (4, "nccl") if cards >= 4 else (2, "gloo")
    launched = spawn_ranks("--fsdp-rank", world, backend, FSDP_RANK_TIMEOUT_S, "fsdp")
    log(f"  {smi}")
    return launched


def fsdp_check(mesh, rank: int, world: int, sequential: bool, cfg=None) -> dict:
    """``cfg`` (fp32; by default gemma2-9b at full width cut to
    FSDP_REF_LAYERS layers, one local and one global layer), one row of
    TRAIN_REF_SEQ tokens (and the family's frames or patches) a rank: one
    flat step with ``fsdp`` against the single-device ``train_step`` on the
    same card from the same seed on the same global batch (``init_state``
    gives each rank its blocks of the weights ``api.init`` draws).  Each
    rank holds its blocks: the loss, the grad norm, every parameter block
    where |g| > 1e-3 max|g| of the leaf (within 1e-2 lr), and the gradient
    read from every moment block (within 1e-3 max|g|).  An MoE model's DP
    ranks route their rows apart (the auxiliary loss too), so its reference
    takes each rank's rows as one of ``grad_accum`` microbatches.  With
    ``sequential``
    (ranks sharing a card) the ranks build the reference one after the
    other.  Returns the kernels' launches of the step."""
    from repro_torch import configs
    from repro_torch.models import get_api
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig, adamw_init
    from repro_torch.train.trainstep import TrainHparams, batch_to_torch, make_train_step, \
        train_step

    cfg = cfg or configs.get_config(FSDP_ARCH).replace(
        num_layers=FSDP_REF_LAYERS, param_dtype="float32", compute_dtype="float32")
    batch = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=world, seq=TRAIN_REF_SEQ),
                          model_cfg=cfg).batch_at(0)
    opt = OptConfig(**TRAIN_OPT)
    b1, dev = opt.beta1, mesh.device
    t0 = time.perf_counter()
    step = make_train_step(get_api(cfg, dev, mesh=mesh, fsdp=True), cfg, opt, mesh,
                           TrainHparams(fsdp=True), batch)
    keep = {}
    for turn in range(world if sequential else 1):
        if sequential:
            torch.distributed.barrier()
        if sequential and turn != rank:
            continue
        model = get_api(cfg, dev).init(seed=1)
        opt_state = adamw_init(model)
        # an MoE model's DP ranks route (and sum the auxiliary loss over)
        # their rows apart: the reference takes each rank's rows as a microbatch
        ref = {k: v.item() for k, v in train_step(model, opt_state, batch_to_torch(
            batch, dev), opt, TrainHparams(grad_accum=step.n_dp if cfg.moe else 1)).items()}
        g_of = (1 - b1) * min(1.0, opt.clip_norm / max(ref["grad_norm"], 1e-9))
        for (key, p_ref), (_, m_ref) in zip(jax_keyed(dict(model.named_parameters()), cfg),
                                            jax_keyed(opt_state["m"], cfg)):
            keep[key] = (step.shard(key, p_ref).clone(), step.shard(key, m_ref) / g_of,
                         (m_ref.abs().max() / g_of).item())
        del model, opt_state, p_ref, m_ref
        torch.cuda.empty_cache()
    if sequential:
        torch.distributed.barrier()
    t1 = time.perf_counter()
    state = step.init_state(seed=1)
    tp_zero_counts()
    metrics = {k: v.item() for k, v in step(state, batch_to_torch(batch, dev)).items()}
    launches = tp_launch_counts()
    t2 = time.perf_counter()
    named = {n: p.detach() for n, p in state["model"].named_parameters()}
    held = sum(p.numel() for p in named.values())
    g_fsdp = (1 - b1) * min(1.0, opt.clip_norm / max(metrics["grad_norm"], 1e-9))
    lr, p_err, g_err = ref["lr"], 0.0, 0.0
    for key in step.leaves:
        mine = step.param(named, key)
        p_ref, g_ref, top = keep.pop(key)
        if mine.shape != p_ref.shape or state["opt"]["m"][key].shape != p_ref.shape:
            raise AssertionError(f"{key}: the rank holds {tuple(mine.shape)}, its block is "
                                 f"{tuple(p_ref.shape)}")
        big = g_ref.abs() > 1e-3 * top
        if big.any():
            p_err = max(p_err, (mine - p_ref)[big].abs().max().item())
        g = state["opt"]["m"][key] / g_fsdp
        g_err = max(g_err, ((g - g_ref).abs().max() / (1e-3 * top)).item())
        del mine, p_ref, g_ref
    loss_err = abs(metrics["loss"] - ref["loss"]) / abs(ref["loss"])
    norm_err = abs(metrics["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    ok = loss_err <= 1e-5 and norm_err <= 1e-4 and p_err <= 1e-2 * lr and g_err <= 1
    total = sum(int(np.prod(s)) for s in step.shapes.values())
    log(f"rank {rank} of mesh {tuple(mesh.shape)} ({mesh.device}): {cfg.name} at full width cut "
        f"to {cfg.num_layers} layers" + (f", {cfg.moe.num_experts} experts" if cfg.moe else "")
        + f", fp32, {world} x {TRAIN_REF_SEQ} tokens ({world // step.n_dp} rows a DP rank); "
        f"holds {held / 1e9:.3f} B of {total / 1e9:.3f} B parameters; the reference "
        f"{t1 - t0:.1f} s, init_state and the step {t2 - t1:.1f} s (first call); flat step "
        f"with fsdp vs the single-device train_step on the card: loss {metrics['loss']:.6f} / "
        f"{ref['loss']:.6f} (rel err {loss_err:.3g}, tol 1e-5), grad norm "
        f"{metrics['grad_norm']:.6g} / {ref['grad_norm']:.6g} (rel err {norm_err:.3g}, tol 1e-4), "
        f"its parameter blocks where |g| > 1e-3 max|g| max_abs_err {p_err:.3g} (tol "
        f"{1e-2 * lr:.3g}, 1e-2 x lr), its moment blocks' gradient at {g_err:.3g} of "
        f"1e-3 max|g|: {'ok' if ok else 'FAIL'}")
    if rank == 0:
        log(f"collectives of the step (calls, bytes handed in): {step.comm}; launches "
            f"{launches}")
    if not ok:
        raise AssertionError(f"rank {rank}: the FSDP step disagrees with the single-device step")
    return launches


def fsdp_bytes(step, model) -> tuple:
    """(calls, bytes) of a flat FSDP step over the DP group that the leaves
    imply: each cut leaf gathered (all-gather output or broadcast, in its
    own dtype: fp32 leaves such as Mamba's ``A_log`` stay fp32) and its
    gradient reduced (fp32) once a use, a layer's tensor at a time; the
    tied table twice (the embedding and the loss: the decoder's
    ``embed/tok``, the VLM's ``lm/embed/tok``, whisper's ``tok``); then
    the loss, the whole leaves' fp32 gradients and the cut leaves' squares
    all-reduced."""
    cfg = step.cfg
    named = dict(model.named_parameters())
    calls = nbytes = n_cut = 0
    for key, names in step.leaves.items():
        numel = int(np.prod(step.local[key]))
        if step.dims[key] is None:
            calls, nbytes = calls + 1, nbytes + 4 * numel
            continue
        n_cut += 1
        tied = cfg.tie_embeddings and key in ("embed/tok", "lm/embed/tok", "tok")
        uses = 2 if tied else 1
        pieces = len(names) if isinstance(names, tuple) else 1
        itemsize = named[names[0] if isinstance(names, tuple) else names].element_size()
        calls += 2 * uses * pieces
        nbytes += uses * numel * (itemsize + 4)
    return calls + 2, nbytes + 4 + 4 * n_cut


def fsdp_train(mesh, rank: int, world: int, cfg=None, steps: int = FSDP_STEPS,
               rows_a_rank: int = FSDP_ROWS) -> dict:
    """``cfg`` (by default full gemma2-9b) in bf16 (fp32 moments) with
    ``fsdp`` (one rank a card), global batch ``rows_a_rank`` x world x
    TRAIN_SEQ (whisper: its 448-token text and 1500 frames) of the affine
    data, ``steps`` flat steps: every loss finite and the last batch's
    loss lower after its step; step ms (median of steps 1..), tok/s, peak
    memory on every rank, the kernels' launches a step against the path's,
    the DP group's collectives a step against the bytes the leaves imply,
    then a step's forward and backward alone against the rest.  Returns the
    launches."""
    from repro_torch import configs
    from repro_torch.models import get_api
    from repro_torch.models.registry import loss_fn
    from repro_torch.train.data import DataConfig, SyntheticData
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainstep import TrainHparams, batch_to_torch, make_train_step

    cfg = cfg or configs.get_config(FSDP_ARCH)
    rows, seq = rows_a_rank * world, TRAIN_TEXT.get(cfg.name, TRAIN_SEQ)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=rows, seq=seq,
                                    mode="affine"), model_cfg=cfg)
    step = make_train_step(get_api(cfg, mesh.device, mesh=mesh, fsdp=True), cfg,
                           OptConfig(**TRAIN_OPT), mesh, TrainHparams(fsdp=True),
                           data.batch_at(0))
    t0 = time.perf_counter()
    state = step.init_state(seed=0)
    torch.cuda.synchronize()
    held = sum(p.numel() for p in state["model"].parameters())
    total = sum(int(np.prod(s)) for s in step.shapes.values())
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    if rank == 0:
        log(f"{cfg.name}: {cfg.num_layers} layers"
            + (f", {cfg.moe.num_experts} experts" if cfg.moe else "")
            + f", bf16 with fp32 moments, {held / 1e9:.3f} B of {total / 1e9:.3f} B parameters "
            f"a rank, initialised in {time.perf_counter() - t0:.1f} s (peak {init_peak:.2f} GiB "
            f"while drawing); batch {rows} x {seq} ({rows_a_rank} rows a rank)")
    batches = [batch_to_torch(data.batch_at(i), mesh.device) for i in range(steps)]
    tp_zero_counts()
    losses, ms = [], []
    for i in range(steps):
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batches[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    launches = tp_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    comm = json.loads(json.dumps(step.comm))  # the last step's
    with torch.no_grad():  # the last batch after its step, over the DP group
        after = loss_fn(cfg)(state["model"], step.local_batch(batches[-1])).float()
        torch.distributed.all_reduce(after)
        after = after.item() / step.n_dp
    med = statistics.median(ms[1:])
    parts = fsdp_step_parts(step, state, batches[0], med)
    per_step = {k: n / steps for k, n in launches.items()}
    want = {k: v for k, v in expected_launches(cfg, "train").items() if k in per_step}
    calls, nbytes = fsdp_bytes(step, state["model"])
    dp = "+".join(step.dp)
    got = comm.get(dp, {})
    leaves_bytes = sum(int(np.prod(s)) * cfg.pdtype.itemsize for s in step.local.values())
    if rank == 0:
        log(parts)
        log(f"losses {[round(x, 4) for x in losses]}; the last batch after its step "
            f"{after:.4f}")
        log(f"step {med:.1f} ms (median of steps 1..{steps - 1}; step 0 {ms[0]:.1f} ms), "
            f"{rows * seq / med * 1e3:.0f} tok/s, peak device memory {peak:.2f} GiB on "
            f"rank 0; launches per step per rank {per_step}; collectives per step (calls, bytes "
            f"handed in) {comm}; the leaves imply {calls} calls and {nbytes / 1e9:.3f} GB over "
            f"{dp} (the whole model in bf16 is {leaves_bytes / 1e9:.3f} GB: each cut leaf "
            f"gathered once a use in bf16 and its gradient reduced in fp32)")
    peaks = [torch.zeros((), device=mesh.device) for _ in range(world)]
    torch.distributed.all_gather(peaks, torch.tensor(peak, device=mesh.device))
    if rank == 0:
        log(f"peak device memory per rank: {[round(p.item(), 2) for p in peaks]} GiB")
    if not all(np.isfinite(losses)) or not np.isfinite(after):
        raise AssertionError(f"the losses are not finite: {losses}, {after}")
    if not after < losses[-1]:
        raise AssertionError(f"the last batch's loss did not fall after its step: "
                             f"{losses[-1]} -> {after}")
    if per_step != want:
        raise AssertionError(f"kernel launches per step {per_step} != {want} implied by the path")
    if (got.get("calls"), got.get("bytes")) != (calls, nbytes):
        raise AssertionError(f"collectives over {dp} {got} != ({calls}, {nbytes}) the leaves "
                             "imply")
    return launches


def fsdp_step_parts(step, state, batch, step_ms: float) -> str:
    """Where an FSDP step's time goes: one forward and backward alone
    (``_accum_grads``, the gathers and gradient reductions in it) against
    the rest of the step (the whole leaves' all-reduce, the norm, AdamW on
    the blocks), and one all-gather of the largest tensor cut inside its
    layer alone (median of 20, CUDA events)."""
    from repro_torch.dist.fsdp import _AllGather
    from repro_torch.train.trainstep import _accum_grads

    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = _accum_grads(state["model"], step.local_batch(batch), 1)
    torch.cuda.synchronize()
    fwd_bwd = (time.perf_counter() - t0) * 1e3
    del loss, grads
    wi = max((p for p in state["model"].parameters() if getattr(p, "fsdp_dim", None) is not None),
             key=lambda p: int(np.prod(p.fsdp_shape)))
    name = next(n for n, p in state["model"].named_parameters() if p is wi)
    times = []
    for _ in range(23):
        torch.distributed.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.no_grad():
            full = _AllGather.apply(wi, wi.fsdp_dim, step.fsdp)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        del full
    ag = statistics.median(times[3:])
    size = int(np.prod(wi.fsdp_shape)) * wi.element_size()
    return (f"a step's parts: forward and backward alone {fwd_bwd:.1f} ms (ZeRO-3's gathers and "
            f"gradient reductions in it), the rest of the step (the whole leaves' all-reduce, "
            f"the norm, AdamW on the blocks) {step_ms - fwd_bwd:.1f} ms; one all-gather of the "
            f"largest gathered tensor, {name} ({tuple(wi.fsdp_shape)}, {size / 1e6:.1f} MB), "
            f"{ag:.3f} ms, "
            f"{size / ag / 1e6:.1f} GB/s of output")


def fsdp_rank(rank: int, world: int, backend: str, workdir: str) -> int:
    """One rank of :func:`fsdp_ranks`: the fp32 checks, then on 4 cards the
    bf16 run; rank 0 writes the launches of each path."""
    from repro_torch.launch.mesh import make_mesh, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_card = backend == "gloo"
    shapes = [(1, 2, 1)] if one_card else [(1, world, 1), (2, world // 2, 1)]
    init = dict(device="cuda:0" if one_card else f"cuda:{rank}",
                init_method=f"file://{workdir}/store", world_size=world, rank=rank,
                **({"backend": "gloo"} if one_card else {}))
    meshes = [make_mesh(s, ("pod", "data", "model"), **init) for s in shapes]
    try:
        what = ("2 ranks on one card over gloo (a check, not the launcher's path)" if one_card
                else f"{world} ranks over NCCL, one a card")
        if rank == 0:
            log(f"meshes (pod, data, model) = {shapes}, {what}")
        launched = {}
        for mesh in meshes:
            launched[f"fsdp {FSDP_ARCH} fp32 {FSDP_REF_LAYERS}-layer check, mesh "
                     f"{tuple(mesh.shape)}"] = fsdp_check(mesh, rank, world, sequential=one_card)
            torch.cuda.empty_cache()
        if not one_card:
            launched[f"fsdp {FSDP_ARCH} bf16 train, mesh {tuple(meshes[0].shape)}"] = \
                fsdp_train(meshes[0], rank, world)
        if rank == 0:
            with open(os.path.join(workdir, "launches.json"), "w") as f:
                json.dump(launched, f)
        return 0
    finally:
        shutdown()


SERVE_TP_RANK_TIMEOUT_S = 900
SERVE_TP_PROMPT, SERVE_TP_NEW = 128, 4  # the fp32 checks' prompt and new tokens
# new tokens of the fsdp checks: a prefill and one decode step, each pass of
# which gathers gemma2-9b's 3.67 GB fp32 table twice (embedding and tied
# unembedding; ~9 s a pass over gloo on one card)
SERVE_TP_NEW_FSDP = 2
SERVE_TP_TOL = 1e-3  # fp32 logits: sums over d taken in another order, as the reference phase


def serve_tp_ranks(cards: int, smi: str) -> dict:
    """The ``serve_tp:`` phase: sharded serving (prefill and greedy decode on
    every rank of a mesh), ranks each this script with ``--serve-tp-rank``
    (:func:`serve_tp_rank`).  On one card two ranks over gloo with CUDA
    tensors (a check, not the launcher's path); on a host of 4 or more
    cards four ranks over NCCL, one a card, then full qwen2.5-14b in bf16
    at TP 4.  Returns rank 0's kernel launches per path."""
    world, backend = (4, "nccl") if cards >= 4 else (2, "gloo")
    launched = spawn_ranks("--serve-tp-rank", world, backend, SERVE_TP_RANK_TIMEOUT_S,
                           "serve_tp")
    log(f"  {smi}")
    return launched


def serve_tp_cases(world: int) -> list:
    """(config, mesh shape, fsdp) of the fp32 checks: qwen2.5-14b and
    gemma-2b cut to 2 layers and deepseek-v3 as the reference phase cuts it
    on the model axis, gemma2-9b cut to 2 layers under ZeRO-3 on the data
    axes; on 4 cards also at (1, 2, 2)."""
    from repro_torch import configs

    two = dict(num_layers=2, param_dtype="float32", compute_dtype="float32")
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    qwen = configs.get_config(TP_ARCH).replace(**two)
    gemma = configs.get_config("gemma-2b").replace(**two)
    deepseek = moe_reference_config(configs.get_config("deepseek-v3-671b")).replace(**fp32)
    gemma2 = configs.get_config(FSDP_ARCH).replace(**two)
    if world == 2:
        return [(c, (1, 1, 2), False) for c in (qwen, gemma, deepseek)] + \
            [(gemma2, (1, 2, 1), True)]
    return [(c, m, False) for m in ((1, 1, 4), (1, 2, 2)) for c in (qwen, gemma, deepseek)] + \
        [(gemma2, m, True) for m in ((1, 4, 1), (1, 2, 2))]


def greedy_run(api, model, inputs: dict, new: int, mesh=None, routed=None) -> tuple:
    """``ServeEngine.generate`` of ``new`` tokens from ``inputs`` (the whole
    batch; on ``mesh`` the engine takes the rank's rows), recording each
    call's last-position fp32 logits of the rank's rows and, with
    ``routed``, each MoE routing call's top-k experts: (logits (rows, new,
    V), the whole batch's tokens)."""
    from repro_torch.serve.engine import ServeEngine

    steps, calls = [], []

    def logged(fn):
        def call(*args, **kw):
            logits, cache = fn(*args, **kw)
            steps.append(logits[:, -1].float())
            return logits, cache
        return call

    B, S = inputs["tokens"].shape
    eng = ServeEngine(dataclasses.replace(api, prefill=logged(api.prefill),
                                          decode=logged(api.decode)),
                      model, batch=B, s_max=S + new, mesh=mesh)
    with routing_recorded(calls):
        toks = eng.generate(inputs, max_new_tokens=new)
    if routed is not None:
        routed.extend(idx for idx, _ in calls)
    return torch.stack(steps, 1), toks


def cache_leaf_kind(cfg, key: str, shape) -> str:
    """What a rank of the model axis holds of JAX's cache leaf ``key``
    (stacked ``shape``): ``kv`` (the kv heads its query heads read), ``wkv``
    (its heads' WKV states), ``mamba`` (its channels' states), or whole:
    ``x_prev`` (the token shift reads all of d), ``enc`` (every frame feeds
    its heads), ``mla`` (the latents)."""
    from repro_torch.models.transformer import layer_plan

    if key == "enc":
        return "enc"
    parts = key.split("/")
    if parts[0] == "kv":  # whisper's decoder self-attention
        return "kv"
    plan = layer_plan(cfg)
    spec = plan.prologue[0] if parts[0] == "pro" else plan.unit[int(parts[1][1:])]
    if spec.kind == "rwkv":
        return "wkv" if parts[-1] == "1" else "x_prev"
    if spec.kind == "mamba":
        return "mamba"
    return "kv" if len(shape) == 5 else "mla"


def cache_bytes(api, mesh, rows: int, s_max: int) -> tuple:
    """(a rank's cache bytes, the bytes ``cache_specs`` gives it, the bytes
    the port's rule gives it, and by :func:`cache_leaf_kind` (the rule's
    bytes, ``cache_specs``')): its rows, and of a GQA layer's k and v the kv
    heads ``kv0 .. kv1`` its query heads read, whole; of an rwkv layer's
    WKV state its heads', of a Mamba layer's states its channels'; MLA's
    latents, the token-shift states and whisper's ``enc`` whole."""
    from repro_torch.dist.sharding import cache_specs, mesh_axis_sizes, spec_slice
    from repro_torch.models.attention import kv_heads
    from repro_torch.models.convert import cache_leaves, cache_shapes
    from repro_torch.models.rwkv import local_heads, rwkv_dims
    from repro_torch.models.ssm import local_channels, mamba_dims
    from repro_torch.serve.engine import _tensors

    cfg, sizes, coords = api.cfg, mesh_axis_sizes(mesh), mesh.coords()
    cache = api.init_cache(rows, s_max)
    held = sum(t.nbytes for t in _tensors(cache))
    shapes = cache_shapes(cfg, rows, s_max)
    m = sizes["model"]
    kv0, kv1 = kv_heads(cfg, m, coords["model"])

    def nbytes(shape, spec, size):  # of the rank's block of a leaf cut as spec
        return size * int(np.prod(
            [len(range(n)[sl]) for n, sl in zip(shape, spec_slice(spec, shape, sizes, coords))]))

    implied = rule = 0
    by_kind = {}
    places = cache_leaves(cfg)
    for key, spec in cache_specs(shapes, mesh, cfg).items():
        if not shapes[key]:
            continue
        i, j = (None, None) if key == "enc" else places[key][0]
        size = (cache["enc"] if key == "enc" else cache["layers"][i][j]).element_size()
        kind = cache_leaf_kind(cfg, key, shapes[key])
        block = nbytes(shapes[key], spec, size)
        share = nbytes(shapes[key], tuple(None if a == "model" else a for a in spec), size)
        if kind == "kv":
            share = share * (kv1 - kv0) // cfg.num_kv_heads
        elif kind == "wkv":
            share = share * local_heads(cfg, m) // rwkv_dims(cfg)[1]
        elif kind == "mamba":
            share = share * local_channels(cfg, m) // mamba_dims(cfg)[1]
        implied, rule = implied + block, rule + share
        k = by_kind.setdefault(kind, [0, 0])
        k[0], k[1] = k[0] + share, k[1] + block
    return held, implied, rule, by_kind


def cache_multiples(by_kind: dict) -> str:
    """A rank's cache bytes against ``cache_specs``' by leaf kind."""
    return ", ".join(f"{kind} {held:,} B / {spec:,} B ({held / spec:.2f}x)"
                     for kind, (held, spec) in sorted(by_kind.items()))


def serve_tp_check(mesh, rank: int, world: int, cfg, fsdp: bool, sequential: bool,
                   new=None) -> dict:
    """``cfg`` (fp32) served on ``mesh`` (``fsdp``: ZeRO-3 blocks) against the
    single-device model on the same card from the same seed, on world rows
    of SERVE_TP_PROMPT tokens and SERVE_TP_NEW new ones (SERVE_TP_NEW_FSDP
    with ``fsdp``): the rank's rows of
    every call's logits within SERVE_TP_TOL, the greedy tokens equal (the
    engine's, gathered over the DP group; ``new`` of them if given), every
    MoE routing decision equal,
    and the rank's cache bytes against ``cache_specs``'.  With
    ``sequential`` (ranks sharing a card) the ranks build the reference one
    after the other.  Returns the kernels' launches of the rank's run."""
    from repro_torch.dist.sharding import rows_of
    from repro_torch.models import get_api, modality_inputs

    dev = mesh.device
    new = new or (SERVE_TP_NEW_FSDP if fsdp else SERVE_TP_NEW)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, size=(world, SERVE_TP_PROMPT)).astype(np.int64)
    inputs = {"tokens": tokens, **modality_inputs(cfg, rng, world)}
    r0, n = rows_of(world, mesh)
    t0 = time.perf_counter()
    ref = None
    for turn in range(world if sequential else 1):
        if sequential:
            torch.distributed.barrier()
        if sequential and turn != rank:
            continue
        whole = get_api(cfg, dev)
        model = whole.init(seed=1)
        routed_ref = []
        logits, toks = greedy_run(whole, model, inputs, new, routed=routed_ref)
        ref = (logits[r0:r0 + n].cpu(), toks, routed_ref)
        del model, logits
        torch.cuda.empty_cache()
    if sequential:
        torch.distributed.barrier()
    t1 = time.perf_counter()
    api = get_api(cfg, dev, mesh=mesh, fsdp=fsdp)
    model = api.init(seed=1)
    held = sum(p.numel() for p in model.parameters())
    tp_zero_counts()
    routed = []
    logits, toks = greedy_run(api, model, inputs, new, mesh, routed)
    launches = tp_launch_counts()
    t2 = time.perf_counter()
    err = (logits.cpu() - ref[0]).abs().max().item()
    top = ref[0].abs().max().item()
    # the reference routes every row; this rank its rows r0 .. r0 + n
    per_row = [t.reshape(world, -1, t.shape[-1])[r0:r0 + n].reshape(-1, t.shape[-1])
               for t in ref[2]]
    differ = sum(int((a != b).sum()) for a, b in zip(routed, per_row))
    same_calls = [tuple(a.shape) for a in routed] == [tuple(b.shape) for b in per_row]
    held_b, implied_b, rule_b, by_kind = cache_bytes(api, mesh, world, SERVE_TP_PROMPT + new)
    ok = (err <= SERVE_TP_TOL and np.array_equal(toks, ref[1]) and same_calls and differ == 0
          and held_b == rule_b)
    log(f"rank {rank} of mesh {tuple(mesh.shape)} ({dev}): {cfg.name}, {cfg.num_layers} layers"
        + (f", {cfg.moe.num_experts} experts" if cfg.moe else "") + (" with fsdp" if fsdp else "")
        + f", fp32, {world} x {SERVE_TP_PROMPT} + {new}; holds {held / 1e9:.3f} B "
        f"parameters; the reference {t1 - t0:.1f} s, the rank's runs {t2 - t1:.1f} s; against "
        f"the single-device model on the card: logits of its rows max_abs_err {err:.3g} (tol "
        f"{SERVE_TP_TOL}; max|logit| {top:.3g}), greedy tokens "
        f"{'equal' if np.array_equal(toks, ref[1]) else 'DIFFER'}"
        + (f", routing decisions that differ {differ} of {sum(a.numel() for a in routed)}"
           if cfg.moe else "")
        + f"; cache {held_b:,} B a rank, cache_specs gives {implied_b:,} B "
        f"({held_b / implied_b:.2f}x; by the rule {rule_b:,} B; by leaf: "
        f"{cache_multiples(by_kind)}); comm of generate "
        f"{api.axis.comm if api.axis is not None else {}}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"rank {rank}: sharded serving of {cfg.name} disagrees with the "
                             "single-device model")
    del model
    torch.cuda.empty_cache()
    return launches


def serve_tp_full(mesh, rank: int, world: int, cfg, one_card: bool = False) -> dict:
    """``cfg`` in bf16 on ``mesh`` (one rank a card), batch SERVE_BATCH x
    the path's prompt (PROMPT_LEN; whisper's 1500 frames and SERVE_PROMPT,
    internvl2's patches first) + MAX_NEW through ``ServeEngine.generate``:
    prefill ms, decode ms/token, tok/s and peak memory on every rank, the
    kernels' launches against the path's, the model axis's collectives of
    a prefill and of a decode step by kind and shape (``ModelAxis.log``),
    what the step's collectives cost alone (:func:`collective_costs`), a
    profile of the device's busy and idle time, and the rank's cache
    against ``cache_specs``'.  The peak is read twice: while the rank's
    slices are drawn (each module is drawn whole on the card, then cut)
    and while serving.  With ``one_card``, rank 0 then serves the whole
    model on its card from the same seed and the greedy tokens of both are
    compared (recorded, not held).  Returns the launches."""
    from repro_torch.dist.sharding import rows_of
    from repro_torch.models import get_api, modality_inputs
    from repro_torch.models.registry import model_class
    from repro_torch.serve.engine import ServeEngine

    dev = mesh.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api = get_api(cfg, dev, mesh=mesh)
    t0 = time.perf_counter()
    model = api.init(seed=0)
    torch.cuda.synchronize()
    held = sum(p.numel() for p in model.parameters())
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    prompt = SERVE_PROMPT.get(cfg.name, PROMPT_LEN)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, prompt)).astype(np.int64)
    inputs = {"tokens": tokens, **modality_inputs(cfg, rng, SERVE_BATCH)}
    s_max = prompt + MAX_NEW
    if rank == 0:
        whole = sum(p.numel() for p in model_class(cfg)(cfg, torch.device("meta")).parameters())
        log(f"{cfg.name}: {cfg.num_layers} layers"
            + (f", {cfg.moe.num_experts} experts" if cfg.moe else "")
            + f", {str(cfg.pdtype)[6:]}, {held / 1e9:.3f} B parameters a rank of the whole "
            f"model's {whole / 1e9:.3f} B (param_counts() {cfg.param_counts()[0] / 1e9:.3f} B, "
            f"without norms and biases), initialised in {time.perf_counter() - t0:.1f} s (peak "
            f"{init_peak:.2f} GiB while drawing); batch {SERVE_BATCH} x {prompt} + {MAX_NEW}"
            + (f" after {cfg.encoder_seq} frames" if cfg.family == "audio" else "")
            + (f" after {cfg.vision_tokens} patches" if cfg.family == "vlm" else ""))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(api, model, batch=SERVE_BATCH, s_max=s_max, mesh=mesh)
    eng.generate(dict(inputs, tokens=tokens[:, :64]), max_new_tokens=2)  # warm-up
    torch.distributed.barrier()
    tp_zero_counts()
    t0 = time.perf_counter()
    out = eng.generate(inputs, max_new_tokens=MAX_NEW)
    total_s = time.perf_counter() - t0
    launches = {k: n for k, n in tp_launch_counts().items() if not k.endswith("_bwd")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = eng.timing
    prefill_ms, decode_ms = t["prefill_s"] * 1e3, t["decode_s"] * 1e3 / t["decode_steps"]
    # the model axis's collectives of one prefill and of one decode step
    local = {k: torch.from_numpy(v).to(dev) for k, v in eng.local_inputs(inputs).items()}
    calls = {}
    with torch.inference_mode():
        cache = api.init_cache(SERVE_BATCH, s_max)
        api.axis.log = []
        logits, cache = api.prefill(model, local, cache, last_only=True)
        calls["prefill"], api.axis.log = api.axis.log, []
        logits, cache = api.decode(model, logits[:, -1].argmax(-1)[:, None], cache)
        calls["decode step"], api.axis.log = api.axis.log, None
    del cache
    peaks = [torch.zeros((), device=dev) for _ in range(world)]
    torch.distributed.all_gather(peaks, torch.tensor(peak, device=dev))
    want = {k: v for k, v in expected_launches(cfg).items() if k in launches}
    held_b, implied_b, _, by_kind = cache_bytes(api, mesh, SERVE_BATCH, s_max)
    if rank == 0:
        log(f"generated {out.shape}: prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} "
            f"ms/token, {SERVE_BATCH * MAX_NEW / total_s:.1f} tok/s over {total_s:.3f} s; "
            f"launches {launches} (the path's {want}); peak device memory per rank "
            f"{[round(p.item(), 2) for p in peaks]} GiB; cache {held_b:,} B a rank, "
            f"cache_specs gives {implied_b:,} B ({held_b / implied_b:.2f}x; by leaf: "
            f"{cache_multiples(by_kind)})")
        for part, logged in calls.items():
            by = {}
            for what, shape, nbytes in logged:
                c = by.setdefault((what, shape), [0, 0])
                c[0], c[1] = c[0] + 1, c[1] + nbytes
            log(f"model-axis collectives of one {part}: {len(logged)} calls, "
                f"{sum(b for _, _, b in logged) / 1e6:.3f} MB; by kind and shape (calls, "
                "bytes), largest first: " + "; ".join(
                    f"{w} {sh}: {c}, {b}" for (w, sh), (c, b) in
                    sorted(by.items(), key=lambda kv: -kv[1][1])))
    costs = collective_costs(api.axis, cfg)
    if rank == 0:
        log(costs)
    # every rank takes part (the collectives); rank 0's log is the one printed;
    # the cache is the whole batch's on a mesh (its rows are the rank's)
    profile_phases(dataclasses.replace(api, init_cache=lambda b, s: api.init_cache(SERVE_BATCH, s)),
                   model, local, decode_ms)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} implied by the path")
    if out.shape != (SERVE_BATCH, MAX_NEW) or out.min() < 0 or out.max() >= cfg.vocab_size \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"generated ids out of range or logits not finite: {out.shape}")
    del eng
    if one_card:
        tp_logits, tp_toks = greedy_run(api, model, inputs, MAX_NEW, mesh)
        del model
        torch.cuda.empty_cache()
        torch.distributed.barrier()
        if rank == 0:  # the whole model on this card, from the same seed
            whole = get_api(cfg, dev)
            one = whole.init(seed=0)
            one_logits, one_toks = greedy_run(whole, one, inputs, MAX_NEW)
            r0, n = rows_of(SERVE_BATCH, mesh)
            agree = tp_toks == one_toks
            steps = agree.all(0)
            first = int(np.argmin(steps)) if not steps.all() else None
            upto = MAX_NEW if first is None else first + 1
            gap = (tp_logits[:, :upto] - one_logits[r0:r0 + n, :upto]).abs().max().item()
            log(f"greedy tokens on mesh {tuple(mesh.shape)} against the whole model on one card "
                f"(same seed): {int(agree.sum())} of {agree.size} agree; the first step at which "
                f"a row parts: {first}; the largest logit gap of rank 0's rows up to it "
                f"{gap:.4g} (max|logit| {one_logits.abs().max().item():.4g}); recorded, not held")
            del one, whole
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    return launches


def collective_costs(axis, cfg, reps: int = 50) -> str:
    """What a TP serve step's collectives cost alone over ``axis``: one
    residual all-reduce of a prefill (SERVE_BATCH x PROMPT_LEN x d, CUDA
    events, median of 20), and the host's time a call of a decode step's
    residual all-reduce (SERVE_BATCH x 1 x d) and of a norm scale's
    all-gather (d), ``reps`` calls back to back then a synchronise."""
    d, dev = cfg.d_model, torch.device("cuda", torch.cuda.current_device())
    big = torch.zeros((SERVE_BATCH, PROMPT_LEN, d), dtype=cfg.cdtype, device=dev)
    times = []
    for _ in range(23):
        torch.distributed.barrier(group=axis.group)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.distributed.all_reduce(big, group=axis.group)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    prefill_ar = statistics.median(times[3:])
    row = torch.zeros((SERVE_BATCH, 1, d), dtype=cfg.cdtype, device=dev)
    scale = torch.zeros((d // axis.size,), dtype=cfg.pdtype, device=dev)
    comm, per_call = axis.comm, {}
    axis.comm = {}  # these calls are not the path's
    for what, fn in (("all_reduce", lambda: axis.all_reduce(row.clone())),
                     ("all_gather", lambda: axis.all_gather(scale, 0))):
        fn()
        torch.cuda.synchronize()
        torch.distributed.barrier(group=axis.group)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        per_call[what] = (time.perf_counter() - t0) * 1e3 / reps
    axis.comm = comm
    n = 2 * cfg.num_layers
    return (f"collectives alone: one prefill residual all-reduce ({tuple(big.shape)}, "
            f"{big.numel() * big.element_size() / 1e6:.1f} MB) {prefill_ar:.3f} ms, x {n} = "
            f"{prefill_ar * n:.1f} ms; a decode step's, host clock a call ({reps} back to back): "
            f"all-reduce of {tuple(row.shape)} {per_call['all_reduce']:.4f} ms, all-gather of a "
            f"norm scale ({d},) {per_call['all_gather']:.4f} ms, x {n} each = "
            f"{(per_call['all_reduce'] + per_call['all_gather']) * n:.1f} ms")


def serve_tp_rank(rank: int, world: int, backend: str, workdir: str) -> int:
    """One rank of :func:`serve_tp_ranks`: the fp32 checks, then on 4 cards
    full qwen2.5-14b and deepseek-v3 cut to 4 layers in bf16 at TP 4; rank 0
    writes the launches of each path."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_card = backend == "gloo"
    cases = serve_tp_cases(world)
    init = dict(device="cuda:0" if one_card else f"cuda:{rank}",
                init_method=f"file://{workdir}/store", world_size=world, rank=rank,
                **({"backend": "gloo"} if one_card else {}))
    meshes = {}
    for _, shape, _ in cases + ([] if one_card else [(None, (1, 1, world), False)]):
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("pod", "data", "model"), **init)
    try:
        what = ("2 ranks on one card over gloo (a check, not the launcher's path)" if one_card
                else f"{world} ranks over NCCL, one a card")
        if rank == 0:
            log(f"meshes (pod, data, model) = {sorted(meshes)}, {what}")
        launched = {}
        for cfg, shape, fsdp in cases:
            launched[f"serve_tp {cfg.name} fp32 {cfg.num_layers}-layer check"
                     f"{' with fsdp' if fsdp else ''}, mesh {shape}"] = serve_tp_check(
                meshes[shape], rank, world, cfg, fsdp, sequential=one_card)
        if not one_card:
            tp = meshes[(1, 1, world)]
            qwen = configs.get_config(TP_ARCH)
            launched[f"serve_tp {qwen.name} bf16, mesh {tp.shape}"] = \
                serve_tp_full(tp, rank, world, qwen, one_card=True)
            deepseek = configs.get_config("deepseek-v3-671b").replace(
                num_layers=SERVE_LAYERS["deepseek-v3-671b"])
            launched[f"serve_tp {deepseek.name} ({deepseek.num_layers} layers) bf16, mesh "
                     f"{tp.shape}"] = serve_tp_full(tp, rank, world, deepseek)
        if rank == 0:
            with open(os.path.join(workdir, "launches.json"), "w") as f:
                json.dump(launched, f)
        return 0
    finally:
        shutdown()


TPF_RANK_TIMEOUT_S = 1500
TPF_REF_LAYERS = 2  # the fp32 checks' cut of rwkv6-1.6b and internvl2-1b, whisper-small's 2 + 2
TPF_REF_EXPERTS = 2  # jamba's fp32 check: one unit with 2 of its 16 experts (10.9 B parameters)
TPF_VLM_MESH = (1, 2, 2)  # internvl2-1b's bf16 run: its 14 query heads do not divide 4


def tp_families_ranks(cards: int, smi: str) -> dict:
    """The ``tp_families:`` phase: the model axis of rwkv6, jamba's Mamba
    mixers, whisper and the VLM, ranks each this script with
    ``--tp-families-rank`` (:func:`tp_families_rank`).  On one card two
    ranks over gloo with CUDA tensors, mesh (1, 1, 2): a check, not the
    launcher's path.  On a host of 4 or more cards four ranks over NCCL,
    one a card: the checks at (1, 1, 4) and (1, 2, 2), then the bf16 runs.
    Returns rank 0's kernel launches per path."""
    world, backend = (4, "nccl") if cards >= 4 else (2, "gloo")
    launched = spawn_ranks("--tp-families-rank", world, backend, TPF_RANK_TIMEOUT_S,
                           "tp_families")
    log(f"  {smi}")
    return launched


def tp_families_cases(world: int) -> list:
    """(config, mesh shape) of the fp32 checks: rwkv6-1.6b and internvl2-1b
    cut to TPF_REF_LAYERS layers, whisper-small to TPF_REF_LAYERS encoder
    and decoder layers (1500 frames); on 4 cards also jamba's unit with
    TPF_REF_EXPERTS experts (two such fp32 models do not fit one card), at
    (1, 1, 4) and (1, 2, 2)."""
    from repro_torch import configs

    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    rwkv = configs.get_config("rwkv6-1.6b").replace(num_layers=TPF_REF_LAYERS, **fp32)
    whisper = configs.get_config(WHISPER_ARCH).replace(
        num_layers=TPF_REF_LAYERS, encoder_layers=TPF_REF_LAYERS, **fp32)
    vlm = configs.get_config(VLM_ARCH).replace(num_layers=TPF_REF_LAYERS, **fp32)
    if world == 2:
        return [(c, (1, 1, 2)) for c in (rwkv, whisper, vlm)]
    jamba = configs.get_config(HYBRID_ARCH)
    jamba = jamba.replace(num_layers=len(jamba.block_pattern), moe=dataclasses.replace(
        jamba.moe, num_experts=TPF_REF_EXPERTS), **fp32)
    return [(c, m) for m in ((1, 1, world), (1, 2, world // 2))
            for c in (rwkv, whisper, vlm, jamba)]


def tp_families_rank(rank: int, world: int, backend: str, workdir: str) -> int:
    """One rank of :func:`tp_families_ranks`: each fp32 check serves
    (:func:`serve_tp_check`) and, but for jamba, takes one flat step with
    ZeRO-1 on 2 rows (:func:`model_axis_step_check`); then on 4 cards, in
    bf16 at full width: jamba's whole unit (8 layers, all 16 experts)
    served at TP 4, rwkv6-1.6b and whisper-small served and trained at TP
    4, internvl2-1b served and trained at (1, 2, 2).  Rank 0 writes the
    launches of each path."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, shutdown
    from repro_torch.train.trainstep import TrainHparams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_card = backend == "gloo"
    cases = tp_families_cases(world)
    init = dict(device="cuda:0" if one_card else f"cuda:{rank}",
                init_method=f"file://{workdir}/store", world_size=world, rank=rank,
                **({"backend": "gloo"} if one_card else {}))
    meshes = {}
    for _, shape in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("pod", "data", "model"), **init)
    try:
        what = ("2 ranks on one card over gloo (a check, not the launcher's path)" if one_card
                else f"{world} ranks over NCCL, one a card")
        if rank == 0:
            log(f"meshes (pod, data, model) = {sorted(meshes)}, {what}")
        launched = {}
        for cfg, shape in cases:
            cut = f"{cfg.num_layers}-layer" + (f", {cfg.moe.num_experts}-expert" if cfg.moe else "")
            launched[f"tp_families {cfg.name} fp32 {cut} serve check, mesh {shape}"] = \
                serve_tp_check(meshes[shape], rank, world, cfg, False, sequential=one_card)
            if cfg.family != "hybrid":  # jamba does not train (ROADMAP B.10)
                launched[f"tp_families {cfg.name} fp32 {cut} train check, mesh {shape}"] = \
                    model_axis_step_check(meshes[shape], rank, world, one_card, cfg,
                                          TrainHparams(zero1=True), 2)
        if not one_card:
            tp, vm = meshes[(1, 1, world)], meshes[TPF_VLM_MESH]
            jamba = configs.get_config(HYBRID_ARCH)
            jamba = jamba.replace(num_layers=len(jamba.block_pattern))
            launched[f"tp_families {jamba.name} ({jamba.num_layers} layers, "
                     f"{jamba.moe.num_experts} experts) bf16 serve, mesh {tp.shape}"] = \
                serve_tp_full(tp, rank, world, jamba)
            for cfg, mesh in ((configs.get_config("rwkv6-1.6b"), tp),
                              (configs.get_config(WHISPER_ARCH), tp),
                              (configs.get_config(VLM_ARCH), vm)):
                launched[f"tp_families {cfg.name} bf16 serve, mesh {mesh.shape}"] = \
                    serve_tp_full(mesh, rank, world, cfg, one_card=True)
                launched[f"tp_families {cfg.name} bf16 train, mesh {mesh.shape}"] = \
                    tp_train(mesh, rank, world, cfg)
        if rank == 0:
            with open(os.path.join(workdir, "launches.json"), "w") as f:
                json.dump(launched, f)
        return 0
    finally:
        shutdown()


FSDPF_RANK_TIMEOUT_S = 1500
FSDPF_REF_LAYERS = 2  # the fp32 checks' cut of rwkv6-1.6b and internvl2-1b, whisper-small's 2 + 2
FSDPF_REF_EXPERTS = 2  # jamba's fp32 checks: 2 of its 16 experts (top-2 kept)
FSDPF_CHECK_NEW = 5  # the fp32 serve checks: a prefill and 4 greedy decode steps
FSDPF_SERVE_NEW = 8  # jamba's bf16 serve run with fsdp: a prefill of 4 x 1024, 8 new tokens
FSDPF_TRAIN_EXPERTS = 2  # jamba's bf16 FSDP train run: its unit with 2 of 16 experts
FSDPF_STEPS = 6  # jamba's bf16 FSDP train run; rwkv6, whisper and internvl2 take 2


def fsdp_families_ranks(cards: int, smi: str) -> dict:
    """The ``fsdp_families:`` phase: ZeRO-3 for rwkv6, jamba, whisper and the
    VLM, ranks each this script with ``--fsdp-families-rank``
    (:func:`fsdp_families_rank`).  On one card two ranks over gloo with CUDA
    tensors, mesh (1, 2, 1): a check, not the launcher's path.  On a host of
    4 or more cards four ranks over NCCL, one a card: the checks at
    (1, 4, 1) and (1, 2, 2), then the bf16 runs at (1, 4, 1).  Returns rank
    0's kernel launches per path."""
    world, backend = (4, "nccl") if cards >= 4 else (2, "gloo")
    launched = spawn_ranks("--fsdp-families-rank", world, backend, FSDPF_RANK_TIMEOUT_S,
                           "fsdp_families")
    log(f"  {smi}")
    return launched


def fsdp_families_cases(world: int) -> list:
    """(config, mesh shape, serve, train) of the fp32 checks: rwkv6-1.6b and
    internvl2-1b cut to FSDPF_REF_LAYERS layers and whisper-small to as many
    encoder and decoder layers (1500 frames), served and trained.  jamba:
    on 4 cards (NCCL, a card a rank) its whole unit with FSDPF_REF_EXPERTS
    experts (10.9 B) served and its :func:`jamba_two_layers` cut (2.9 B: one
    fp32 AdamW reference takes 46 GB) trained, at (1, 4, 1) and (1, 2, 2).
    On one card the two gloo ranks hold what autograd keeps of the gathered
    weights twice and move every gather through the host, so jamba is cut
    to one Mamba layer with its dense MLP (1.6 B), trained at (1, 2, 1)
    (its serving with ``fsdp``, MoE routing over the DP group included, is
    held on 4 cards)."""
    from repro_torch import configs

    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    rwkv = configs.get_config("rwkv6-1.6b").replace(num_layers=FSDPF_REF_LAYERS, **fp32)
    whisper = configs.get_config(WHISPER_ARCH).replace(
        num_layers=FSDPF_REF_LAYERS, encoder_layers=FSDPF_REF_LAYERS, **fp32)
    vlm = configs.get_config(VLM_ARCH).replace(num_layers=FSDPF_REF_LAYERS, **fp32)
    jamba = configs.get_config(HYBRID_ARCH)
    moe = dataclasses.replace(jamba.moe, num_experts=FSDPF_REF_EXPERTS)
    jamba = jamba.replace(num_layers=len(jamba.block_pattern), moe=moe, **fp32)
    if world == 2:
        one = jamba.replace(num_layers=1, block_pattern=("mamba",), moe=None)
        return [(c, (1, 2, 1), True, True) for c in (rwkv, whisper, vlm)] + [
            (one, (1, 2, 1), False, True)]
    out = []
    for shape in ((1, world, 1), (1, 2, world // 2)):
        out += [(c, shape, True, True) for c in (rwkv, whisper, vlm)]
        out += [(jamba, shape, True, False), (jamba_two_layers(jamba), shape, False, True)]
    return out


def fsdpf_path(cfg, shape, what: str) -> str:
    """The name of an ``fsdp_families:`` path in the launches."""
    cut = f"{cfg.num_layers}-layer" + (f", {cfg.moe.num_experts}-expert" if cfg.moe else
                                       ", no MoE" if cfg.family == "hybrid" else "")
    return f"fsdp_families {cfg.name} fp32 {cut} {what} check, mesh {shape}"


def fsdp_serve_full(mesh, rank: int, world: int, cfg, new: int = FSDPF_SERVE_NEW) -> dict:
    """``cfg`` in bf16 with ``fsdp`` on ``mesh`` (one rank a card), batch
    SERVE_BATCH x PROMPT_LEN + ``new`` through ``ServeEngine.generate``:
    each rank holds its blocks and gathers every layer whole for each pass.
    Prefill ms, decode ms/token, tok/s and peak memory on every rank (while
    drawing and while serving), the kernels' launches against the path's,
    the DP group's calls and bytes of one prefill and of one decode step
    (against the whole model's bytes: each pass gathers every leaf once,
    the tied table twice when the logits are read), and the rank's cache
    against ``cache_specs``'.  Returns the launches."""
    from repro_torch.models import get_api
    from repro_torch.models.registry import model_class
    from repro_torch.serve.engine import ServeEngine

    dev = mesh.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api = get_api(cfg, dev, mesh=mesh, fsdp=True)
    t0 = time.perf_counter()
    model = api.init(seed=0)
    torch.cuda.synchronize()
    held = sum(p.numel() for p in model.parameters())
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    whole = model_class(cfg)(cfg, torch.device("meta"))
    whole_b = sum(p.numel() * p.element_size() for p in whole.parameters())
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, PROMPT_LEN)).astype(np.int64)
    inputs = {"tokens": tokens}
    s_max = PROMPT_LEN + new
    if rank == 0:
        log(f"{cfg.name}: {cfg.num_layers} layers, {cfg.moe.num_experts} experts, "
            f"{str(cfg.pdtype)[6:]}, fsdp: {held / 1e9:.3f} B parameters a rank of the whole "
            f"model's {sum(p.numel() for p in whole.parameters()) / 1e9:.3f} B "
            f"({whole_b / 1e9:.2f} GB), initialised in {time.perf_counter() - t0:.1f} s (peak "
            f"{init_peak:.2f} GiB while drawing); batch {SERVE_BATCH} x {PROMPT_LEN} + {new}")
    del whole
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(api, model, batch=SERVE_BATCH, s_max=s_max, mesh=mesh)
    eng.generate(dict(inputs, tokens=tokens[:, :64]), max_new_tokens=2)  # warm-up
    torch.distributed.barrier()
    tp_zero_counts()
    t0 = time.perf_counter()
    out = eng.generate(inputs, max_new_tokens=new)
    total_s = time.perf_counter() - t0
    launches = {k: n for k, n in tp_launch_counts().items() if not k.endswith("_bwd")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    t = eng.timing
    prefill_ms, decode_ms = t["prefill_s"] * 1e3, t["decode_s"] * 1e3 / t["decode_steps"]
    local = {k: torch.from_numpy(v).to(dev) for k, v in eng.local_inputs(inputs).items()}
    comm = {}
    with torch.inference_mode():
        cache = api.init_cache(SERVE_BATCH, s_max)
        api.dp.comm = {}
        logits, cache = api.prefill(model, local, cache, last_only=True)
        comm["prefill"], api.dp.comm = api.dp.comm.get(api.dp.name, {}), {}
        logits, cache = api.decode(model, logits[:, -1].argmax(-1)[:, None], cache)
        comm["decode step"] = api.dp.comm.get(api.dp.name, {})
    del cache
    peaks = [torch.zeros((), device=dev) for _ in range(world)]
    torch.distributed.all_gather(peaks, torch.tensor(peak, device=dev))
    want = {k: v for k, v in expected_launches(cfg, new=new).items() if k in launches}
    held_b, implied_b, _, by_kind = cache_bytes(api, mesh, SERVE_BATCH, s_max)
    if rank == 0:
        log(f"generated {out.shape}: prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} "
            f"ms/token, {SERVE_BATCH * new / total_s:.1f} tok/s over {total_s:.3f} s; launches "
            f"{launches} (the path's {want}); peak device memory per rank "
            f"{[round(p.item(), 2) for p in peaks]} GiB; cache {held_b:,} B a rank, cache_specs "
            f"gives {implied_b:,} B ({held_b / implied_b:.2f}x; by leaf: "
            f"{cache_multiples(by_kind)}); the DP group's collectives (calls, bytes) of one "
            f"prefill {comm['prefill']} and of one decode step {comm['decode step']} (the whole "
            f"model is {whole_b / 1e9:.2f} GB)")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} implied by the path")
    if out.shape != (SERVE_BATCH, new) or out.min() < 0 or out.max() >= cfg.vocab_size \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"generated ids out of range or logits not finite: {out.shape}")
    if held_b != implied_b:
        raise AssertionError(f"the rank's cache {held_b} B != cache_specs' {implied_b} B")
    del eng, model
    torch.cuda.empty_cache()
    return launches


def fsdp_families_rank(rank: int, world: int, backend: str, workdir: str) -> int:
    """One rank of :func:`fsdp_families_ranks`: each fp32 check serves
    FSDPF_CHECK_NEW tokens (:func:`serve_tp_check` with ``fsdp``) and takes
    one flat FSDP step (:func:`fsdp_check`); then on 4 cards, in bf16 at full
    width at (1, 4, 1): jamba's whole unit (8 layers, all 16 experts) served
    with ``fsdp`` (:func:`fsdp_serve_full`), its unit with
    FSDPF_TRAIN_EXPERTS experts trained FSDPF_STEPS flat FSDP steps (batch
    4 x 1024), then two flat FSDP steps each of rwkv6-1.6b, whisper-small
    and internvl2-1b (:func:`fsdp_train`).  Rank 0 writes the launches of
    each path."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    one_card = backend == "gloo"
    cases = fsdp_families_cases(world)
    init = dict(device="cuda:0" if one_card else f"cuda:{rank}",
                init_method=f"file://{workdir}/store", world_size=world, rank=rank,
                **({"backend": "gloo"} if one_card else {}))
    meshes = {}
    for _, shape, _, _ in cases:
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("pod", "data", "model"), **init)
    try:
        what = ("2 ranks on one card over gloo (a check, not the launcher's path)" if one_card
                else f"{world} ranks over NCCL, one a card")
        if rank == 0:
            log(f"meshes (pod, data, model) = {sorted(meshes)}, {what}")
        launched = {}
        for cfg, shape, serve_it, train_it in cases:
            if serve_it:
                launched[fsdpf_path(cfg, shape, "serve")] = serve_tp_check(
                    meshes[shape], rank, world, cfg, True, sequential=one_card,
                    new=FSDPF_CHECK_NEW)
            if train_it:
                launched[fsdpf_path(cfg, shape, "train")] = fsdp_check(
                    meshes[shape], rank, world, one_card, cfg)
            torch.cuda.empty_cache()
        if not one_card:
            mesh = meshes[(1, world, 1)]
            jamba = configs.get_config(HYBRID_ARCH)
            jamba = jamba.replace(num_layers=len(jamba.block_pattern))
            launched[f"fsdp_families {jamba.name} ({jamba.num_layers} layers, "
                     f"{jamba.moe.num_experts} experts) bf16 serve, mesh {mesh.shape}"] = \
                fsdp_serve_full(mesh, rank, world, jamba)
            two = jamba.replace(moe=dataclasses.replace(jamba.moe,
                                                        num_experts=FSDPF_TRAIN_EXPERTS))
            launched[f"fsdp_families {two.name} ({two.num_layers} layers, "
                     f"{two.moe.num_experts} experts) bf16 train, mesh {mesh.shape}"] = \
                fsdp_train(mesh, rank, world, two, FSDPF_STEPS, 1)
            for arch in ("rwkv6-1.6b", WHISPER_ARCH, VLM_ARCH):
                cfg = configs.get_config(arch)
                launched[f"fsdp_families {cfg.name} bf16 train, mesh {mesh.shape}"] = \
                    fsdp_train(mesh, rank, world, cfg, 2, 1)
                torch.cuda.empty_cache()
        if rank == 0:
            with open(os.path.join(workdir, "launches.json"), "w") as f:
                json.dump(launched, f)
        return 0
    finally:
        shutdown()


def check_rank_shapes(gen) -> dict:
    """The kernels at the shapes a rank of the model axis gives them on the
    tp_families paths, each against its plain version at the existing
    tolerances (bf16 flash attention also against its output's or its
    gradients' scale) and timed beside its bound and the library call
    (SDPA with ``enable_gqa``; ``rms_norm``): flash attention at
    whisper-small's TP-4 encoder, cross- and self-attention (3 of 12 heads)
    in serving and training, jamba's TP-4 prefill (16 / 2 heads) and
    internvl2-1b's 2 rows at (1, 2, 2) (7 / 1 heads); WKV6's chunked,
    decode-step and backward kernels at rwkv6-1.6b's TP-4 shape (8 of 32
    heads); RMSNorm and its backward at internvl2-1b's 2 rows of 256
    patches + 1024 tokens and at jamba's d 8192 (the residual stream is
    whole on every rank).  Returns {kernel: {path: times}}."""
    from repro_torch import configs
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import _forward, flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd

    whisper, vlm = configs.get_config(WHISPER_ARCH), configs.get_config(VLM_ARCH)
    rwkv, jamba = configs.get_config("rwkv6-1.6b"), configs.get_config(HYBRID_ARCH)
    enc, nv, K = whisper.encoder_seq, vlm.vision_tokens, rwkv.rwkv.head_dim
    hw, hj, hkj = whisper.num_heads // 4, jamba.num_heads // 4, jamba.num_kv_heads // 4
    hv, hkv, hr = vlm.num_heads // 2, vlm.num_kv_heads // 2, rwkv.d_model // K // 4
    prompt, text, full, bf16 = SERVE_PROMPT[WHISPER_ARCH], WHISPER_CONTEXT, dict(causal=False), \
        torch.bfloat16
    out = {}

    def held(what, kernel, got, want, tol) -> list:
        """The errors of ``got`` against ``want`` (lists of tensors): within
        ``tol`` as ``torch.allclose`` and within FLASH_BF16_SCALED of max|want|."""
        errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        tops = [w.float().abs().max().item() for w in want]
        ok = all(torch.allclose(g.float(), w.float(), atol=tol, rtol=tol) and
                 e <= FLASH_BF16_SCALED * t for g, w, e, t in zip(got, want, errs, tops))
        log(f"  {kernel} at {what}: max_abs_err " + " ".join(f"{e:.3g}" for e in errs)
            + f" (tol {tol}), of max|out| " + " ".join(f"{e / t:.3g}" for e, t in zip(errs, tops))
            + f" (tol {FLASH_BF16_SCALED:.4g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} disagrees with its plain version at {what}: {errs}")
        return errs

    for what, B, Hq, Hkv, Sq, Sk, D, kw in (  # flash attention's forward, serving
            ("whisper-small's TP-4 encoder", SERVE_BATCH, hw, hw, enc, enc, 64, full),
            ("whisper-small's TP-4 prefill cross-attention", SERVE_BATCH, hw, hw, prompt, enc,
             64, full),
            ("whisper-small's TP-4 decode-step cross-attention", SERVE_BATCH, hw, hw, 1, enc, 64,
             full),
            ("whisper-small's TP-4 decoder self-attention", SERVE_BATCH, hw, hw, prompt, prompt,
             64, {}),
            ("jamba's TP-4 prefill", SERVE_BATCH, hj, hkj, PROMPT_LEN, PROMPT_LEN,
             jamba.head_dim, {}),
            ("internvl2-1b's (1, 2, 2) prefill", SERVE_BATCH // 2, hv, hkv, nv + PROMPT_LEN,
             nv + PROMPT_LEN, 64, {})):
        q = randn(gen, (B, Sq, Hq, D), bf16).transpose(1, 2)
        k = randn(gen, (B, Sk, Hkv, D), bf16).transpose(1, 2)
        v = randn(gen, (B, Sk, Hkv, D), bf16).transpose(1, 2)
        got, want = flash_attention(q, k, v, **kw), ref.mha_reference(q, k, v, **kw)
        sync()
        err, = held(what, "flash_attention", [got], [want], TOL[bf16])
        out.setdefault("flash_attention", {})[what] = time_flash(
            dict(q=q, k=k, v=v, err=err), what, **kw)
        del q, k, v, got, want
    for what, B, Hq, Hkv, Sq, Sk, D, kw in (  # its backward, training
            ("whisper-small's TP-4 training encoder", TRAIN_BATCH, hw, hw, enc, enc, 64, full),
            ("whisper-small's TP-4 training cross-attention", TRAIN_BATCH, hw, hw, text, enc, 64,
             full),
            ("whisper-small's TP-4 training decoder self-attention", TRAIN_BATCH, hw, hw, text,
             text, 64, {}),
            ("internvl2-1b's (1, 2, 2) training", TRAIN_BATCH // 2, hv, hkv, nv + TRAIN_SEQ,
             nv + TRAIN_SEQ, 64, {})):
        q = randn(gen, (B, Sq, Hq, D), bf16).transpose(1, 2)
        k = randn(gen, (B, Sk, Hkv, D), bf16).transpose(1, 2)
        v = randn(gen, (B, Sk, Hkv, D), bf16).transpose(1, 2)
        dout = randn(gen, (B, Sq, Hq, D), bf16).transpose(1, 2)
        o, lse = _forward(q, k, v, with_lse=True,
                          **(dict(causal=True, window=None, softcap=None, scale=D ** -0.5) | kw))
        grads = flash_attention_bwd(q, k, v, o, lse, dout, **kw)
        want = ref.mha_backward_reference(q, k, v, o, lse, dout, **kw)
        sync()
        errs = held(what, "flash_attention_bwd", grads, want, BWD_TOL[bf16])
        out.setdefault("flash_attention_bwd", {})[what] = time_flash_bwd(
            (q, k, v, o, lse, dout), what, max(errs), **kw)
        del q, k, v, dout, o, lse, grads, want

    def wkv_inputs(B, T):  # rwkv6-1.6b's rank: r, k, v as the model lays them out
        r, k, v = (randn(gen, (B, T, hr, K), bf16).transpose(1, 2) for _ in range(3))
        lw = -torch.exp(randn(gen, (B, T, hr, K), torch.float32)).transpose(1, 2)
        return r, k, v, lw, randn(gen, (hr, K), torch.float32)

    for kernel, T in (("wkv6", PROMPT_LEN), ("wkv6_step", 1)):
        r, k, v, lw, u = wkv_inputs(SERVE_BATCH, T)
        s0 = randn(gen, (SERVE_BATCH, hr, K, K), torch.float32)
        y, sf = wkv6(r, k, v, lw, u, s0, out_dtype=torch.float32)
        want_y, want_s = ref.wkv6_reference(r, k, v, lw, u, s0, out_dtype=torch.float32)
        sync()
        err = (y - want_y).abs().max().item()
        s_err = (sf - want_s).abs().max().item()
        tol = WKV_TOL[torch.bfloat16]
        ok = (torch.allclose(y, want_y, atol=tol, rtol=tol)
              and torch.allclose(sf, want_s, atol=WKV_TOL[torch.float32],
                                 rtol=WKV_TOL[torch.float32]))
        log(f"  {kernel} at rwkv6-1.6b's TP-4 rank (B={SERVE_BATCH}, H={hr}, T={T}, K=V={K}): "
            f"max_abs_err y={err:.3g} (tol {tol}), state={s_err:.3g} (tol "
            f"{WKV_TOL[torch.float32]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} disagrees with its plain version: {err}, {s_err}")
        out[kernel] = {"rwkv6-1.6b's TP-4 rank": time_wkv6(
            (r, k, v, lw, u, s0), torch.float32, err, kernel, "rwkv6-1.6b's TP-4 rank")}
    r, k, v, lw, u = wkv_inputs(TRAIN_BATCH, TRAIN_SEQ)
    args = (r, k, v, lw, u, torch.zeros((TRAIN_BATCH, hr, K, K), device=DEVICE),
            randn(gen, (TRAIN_BATCH, TRAIN_SEQ, hr, K), torch.float32).transpose(1, 2), None)
    errs, abs_err, ok = wkv6_grads_err(wkv6_bwd(*args), ref.wkv6_backward_reference(*args), r)
    log(f"  wkv6_bwd at rwkv6-1.6b's TP-4 training rank (B={TRAIN_BATCH}, H={hr}, "
        f"T={TRAIN_SEQ}, K=V={K}): " + " ".join(
            f"{n}={e:.3g}" for n, e in zip(("dr", "dk", "dv", "dlog_w", "du", "ds0"), errs))
        + f" (relative to max|g|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"wkv6_bwd disagrees with its plain version: {errs}")
    out["wkv6_bwd"] = {"rwkv6-1.6b's TP-4 training rank": time_wkv6_bwd(
        args, abs_err, "rwkv6-1.6b's TP-4 training rank")}

    for kernel, what, rows, d in (
            ("rmsnorm", "internvl2-1b's (1, 2, 2) prefill rows", SERVE_BATCH // 2 * (nv + PROMPT_LEN),
             vlm.d_model),
            ("rmsnorm", "jamba's TP-4 prefill rows", SERVE_BATCH * PROMPT_LEN, jamba.d_model),
            ("rmsnorm_bwd", "internvl2-1b's (1, 2, 2) training rows",
             TRAIN_BATCH // 2 * (nv + TRAIN_SEQ), vlm.d_model)):
        x, g, sc = randn(gen, (rows, d), bf16), randn(gen, (rows, d), bf16), randn(gen, (d,), bf16)
        tol = TOL[bf16] if kernel == "rmsnorm" else BWD_TOL[bf16]
        if kernel == "rmsnorm":
            got, want = [rmsnorm(x, sc)], [ref.rmsnorm_reference(x, sc)]
            nbytes, flops = 2 * x.numel() * 2 + d * 2, 4.0 * x.numel()
            fn, plain = (lambda: rmsnorm(x, sc)), (lambda: ref.rmsnorm_reference(x, sc))
            library = (lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-6))
        else:
            got, want = rmsnorm_bwd(x, sc, g), ref.rmsnorm_backward_reference(x, sc, g)
            nbytes, flops = 3 * x.numel() * 2 + 2 * d * 2, 11.0 * x.numel()
            xl, sl = x.detach().requires_grad_(), sc.detach().requires_grad_()
            y = F.rms_norm(xl, (d,), weight=sl, eps=1e-6)
            fn, plain = (lambda: rmsnorm_bwd(x, sc, g)), \
                (lambda: ref.rmsnorm_backward_reference(x, sc, g))
            library = (lambda: torch.autograd.grad(y, (xl, sl), g, retain_graph=True))
        sync()
        errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
        # dscale sums `rows` products: its tolerance scales with its largest entry
        ok = all(torch.allclose(a.float(), b.float(), atol=tol * top, rtol=tol)
                 for a, b, top in zip(got, want, [1.0, want[-1].float().abs().max().item()]))
        log(f"  {kernel} at {what} ({rows}, {d}) bf16: max_abs_err "
            + " ".join(f"{e:.3g}" for e in errs) + f" (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} disagrees with its plain version at {what}: {errs}")
        bound_ms, bound_by = bound(nbytes, flops, bf16)
        t = dict(max_abs_err=max(errs), ms=time_ms(fn), plain_ms=time_ms(plain),
                 library_ms=time_ms(library), bound_ms=bound_ms, bound_by=bound_by)
        log(f"  {kernel} at {what}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}")
        out.setdefault(kernel, {})[what] = t
    return out


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


def dist_phase(gemma, smi: str, single_ms) -> dict:
    """The ``dist:`` phase: the world-1 references, full gemma-2b in bf16
    through the hierarchical step, the multi-rank check.  Returns the
    launches of the bf16 run."""
    check_dist_reference(gemma, smi)
    torch.cuda.empty_cache()
    release_host_memory()
    launched = dist_train(gemma, smi, single_ms)
    torch.cuda.empty_cache()
    dist_ranks(torch.cuda.device_count())
    return launched


_PHASE = {"name": None, "t0": time.perf_counter(), "start": time.perf_counter()}


def phase(name) -> None:
    """Start phase ``name`` (None: the end of the run) after a line with the
    seconds the previous phase took and the run so far (host clock)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        log(f"  ({_PHASE['name']} phase {now - _PHASE['t0']:.1f} s; the run so far "
            f"{now - _PHASE['start']:.1f} s)")
    if name is not None:
        log(f"{name}:")
    _PHASE.update(name=name, t0=now)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("dist", "ranks", "tp", "fsdp", "serve_tp", "tp_families",
                                       "fsdp_families"),
                    help="the device and build phases, then only the dist phase, its "
                         "multi-rank check, the tp phase, the fsdp phase, the serve_tp "
                         "phase, the tp_families phase (with its kernels' rank shapes) or "
                         "the fsdp_families phase (with the selective-scan kernels)")
    ap.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)  # a rank of dist_ranks
    ap.add_argument("--dist-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", help=argparse.SUPPRESS)
    ap.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)  # a rank of tp_ranks
    ap.add_argument("--fsdp-rank", type=int, help=argparse.SUPPRESS)  # a rank of fsdp_ranks
    ap.add_argument("--serve-tp-rank", type=int, help=argparse.SUPPRESS)  # of serve_tp_ranks
    ap.add_argument("--tp-families-rank", type=int, help=argparse.SUPPRESS)  # of tp_families_ranks
    ap.add_argument("--fsdp-families-rank", type=int, help=argparse.SUPPRESS)  # of fsdp_families
    ap.add_argument("--rank-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank-backend", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    if args.dist_rank is not None:
        return dist_rank(args.dist_rank, args.dist_world, args.dist_dir)
    if args.tp_rank is not None:
        return tp_rank(args.tp_rank, args.rank_world, args.rank_backend, args.dist_dir)
    if args.fsdp_rank is not None:
        return fsdp_rank(args.fsdp_rank, args.rank_world, args.rank_backend, args.dist_dir)
    if args.serve_tp_rank is not None:
        return serve_tp_rank(args.serve_tp_rank, args.rank_world, args.rank_backend,
                             args.dist_dir)
    if args.tp_families_rank is not None:
        return tp_families_rank(args.tp_families_rank, args.rank_world, args.rank_backend,
                                args.dist_dir)
    if args.fsdp_families_rank is not None:
        return fsdp_families_rank(args.fsdp_families_rank, args.rank_world, args.rank_backend,
                                  args.dist_dir)
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

    phase("build")
    t0 = time.perf_counter()
    times = build.build_all()
    log(f"  built {sorted(times)} in {time.perf_counter() - t0:.1f} s")
    for source in sorted(times):
        for line in ptxas_report(build.build_log(source)):
            log(f"    {source}: {line}")

    gemma, rwkv = (configs.get_config(a) for a in ARCHS)
    if args.only:
        phase(args.only if args.only in ("tp", "fsdp", "serve_tp", "tp_families",
                                         "fsdp_families") else "dist")
        if args.only == "fsdp_families":
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            log(json.dumps({"selective_scan": check_selective_scan(
                gen, configs.get_config(HYBRID_ARCH))}))
            del gen
            torch.cuda.empty_cache()
            fsdp_families_ranks(torch.cuda.device_count(), smi)
        elif args.only == "tp_families":
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            log(json.dumps({"rank_shapes": check_rank_shapes(gen)}))
            del gen
            torch.cuda.empty_cache()
            tp_families_ranks(torch.cuda.device_count(), smi)
        elif args.only == "dist":
            dist_phase(gemma, smi, None)
        elif args.only == "tp":
            tp_ranks(torch.cuda.device_count(), smi)
        elif args.only == "fsdp":
            fsdp_ranks(torch.cuda.device_count(), smi)
        elif args.only == "serve_tp":
            serve_tp_ranks(torch.cuda.device_count(), smi)
        else:
            dist_ranks(torch.cuda.device_count())
        phase(None)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
        return 0
    deepseek, grok = (configs.get_config(a).replace(num_layers=SERVE_LAYERS[a])
                      for a in MOE_ARCHS)
    jamba = configs.get_config(HYBRID_ARCH)
    jamba = jamba.replace(num_layers=SERVE_LAYERS[HYBRID_ARCH], moe=dataclasses.replace(
        jamba.moe, num_experts=SERVE_EXPERTS[HYBRID_ARCH]))
    whisper, internvl2 = configs.get_config(WHISPER_ARCH), configs.get_config(VLM_ARCH)
    gemma2, qwen = configs.get_config(FSDP_ARCH), configs.get_config(TP_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    phase("kernels")
    floor_ms = launch_floor_ms()
    log(f"  launch floor: one launch of a one-element kernel (add_) takes {floor_ms:.4f} ms "
        f"in time_ms's window")
    kernels = [check_flash(gen), check_rmsnorm(gen, gemma.d_model), *check_wkv6(gen, rwkv),
               check_flash_bwd(gen), check_rmsnorm_bwd(gen, gemma.d_model),
               check_wkv6_bwd(gen, rwkv), *check_selective_scan(gen, jamba)]
    rank_shapes = check_rank_shapes(gen)
    for k in kernels:
        k["launch_floor_ms"] = floor_ms
        k["at_model_axis_ranks"] = rank_shapes.get(k["name"], {})
    torch.cuda.empty_cache()
    phase("reference")
    for cfg, cut, full_depth in (
            (gemma, "2-layer", False), (rwkv, "2-layer", False),
            (gemma2, "2-layer (one local and one global layer)", False),
            (moe_reference_config(deepseek),
             "cut to 2 layers (first_dense 1) and 16 experts (top-8 kept),", False),
            (hybrid_reference_config(jamba),
             "cut to 2 layers (its attention layer and a Mamba layer with MoE) and 3 experts "
             "(top-2 kept),", False),
            (whisper.replace(num_layers=REF_LAYERS, encoder_layers=REF_LAYERS),
             "cut to 2 encoder + 2 decoder layers (1500 frames),", True),
            (internvl2, "2-layer (256 patches)", False)):
        check_reference(cfg, cut, full_depth)
        torch.cuda.empty_cache()
        release_host_memory()
    deepseek_train, grok_train = (moe_train_config(configs.get_config(a)) for a in MOE_ARCHS)
    for cfg, cut in ((gemma.replace(num_layers=2), "2-layer"),
                     (rwkv.replace(num_layers=2), "2-layer"),
                     (gemma2.replace(num_layers=FSDP_REF_LAYERS), "2-layer (one local and one "
                                                                  "global layer)"),
                     (whisper.replace(num_layers=REF_LAYERS, encoder_layers=REF_LAYERS),
                      "cut to 2 encoder + 2 decoder layers"),
                     (internvl2.replace(num_layers=REF_LAYERS), "2-layer"),
                     (one_moe_layer(deepseek_train), moe_cut(one_moe_layer(deepseek_train))),
                     (grok_train, moe_cut(grok_train))):
        check_train_reference(cfg, cut)
        torch.cuda.empty_cache()
        release_host_memory()
    phase("serve")
    runs = {}
    for cfg in (gemma, rwkv, deepseek, grok, jamba, whisper, internvl2, gemma2, qwen):
        torch.cuda.reset_peak_memory_stats()
        runs[cfg.name] = serve(cfg)
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    phase("train")
    trained, step_ms = {}, {}
    for cfg, cut in ((gemma, ""), (rwkv, ""), (whisper, ""), (internvl2, ""),
                     (deepseek_train, moe_cut(deepseek_train)), (grok_train, moe_cut(grok_train))):
        torch.cuda.empty_cache()
        path = f"train {cfg.name}" + (f" ({cfg.num_layers} layers, {cfg.moe.num_experts} experts)"
                                      if cut else "")
        trained[path], step_ms[cfg.name] = train(cfg, cut)
    phase("launcher")
    torch.cuda.empty_cache()
    launched = launcher(rwkv)
    phase("dist")
    torch.cuda.empty_cache()
    launched[f"dist {gemma.name}"] = dist_phase(gemma, smi, step_ms[gemma.name])
    phase("tp")
    torch.cuda.empty_cache()
    launched.update(tp_ranks(torch.cuda.device_count(), smi))
    phase("fsdp")
    torch.cuda.empty_cache()
    launched.update(fsdp_ranks(torch.cuda.device_count(), smi))
    phase("serve_tp")
    torch.cuda.empty_cache()
    launched.update(serve_tp_ranks(torch.cuda.device_count(), smi))
    phase("tp_families")
    torch.cuda.empty_cache()
    launched.update(tp_families_ranks(torch.cuda.device_count(), smi))
    phase("fsdp_families")
    torch.cuda.empty_cache()
    launched.update(fsdp_families_ranks(torch.cuda.device_count(), smi))
    # each kernel's launches in the run of the path that drives it; the
    # forward kernels run in serving and training alike
    paths = {f"serve {gemma.name}": runs[gemma.name], f"serve {rwkv.name}": runs[rwkv.name],
             f"serve {deepseek.name} ({deepseek.num_layers} layers)": runs[deepseek.name],
             f"serve {grok.name} ({grok.num_layers} layers)": runs[grok.name],
             f"serve {jamba.name} ({jamba.num_layers} layers, {jamba.moe.num_experts} experts)":
                 runs[jamba.name],
             f"serve {whisper.name}": runs[whisper.name],
             f"serve {internvl2.name}": runs[internvl2.name],
             f"serve {gemma2.name}": runs[gemma2.name],
             f"serve {qwen.name}": runs[qwen.name],
             **trained, **launched}
    driven_by = {"flash_attention": f"serve {gemma.name}", "rmsnorm": f"serve {gemma.name}",
                 "wkv6": f"serve {rwkv.name}", "wkv6_step": f"serve {rwkv.name}",
                 "flash_attention_bwd": f"train {gemma.name}",
                 "rmsnorm_bwd": f"train {gemma.name}", "wkv6_bwd": f"train {rwkv.name}",
                 "selective_scan": f"serve {jamba.name} ({jamba.num_layers} layers, "
                                   f"{jamba.moe.num_experts} experts)",
                 "selective_scan_bwd": next(
                     fsdpf_path(c, shape, "train") for c, shape, _, train_it in
                     fsdp_families_cases(4 if torch.cuda.device_count() >= 4 else 2)
                     if c.family == "hybrid" and train_it)}
    for k in kernels:
        k["launches"] = paths[driven_by[k["name"]]].get(k["name"], 0)
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths.items() if n.get(k["name"])}
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on its path "
                                 f"{driven_by[k['name']]!r}")
    phase(None)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
