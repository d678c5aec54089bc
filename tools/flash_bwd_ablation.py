"""Where the bf16 flash-attention backward spends its time, by ablation.

    python3 tools/flash_bwd_ablation.py [OTHER.cu ...]     # on one NVIDIA GPU

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
with one part of both bf16 kernels' tile loops (``flash_bwd_dq_mma_kernel``
and ``flash_bwd_dkdv_mma_kernel``) cut out, and times each at gemma-2b's
training shape (B=4, Hq=8, Hkv=1, S=1024, D=256, causal): the whole call
with ``chip_smoke.time_ms`` (median of 30 calls with CUDA events, the L2
flushed before each) and each launch with ``chip_smoke.bwd_launch_split``
(torch.profiler over 5 back-to-back calls).  The variants compute wrong
results: they are timing builds only, and nothing else uses them.

- ``full``: the kernels as they are (timed first and last, for the spread);
- ``no_scores``: no S / dP products (phase 1 keeps its elementwise work on
  zeros);
- ``no_softmax``: no scale, mask, exp or dS formula (the raw products, in
  dQ their sum, go to shared memory);
- ``no_accumulate``: no dQ / dK / dV products (phase 2);
- ``no_next_load``: only the first tile of the walk is copied to shared
  memory;
- each ``OTHER.cu`` given: another version of the source with the same C
  entry (another checkout's, such as the parent commit's), built and timed
  as it is, so that two versions are compared within one call.
"""
from __future__ import annotations

import ctypes
import importlib
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
from chip_smoke import TRAIN_BATCH, TRAIN_SEQ, bwd_launch_split, randn, time_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")

SCORES = "for (int kk = 0; kk < D / 16; ++kk) {\n    uint32_t af"  # both mma_scores
ACCUMULATE = "for (int kk = 0; kk < TILE / 16; ++kk) {\n    uint32_t af[A::MT][4];"
SOFTMAX_DQ = "        p_ds2(p, ok, s[j][e], dp[j][e], lse2[r], dlt[r], pr, s[j][e]);  // s := dS\n"
SOFTMAX_DKDV = ("        p_ds2(p, ok, s[j][e], dp[j][e], lse_t[c] * LOG2E, dl_t[c], s[j][e], "
                "dp[j][e]);  // P^T, dS^T\n")
NEXT_DQ = "if (kt + 1 < kt_end) {  // the next tile goes into the other buffer"
NEXT_DKDV = "if (qt + 1 < qt_end) {\n      stage(qt + 1, buf ^ 1);"


def variants(src: str) -> dict:
    for marker in (SCORES, ACCUMULATE, SOFTMAX_DQ, SOFTMAX_DKDV, NEXT_DQ, NEXT_DKDV):
        if marker not in src:
            raise RuntimeError(f"a marker is no longer in the source: {marker!r}")
    return {
        "full": src,
        "no_scores": src.replace(SCORES, SCORES.replace("kk < D / 16", "kk < 0")),
        # dQ keeps dP alive (its dS is the only use of dP there)
        "no_softmax": src.replace(SOFTMAX_DQ, "        s[j][e] += dp[j][e];\n").replace(
            SOFTMAX_DKDV, ""),
        "no_accumulate": src.replace(ACCUMULATE, ACCUMULATE.replace("kk < TILE / 16", "kk < 0")),
        "no_next_load": src.replace(NEXT_DQ, "if (kt < -1) {").replace(
            NEXT_DKDV, NEXT_DKDV.replace("qt + 1 < qt_end", "qt < -1")),
    }


def build_variants(texts: dict, out_dir: str) -> dict:
    """Compile every variant in parallel; returns {name: library path}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = lib
    return libs


def time_variants(libs: dict) -> None:
    """Print each variant's time at the training shape, ``full`` first and last."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, Hq, Hkv, S, D = TRAIN_BATCH, 8, 1, TRAIN_SEQ, 256
    q = randn(gen, (B, S, Hq, D), torch.bfloat16).transpose(1, 2)
    k, v = (randn(gen, (B, S, Hkv, D), torch.bfloat16).transpose(1, 2) for _ in range(2))
    dout = randn(gen, (B, S, Hq, D), torch.bfloat16).transpose(1, 2)
    out, lse = fa._forward(q, k, v, causal=True, window=None, softcap=None, scale=D ** -0.5,
                           with_lse=True)
    args = (q, k, v, out, lse, dout)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; flash_attention_bwd at B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} bf16 causal")
    for name in ["full", *(n for n in libs if n != "full"), "full"]:
        fa.load_library = lambda _name, path=libs[name]: ctypes.CDLL(path)
        fa._bind_bwd.cache_clear()
        ms = time_ms(lambda: fa.flash_attention_bwd(*args))
        split = bwd_launch_split(args)
        print(f"  {name}: {ms:.4f} ms; by launch: "
              + ", ".join(f"{n} {t:.4f}" for n, t in split.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    texts = variants((build.CSRC / "flash_attention_bwd.cu").read_text())
    for i, path in enumerate(sys.argv[1:]):
        with open(path) as f:
            texts[f"other{i}"] = f.read()
        print(f"other{i}: {path}")
    time_variants(build_variants(texts, os.path.join(ROOT, "build", "bwd_ablation")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
