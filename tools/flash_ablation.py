"""Where the bf16 flash-attention kernel spends its time, by ablation.

    python3 tools/flash_ablation.py        # on one NVIDIA GPU

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
one part of the bf16 (tensor-core) kernel's kv loop cut out, and times each
at the gemma-2b prefill shape (B=4, Hq=8, Hkv=1, S=1024, D=256, causal) and
at D=128 (B=4, H=16, S=1024), with ``chip_smoke.time_ms`` (median of 30
calls with CUDA events, the L2 flushed before each).  The variants compute wrong results: they are timing
builds only, and nothing else uses them.

- ``full``: the kernel as it is (timed first and last, for the spread);
- ``no_next_load``: only the first kv tile is copied to shared memory;
- ``no_loads``: no K/V tile is copied at all;
- ``no_softmax``: no scale, mask or online softmax (raw scores go to P V);
- ``no_pv``: no P V product;
- ``loads_only``: no softmax and no P V, so the compiler drops Q K^T too.
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
from chip_smoke import time_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")

NEXT_LOAD = "if (kt + 1 < kt_end) {"
FIRST_LOAD = "  if (kt_begin < kt_end) {\n    load_tile(Ks"
SOFTMAX = "    // scale and softcap in fp32, in log2"
PV = "    // O += P V, P in bf16"
LOOP_END = "    __syncthreads();  // every warp is done with this buffer"
NEVER = "if (kt < -1) {"


def _cut(src: str, start: str, end: str) -> str:
    i, j = src.index(start), src.index(end)
    return src[:i] + src[j:]


def variants(src: str) -> dict:
    out = {
        "full": src,
        "no_next_load": src.replace(NEXT_LOAD, NEVER),
        "no_loads": src.replace(NEXT_LOAD, NEVER).replace(FIRST_LOAD, FIRST_LOAD.replace(
            "kt_begin < kt_end", "kt_begin < -1")),
        "no_softmax": _cut(src, SOFTMAX, PV),
        "no_pv": _cut(src, PV, LOOP_END),
        "loads_only": _cut(src, SOFTMAX, LOOP_END),
    }
    for name, text in out.items():
        if name != "full" and text == src:
            raise RuntimeError(f"variant {name}: its marker is no longer in the source")
    return out


def build_variants(src: str, out_dir: str) -> dict:
    """Compile every variant in parallel; returns {name: library path}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 1
    src = (build.CSRC / "flash_attention.cu").read_text()
    libs = build_variants(src, os.path.join(ROOT, "build", "ablation"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(4, 8, 1, 1024, 256), (4, 16, 16, 1024, 128)]  # B, Hq, Hkv, S, D
    inputs = [[torch.randn((B, S, H, D), generator=gen, device="cuda").bfloat16().transpose(1, 2)
               for H in (Hq, Hkv, Hkv)] for B, Hq, Hkv, S, D in shapes]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; bf16 causal, ms per call")
    for name in [*libs, "full"]:
        fa.load_library = lambda _name, path=libs[name]: ctypes.CDLL(path)
        fa._bind.cache_clear()
        row = [f"D={s[4]} {time_ms(lambda: fa.flash_attention(q, k, v)):.4f}"
               for s, (q, k, v) in zip(shapes, inputs)]
        print(f"  {name:13s} " + "  ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
