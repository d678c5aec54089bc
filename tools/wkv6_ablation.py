"""Where the WKV6 kernels spend their time, by ablation.

    python3 tools/wkv6_ablation.py [OTHER.cu ...]     # on one NVIDIA GPU

Builds variants of ``src/repro_torch/kernels/csrc/wkv6.cu`` and times each
at the rwkv6-1.6b prefill shape (B=4, H=32, T=1024, K=V=64, bf16 r/k/v,
fp32 y), at its decode step (T=1) and at two short prompts (T=2, 31) with
``chip_smoke.time_ms`` (median of 30 calls with CUDA events, the L2 flushed
before each), every variant twice, in the order A, B, .., B, A.
Each OTHER.cu, another version of the source (such as the parent
commit's), is built and timed beside them under its file's stem.

- ``full``: the kernels as they are;
- ``step_warps2``, ``step_warps4``: the decode step's blocks of 2 or 4
  warps (256 or 128 blocks at the decode shape: 4 is one block per (b, h)),
  against the source's one warp (512 blocks);
- ``straight_line``: the decode step's arithmetic as straight-line code,
  not inside its loop over the call's one token;
- ``bv16``, ``bv32``: 16 or 32 state columns per block (512 or 256 blocks,
  against the kernel's 64 and 128 at K = 64);
- ``no_diag``: no elementwise entries of A's diagonal blocks;
- ``no_prep_exp``: the chunk's operands scaled without ``expf``;
- ``no_prep``: no fp32 operands made from the staged chunk at all;
- ``no_mma``: no tensor-core products (and no operand splits);
- ``no_next_load``: only the first chunk is staged;
- ``chunk_only``: every length goes to the chunked kernel, so its T=1, 2
  and 31 columns time the chunked kernel there (in every other variant
  T < 32 runs the decode kernels);
- ``cl_reordered``: each token's cl summed in another order than cl_C and g,
  so that they disagree by a rounding.

For the variants that compute WKV6 (``full``, ``step_warps*``, ``straight_line``, ``bv*``,
``chunk_only``, ``cl_reordered`` and each OTHER.cu) it also prints the largest error
of y and of the final state against ``ref.wkv6_reference`` at the prefill
shape and at the decode step.  The other
variants compute wrong results: they are timing builds only, and nothing
else uses them.
"""
from __future__ import annotations

import ctypes
import importlib
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
from chip_smoke import ptxas_report, time_ms  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402

wk = importlib.import_module("repro_torch.kernels.wkv6")

STEP_WARPS = "constexpr int STEP_WARPS = 1;"
STEP_LOOP = "  for (int t = 0; t < p.T; ++t) {\n    float y[4] = {}, a = 0.f;"
BV = "constexpr int MAX_BV = 64;"
DIAG = "    {  // A's diagonal blocks on the CUDA cores"
PREP = ("{  // fp32 operands of the chunk", "__syncthreads();  // operands ready")
MMA = re.compile(r'asm volatile\(\n\s*"mma\.sync.*?\);\n', re.S)
NEXT_LOAD = "if (c + 1 < n_chunks) fetch(t0 + C);"
STEP = "  if (p.T < C) return launch_step<T, TY, K>(p, B, stream);\n"
CL = "cl[i] = pre + inner[i];"
RIGHT = ("full", "step_warps2", "step_warps4", "straight_line", "bv16", "bv32", "chunk_only",
         "cl_reordered")  # variants that compute WKV6, with every OTHER.cu


def variants(src: str, others: dict) -> dict:
    i, j = src.index(PREP[0]), src.index(PREP[1])
    out = {
        "full": src,
        "step_warps2": src.replace(STEP_WARPS, STEP_WARPS.replace("1", "2")),
        "step_warps4": src.replace(STEP_WARPS, STEP_WARPS.replace("1", "4")),
        "straight_line": src.replace(STEP_LOOP, STEP_LOOP.replace(
            "for (int t = 0; t < p.T; ++t) ", "")),
        "bv16": src.replace(BV, BV.replace("64", "16")),
        "bv32": src.replace(BV, BV.replace("64", "32")),
        "no_diag": src.replace(DIAG, DIAG.replace("{", "if (warp < -1) {")),
        "no_prep_exp": src[:i] + src[i:j].replace("expf(", "(") + src[j:],
        "no_prep": src[:i] + "if (c < 0) " + src[i:],
        "no_mma": MMA.sub("", src),
        "no_next_load": src.replace(NEXT_LOAD, ""),
        "chunk_only": src.replace(STEP, ""),
        "cl_reordered": src.replace(CL, "cl[i] = (i ? cl[i - 1] : pre) + lws[i];"),
    }
    for name, text in out.items():
        if name != "full" and text == src:
            raise RuntimeError(f"variant {name}: its marker is no longer in the source")
    return {**out, **others}


def build_variants(src: str, out_dir: str, others: dict) -> dict:
    """Compile every variant in parallel; returns {name: (library path, log)}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variants(src, others).items():
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
        libs[name] = (lib, log)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_ablation: no CUDA device", file=sys.stderr)
        return 1
    src = (build.CSRC / "wkv6.cu").read_text()
    others = {os.path.splitext(os.path.basename(p))[0]: open(p).read() for p in sys.argv[1:]}
    libs = build_variants(src, os.path.join(ROOT, "build", "ablation_wkv6"), others)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, K = 4, 32, 64
    inputs = {}
    for T in (1024, 1, 2, 31):
        r, k, v = (torch.randn((B, T, H, K), generator=gen, device="cuda").bfloat16()
                   .transpose(1, 2) for _ in range(3))
        lw = -torch.exp(torch.randn((B, T, H, K), generator=gen, device="cuda")).transpose(1, 2)
        u = torch.randn((H, K), generator=gen, device="cuda")
        s0 = torch.randn((B, H, K, K), generator=gen, device="cuda")
        inputs[T] = (r, k, v, lw, u, s0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; B={B} H={H} K=V={K}, bf16 r/k/v, fp32 y, ms per call")
    one, s0 = torch.zeros(1, device="cuda"), inputs[1][5]
    copy = torch.empty_like(s0)
    print(f"  floors: one launch of a one-element kernel {time_ms(lambda: one.add_(1.0)):.4f}, "
          f"a copy of the decode step's state {time_ms(lambda: copy.copy_(s0)):.4f}")
    for name in [*libs, *reversed(list(libs))]:  # each twice, in turns
        path, log = libs[name]
        wk.load_library = lambda _name, path=path: ctypes.CDLL(path)
        wk._bind.cache_clear()
        row = [f"T={T} {time_ms(lambda: wk.wkv6(*x, out_dtype=torch.float32)):.4f}"
               for T, x in inputs.items()]
        for T in (1024, 1) if name in RIGHT or name in others else ():
            y, s = wk.wkv6(*inputs[T], out_dtype=torch.float32)
            want_y, want_s = ref.wkv6_reference(*inputs[T], out_dtype=torch.float32)
            row.append(f"T={T} err y {(y - want_y).abs().max().item():.2e} "
                       f"state {(s - want_s).abs().max().item():.2e}")
        regs = [line for line in ptxas_report(log) if line.startswith(
            ("wkv6_chunk_kernel<bf16,f32,64>", "wkv6_step_kernel<bf16,f32,64"))]
        print(f"  {name:13s} " + "  ".join(row) + f"   [{'; '.join(regs)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
