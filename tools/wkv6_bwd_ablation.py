"""Where the WKV6 backward spends its time, by ablation.

    python3 tools/wkv6_bwd_ablation.py [OTHER.cu ...]     # on one NVIDIA GPU

Builds variants of ``src/repro_torch/kernels/csrc/wkv6_bwd.cu`` and times
each at the rwkv6-1.6b training shape (B=4, H=32, T=1024, K=V=64, bf16
r/k/v, fp32 dy, zero s0, no gradient of the final state, as the model calls
it) with ``chip_smoke.time_ms`` (median of 30 calls with CUDA events, the L2
flushed before each), every variant twice, in the order A, B, .., B, A.  Each
OTHER.cu, another version of the source (such as the parent commit's), is
built and timed beside them under its file's stem; a source without
``wkv6_bwd_scratch_floats`` is called with the one-launch design's
arguments (no scratch).

- ``full``: the three launches as they are (64 state columns a sweep block);
- ``bv16``, ``bv32``: 16 or 32 state columns a sweep block;
- ``sweeps_only``: the two state sweeps alone;
- ``chunk_only``: the chunk kernel alone (on the edges of an earlier call);
- ``no_intra``: all three launches, the chunk kernel without the walks of
  its diagonal blocks (A's diagonal blocks and the intra terms of dr and dk);
- ``no_products``: all three launches, the chunk kernel without its
  products with S_in and G_out (and A^T dy);
- ``no_input_loads``, ``no_edge_loads``: all three launches, the chunk
  kernel without loading its chunk's inputs (r, k, v, dy, log_w) or its
  edge states (S_in, G_out).

Then it builds the source once more with a clock read by thread 0 of every
chunk-kernel block at each of its barriers, runs it once at the same shape
and prints the mean cycles of each phase over the blocks.

For ``full``, ``bv16``, ``bv32`` and each OTHER.cu it also prints the
largest error of each gradient against ``ref.wkv6_backward_reference``,
relative to the gradient's largest entry.  The other variants compute wrong
results: they are timing builds only, and nothing else uses them.
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
from wkv6_ablation import build_variants  # noqa: E402

wk = importlib.import_module("repro_torch.kernels.wkv6")

BV = "constexpr int SWEEP_BV = 64;"
SWEEP, CHUNK, CARRY = "sweep_k<<<", "chunk_k<<<", "wkv6_bwd_carry_kernel<K><<<"
WALKS = ("const int rows = ts | 3;", "cols = SUB - 1 - (ts & ~3);")
PRODUCTS = "const bool prod = warp % 4 < NQ;"
INPUTS = ("  if constexpr (T_BF) {\n    stage<T, K, CHUNK_THREADS>(Tr,",
          "  stage<float, K, CHUNK_THREADS>(Ws, LDK, wb, p.st[W_][2], t0, p.T, p.aligned, tid);\n")
EDGES = "for (int i = tid; i < K * K / 4; i += CHUNK_THREADS) {"
PHASES = ("the chunk's inputs", "the operands in fp32 and log_w's part sums",
          "cl, w and the scaled operands", "dA and A's off-diagonal block", "the walks (and S_in, G_out landed)",
          "dr's and dk's products", "their epilogue and dv's stores", "dr, dk, Q and R",
          "the scan's part totals", "dlog_w and the summaries")
RIGHT = ("full", "bv16", "bv32")  # variants that compute the gradients, with every OTHER.cu
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")


def skip(src: str, *launches: str) -> str:
    for marker in launches:
        src = src.replace(marker, f"if (p.T < 0) {marker}")
    return src


def variants(src: str, others: dict) -> dict:
    for marker in (BV, SWEEP, CHUNK, CARRY, *WALKS, PRODUCTS, *INPUTS, EDGES):
        if src.count(marker) != 1:
            raise RuntimeError(f"the marker {marker!r} is no longer once in the source")
    out = {
        "full": src,
        "bv16": src.replace(BV, BV.replace("64", "16")),
        "bv32": src.replace(BV, BV.replace("64", "32")),
        "sweeps_only": skip(src, CHUNK, CARRY),
        "chunk_only": skip(src, SWEEP, CARRY),
        "no_intra": src.replace(WALKS[0], "const int rows = p.T < 0 ? (ts | 3) : 0;")
                       .replace(WALKS[1], "cols = p.T < 0 ? SUB - 1 - (ts & ~3) : 0;"),
        "no_products": src.replace(PRODUCTS, PRODUCTS.replace("= ", "= p.T < 0 && ")),
        "no_input_loads": src.replace(INPUTS[0], "  if ((p.T) < 0) {\n" + INPUTS[0])
                             .replace(INPUTS[1], INPUTS[1] + "  }\n"),
        "no_edge_loads": src.replace(EDGES, EDGES.replace("i < K", "(p.T) < 0 && i < K")),
    }
    return {**out, **others}


def clocked(src: str) -> str:
    """The source with clock64() read by thread 0 of every chunk-kernel block
    at its start, at each barrier and at its end, into a device array that
    ``wkv6_bwd_clocks`` copies out (16 slots a block)."""
    start = src.index("wkv6_bwd_chunk_kernel(const Params p) {")
    end = src.index("// 3. the carry of dlog_w across chunks")
    body, marks = src[start:end], iter(range(1, 16))
    body = re.sub(r"__syncthreads\(\);", lambda _: "__syncthreads(); if (threadIdx.x == 0) "
                  f"clocks[blk * 16 + {next(marks)}] = clock64();", body)
    body = body.replace("wkv6_bwd_chunk_kernel(const Params p) {", """wkv6_bwd_chunk_kernel(const Params p) {
  const long long blk = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) clocks[blk * 16] = clock64();""", 1)
    last = body.rindex("\n}\n")
    body = (body[:last] + f"\n  if (threadIdx.x == 0) clocks[blk * 16 + {next(marks)}] = clock64();\n}}\n"
            + body[last + 3:])
    out = src[:start] + body + src[end:]
    out = out.replace("namespace {\n", "__device__ long long clocks[4096 * 16];\nnamespace {\n", 1)
    return out.replace('extern "C" {', 'extern "C" {\nint wkv6_bwd_clocks(long long* out) '
                       '{ return cudaMemcpyFromSymbol(out, clocks, sizeof(clocks)); }\n', 1)


def one_launch_call(lib: ctypes.CDLL, r, k, v, lw, u, s0, dy, ds):
    """The one-launch design's C entry (no scratch), as its wrapper called it."""
    fn = lib.wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    B, H, T, K = r.shape
    dr, dk, dv, dlw = (torch.empty_like(t) for t in (r, k, v, lw))
    du_part = torch.empty((B, H, K), dtype=torch.float32, device=r.device)
    ds0 = torch.empty_like(s0)
    strides = (ctypes.c_longlong * 27)(
        *(s for t in (r, k, v, lw, dy, dr, dk, dv, dlw) for s in t.stride()[:3]))
    code = {torch.float32: 0, torch.bfloat16: 1}
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), u.data_ptr(), s0.data_ptr(),
             dy.data_ptr(), ds.data_ptr() if ds is not None else None, dr.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(), du_part.data_ptr(), ds0.data_ptr(),
             code[r.dtype], code[dy.dtype], B, H, T, K, strides,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"wkv6_bwd (one launch) failed: {err}")
    return dr, dk, dv, dlw, du_part.sum(0), ds0


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    src = (build.CSRC / "wkv6_bwd.cu").read_text()
    others = {os.path.splitext(os.path.basename(p))[0]: open(p).read() for p in sys.argv[1:]}
    libs = build_variants({**variants(src, others), "clocked": clocked(src)},
                          os.path.join(ROOT, "build", "ablation_wkv6_bwd"))
    clocked_lib = ctypes.CDLL(libs.pop("clocked")[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, T, K = 4, 32, 1024, 64
    r, k, v = (torch.randn((B, T, H, K), generator=gen, device="cuda").bfloat16().transpose(1, 2)
               for _ in range(3))
    lw = -torch.exp(torch.randn((B, T, H, K), generator=gen, device="cuda")).transpose(1, 2)
    u = torch.randn((H, K), generator=gen, device="cuda")
    s0 = torch.zeros((B, H, K, K), device="cuda")
    dy = torch.randn((B, T, H, K), generator=gen, device="cuda").transpose(1, 2)
    args = (r, k, v, lw, u, s0, dy, None)
    want = ref.wkv6_backward_reference(*args)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; B={B} H={H} T={T} K=V={K}, bf16 r/k/v, fp32 dy, ms per call")
    for name in [*libs, *reversed(list(libs))]:  # each twice, in turns
        path, log = libs[name]
        lib = ctypes.CDLL(path)
        if hasattr(lib, "wkv6_bwd_scratch_floats"):
            wk.load_library = lambda _name, path=path: ctypes.CDLL(path)
            wk._bind_bwd.cache_clear()
            call = wk.wkv6_bwd
        else:
            def call(*a, lib=lib):
                return one_launch_call(lib, *a)
        row = [f"{time_ms(lambda: call(*args)):.4f}"]
        if name in RIGHT or name in others:
            got = call(*args)
            row += [f"{n} {(a.float() - b.float()).abs().max().item() / b.float().abs().max().item():.1e}"
                    for n, a, b in zip(NAMES, got, want)]
        regs = [line for line in ptxas_report(log) if "<bf16,f32,64>" in line or "<64>" in line]
        print(f"  {name:13s} " + "  ".join(row) + f"   [{'; '.join(regs)}]")
    wk.load_library = lambda _name: clocked_lib
    wk._bind_bwd.cache_clear()
    wk.wkv6_bwd(*args)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (4096 * 16))()
    if clocked_lib.wkv6_bwd_clocks(buf):
        raise RuntimeError("wkv6_bwd_clocks failed")
    clk = torch.tensor(list(buf), dtype=torch.float64).view(4096, 16)
    # thread 0 is in warps 0-3, so it never reads the clock at warps 4-7's barrier
    clk = clk[:, clk[0] != 0]
    cycles = (clk[:, 1:] - clk[:, :-1]).mean(0).tolist()
    print(f"  chunk kernel, cycles a block by phase (mean over {clk.shape[0]} blocks, two blocks an SM): "
          + ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, cycles))
          + f"; whole block {(clk[:, -1] - clk[:, 0]).mean().item():.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
