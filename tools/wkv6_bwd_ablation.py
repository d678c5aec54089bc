"""Where the WKV6 backward kernel spends its time, by ablation.

    python3 tools/wkv6_bwd_ablation.py [OTHER.cu ...]     # on one NVIDIA GPU

Builds variants of ``src/repro_torch/kernels/csrc/wkv6_bwd.cu`` and times
each at the rwkv6-1.6b training shape (B=4, H=32, T=1024, K=V=64, bf16
r/k/v, fp32 dy, no gradient of the final state, as the model calls it) with
``chip_smoke.time_ms`` (median of 30 calls with CUDA events, the L2 flushed
before each), every variant twice, in the order A, B, .., B, A.  Each
OTHER.cu, another version of the source (such as the parent commit's), is
built and timed beside them under its file's stem.

- ``full``: the kernel as it is;
- ``rows4``: tiles of 4 state rows a thread (blocks of 256 threads at
  K = 64) against the source's 2 (512 threads);
- ``no_shuffles``: the row and column sums not added across lanes;
- ``no_stores``: the chunk's outputs not written to device memory (nor dv
  summed over the warps);
- ``forward_only``: the forward pass alone (S rebuilt, dr and Q written).

For ``full``, ``rows4`` and each OTHER.cu it also prints the largest error
of each gradient against ``ref.wkv6_backward_reference``, relative to the
gradient's largest entry.  The other variants compute wrong results: they
are timing builds only, and nothing else uses them.
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
from chip_smoke import ptxas_report, time_ms  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from wkv6_ablation import build_variants  # noqa: E402

wk = importlib.import_module("repro_torch.kernels.wkv6")

ROWS = "constexpr int TILE_ROWS = 2;"
SHUFFLES = ("__shfl_xor_sync(FULL, send, mask)", "__shfl_xor_sync(FULL, x[0], mask)")
STORES = "for (int x = tid; x < n * K; x += THREADS) {"  # the loops that write a chunk's outputs
FORWARD = "  __syncthreads();  // Q_t in dlog_w's buffer"
RIGHT = ("full", "rows4")  # variants that compute the gradients, with every OTHER.cu
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")


def variants(src: str, others: dict) -> dict:
    out = {
        "full": src,
        "rows4": src.replace(ROWS, ROWS.replace("2", "4")),
        "no_shuffles": src.replace(SHUFFLES[0], "send").replace(SHUFFLES[1], "x[0]"),
        "no_stores": src.replace(STORES, STORES.replace("x < n * K", "0 > p.T && x < n * K")),
        "forward_only": src.replace(FORWARD, "  if (p.T > 0) return;\n" + FORWARD),
    }
    for name, text in out.items():
        if name != "full" and text == src:
            raise RuntimeError(f"variant {name}: its marker is no longer in the source")
    return {**out, **others}


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    src = (build.CSRC / "wkv6_bwd.cu").read_text()
    others = {os.path.splitext(os.path.basename(p))[0]: open(p).read() for p in sys.argv[1:]}
    libs = build_variants(variants(src, others), os.path.join(ROOT, "build", "ablation_wkv6_bwd"))
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
        wk.load_library = lambda _name, path=path: ctypes.CDLL(path)
        wk._bind_bwd.cache_clear()
        row = [f"{time_ms(lambda: wk.wkv6_bwd(*args)):.4f}"]
        if name in RIGHT or name in others:
            got = wk.wkv6_bwd(*args)
            row += [f"{n} {(a.float() - b.float()).abs().max().item() / b.float().abs().max().item():.1e}"
                    for n, a, b in zip(NAMES, got, want)]
        regs = [line for line in ptxas_report(log) if line.startswith("wkv6_bwd_kernel<bf16,f32,64>")]
        print(f"  {name:13s} " + "  ".join(row) + f"   [{'; '.join(regs)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
