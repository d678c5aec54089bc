"""Where the selective-scan kernels spend their time, by ablation.

    python3 tools/selective_scan_ablation.py [--parent DIR]     # on one NVIDIA GPU

Builds variants of ``src/repro_torch/kernels/csrc/selective_scan_bwd.cu``
and ``selective_scan.cu`` (each another version of the source text, made
here; the kernels themselves carry no switches) and times each with
``chip_smoke.time_ms`` (median of 30 calls with CUDA events, the L2 flushed
before each), every entry twice, in the order A, B, .., B, A, at jamba's
training shape (B 4, S 1024, d_in 16384, N 16), a TP-4 rank's (d_in 4096)
and an FSDP rank's one row (B 1), with dt = softplus of a unit normal and a
zero h0 (the model's prefill), and the forward also at a decode step (S 1,
B 4, d_in 16384, a random state).  ``DIR`` holds another version of both
sources with the first design's C interface (states every 64 tokens, a
backward of ``groups`` x ``passes``), such as the parent commit's; it is
built and timed beside them as ``parent``.  It prints each kernel's
registers, and the new kernels' time by launch (torch.profiler).

The backward:
- ``new``: the kernels as they are (states every 64 tokens, 16-token
  sub-chunks in registers, 4 states a thread);
- ``chunk16``, ``chunk32``: the forward keeps the state every 16 or 32
  tokens (4x or 2x the saved states), so a chunk needs no or one forward
  run to its sub-chunks' first states;
- ``unstaged``: dt, dtx, dy, B and C read from device memory in the walk
  (only the saved state is staged by ``cp.async``);
- ``two_exp``: a_t computed again on the walk back, not kept from the rerun;
- ``allreduce``: dB and dC summed over the warp's channels by a butterfly
  over all 2 x SPT values a lane holds, not by the reduce-scatter;
- ``cp4``: the stage copied in 4-byte pieces, not 16-byte ones;
- ``spt2``: two states a thread (8 lanes a channel at N 16).
The forward (timed as the training forward, which writes the saved states,
and ``new`` also as a serving call, which does not):
- ``new``; ``chunk16``, ``chunk32`` as above; ``spt16``: a thread a
  channel (its 16 states, the first design's layout); ``spt4``: 4 lanes a
  channel; ``fast_exp``: ``__expf`` for ``expf``; ``cp4`` as above.

Every variant computes the scan: each prints its largest error against the
plain versions (``ref.selective_scan_reference``,
``ref.selective_scan_backward_reference``) relative to max|y| or to each
gradient's max, and ``fast_exp`` also at decays near 1 (dt 1e-5 to 1e-4 over
1024 tokens, d_in 4096), the case an approximate exponential must hold to
1e-5.  The variants other than ``new`` are timing builds only; nothing else
uses them.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
from chip_smoke import bound, ptxas_report, scan_bytes, time_ms  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from wkv6_ablation import build_variants  # noqa: E402

ss = importlib.import_module("repro_torch.kernels.selective_scan")

SHAPES = {"training": (4, 1024, 16384, 16), "TP-4 rank": (4, 1024, 4096, 16),
          "FSDP row": (1, 1024, 16384, 16)}
DECODE = (4, 1, 16384, 16)
NAMES = ("ddt", "ddtx", "dB", "dC", "dA", "dh0")

# the texts each variant replaces in the sources
CHUNK = "constexpr int CHUNK = 64;"
VEC = "D % 4 == 0}"
BWD_STAGE_INPUTS = "  stage_inputs<N, CPB>(p, st, b, g, c, tid);\n"
BWD_INPUTS = re.compile(r"    // the chunk's inputs by its token i, from the stage\n"
                        r"(    auto in_\w+ = .*\n){5}")
BWD_UNSTAGED = """\
    const long long row = ((long long)b * S + t0) * D + (live ? d : 0);
    const long long rown = ((long long)b * S + t0) * N + n0;
    const int lenv = live ? len : 0;  // a dead lane reads zeros, as from the stage
    auto in_dt = [&](int i) { return i < lenv ? p.dt[row + i * D] : 0.f; };
    auto in_dtx = [&](int i) { return i < lenv ? p.dtx[row + i * D] : 0.f; };
    auto in_dy = [&](int i) { return i < lenv ? p.dy[row + i * D] : 0.f; };
    auto in_b = [&](int i, int s) { return i < lenv ? p.bm[rown + i * N + s] : 0.f; };
    auto in_c = [&](int i, int s) { return i < lenv ? p.cm[rown + i * N + s] : 0.f; };
"""
BWD_KEPT_A = "const float at = abuf[i][s];  // kept from the rerun"
BWD_SCATTER = re.compile(r"        // over the warp's channels: each round.*?"
                         r"for \(int o = 2 \* N; o < 32; o <<= 1\) v\[0\] \+= "
                         r"__shfl_xor_sync\(FULL, v\[0\], o\);\n", re.S)
BWD_ALLREDUCE = """\
#pragma unroll
        for (int o = LPC; o < 32; o <<= 1)
#pragma unroll
          for (int k2 = 0; k2 < M; ++k2) v[k2] += __shfl_xor_sync(FULL, v[k2], o);
#pragma unroll
        for (int k2 = 1; k2 < M; ++k2) v[0] = k2 == j ? v[k2] : v[0];
"""
BWD_SPT = "constexpr int SPT = 4;"
FWD_EXP = "expf(dtv * A[s])"
FWD_LAST_CASE = "    case 16 * 32 + 8: return launch<16, 8>(p, s);\n"


def sub1(pattern, repl: str, text: str) -> str:
    """``text`` with ``pattern`` (a string or a compiled regex) replaced
    once; raises if it is not there, so a variant never builds unchanged."""
    if isinstance(pattern, str):
        if text.count(pattern) != 1:
            raise ValueError(f"expected one {pattern!r} in the source")
        return text.replace(pattern, repl)
    out, n = pattern.subn(lambda _: repl, text)
    if n != 1:
        raise ValueError(f"expected one match of {pattern.pattern!r} in the source")
    return out


def variants(fwd: str, bwd: str) -> dict:
    """{name: (forward source, backward source, CHUNK, forward states a
    thread or None for the wrapper's)}."""
    c16, c32 = (CHUNK.replace("64", k) for k in ("16", "32"))
    return {
        "new": (fwd, bwd, 64, None),
        "chunk16": (sub1(CHUNK, c16, fwd), sub1(CHUNK, c16, bwd), 16, None),
        "chunk32": (sub1(CHUNK, c32, fwd), sub1(CHUNK, c32, bwd), 32, None),
        "unstaged": (fwd, sub1(BWD_INPUTS, BWD_UNSTAGED, sub1(BWD_STAGE_INPUTS, "", bwd)),
                     64, None),
        "two_exp": (fwd, sub1(BWD_KEPT_A, "const float at = expf(dtv * A[s]);", bwd), 64, None),
        "allreduce": (fwd, sub1(BWD_SCATTER, BWD_ALLREDUCE, bwd), 64, None),
        "cp4": (sub1(VEC, "false}", fwd), sub1(VEC, "false}", bwd), 64, None),
        "spt2": (fwd, sub1(BWD_SPT, BWD_SPT.replace("4", "2"), bwd), 64, None),
        "spt16": (sub1(FWD_LAST_CASE, FWD_LAST_CASE
                       + FWD_LAST_CASE.replace("+ 8", "+ 16").replace(", 8>", ", 16>"), fwd),
                  bwd, 64, 16),
        "spt4": (fwd, bwd, 64, 4),
        "fast_exp": (sub1(FWD_EXP, "__" + FWD_EXP, fwd), bwd, 64, None),
    }


BWD_VARIANTS = ("new", "chunk16", "chunk32", "unstaged", "two_exp", "allreduce", "cp4", "spt2")
FWD_VARIANTS = ("new", "chunk16", "chunk32", "spt16", "spt4", "fast_exp", "cp4")
WRAPPER_FWD_STATES = ss.fwd_states


def use(libs: dict, name: str, table: dict) -> None:
    """Make the wrapper run variant ``name``: its two libraries, its chunk
    and its forward's states a thread."""
    chunk, states = table[name][2:]
    paths = {"selective_scan": libs[f"fwd_{name}"][0],
             "selective_scan_bwd": libs[f"bwd_{name}"][0]}
    ss.load_library = lambda stem: ctypes.CDLL(paths[stem])
    ss._bind.cache_clear()
    ss._bind_bwd.cache_clear()
    ss.CHUNK = chunk
    ss.fwd_states = (lambda S, N: states) if states else WRAPPER_FWD_STATES


def inputs(gen, B, S, D, N, decay="model", h0=False):
    """(dt, dtx, B, C, A, h0) as the Mamba mixer hands them to the scan."""
    if decay == "near 1":
        dt = 1e-5 + 9e-5 * torch.rand((B, S, D), generator=gen, device="cuda")
    else:
        dt = F.softplus(torch.randn((B, S, D), generator=gen, device="cuda"))
    dtx = dt * torch.randn((B, S, D), generator=gen, device="cuda")
    bm, cm = (torch.randn((B, S, N), generator=gen, device="cuda") for _ in range(2))
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").expand(D, N).contiguous()
    h = (torch.randn((B, D, N), generator=gen, device="cuda") if h0
         else torch.zeros((B, D, N), device="cuda"))
    return dt, dtx, bm, cm, A, h


def parent_fwd(lib, dt, dtx, bm, cm, A, h0, keep=False):
    """The first design's forward (states every 64 tokens) through its C entry."""
    fn = lib.selective_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    B, S, D = dt.shape
    N = A.shape[1]
    y, h = torch.empty_like(dt), torch.empty_like(h0)
    hs = torch.empty((B, -(-S // 64), D, N), device="cuda") if keep else None
    err = fn(dt.data_ptr(), dtx.data_ptr(), bm.data_ptr(), cm.data_ptr(), A.data_ptr(),
             h0.data_ptr(), y.data_ptr(), h.data_ptr(), hs.data_ptr() if keep else None,
             B, S, D, N, 64, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent selective_scan_fwd failed: {err}")
    return y, h, hs


def parent_bwd(lib, dt, dtx, bm, cm, A, hs, dy):
    """The first design's backward (a thread a state, ``groups`` x ``passes``
    blocks of 256 threads) through its C entry, with its plan."""
    fn = lib.selective_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    B, S, D = dt.shape
    N = A.shape[1]
    groups, passes = -(-D // (256 // N)), 1
    while groups % 2 == 0 and (groups // 2) * B >= 2 * 132:
        groups, passes = groups // 2, passes * 2
    out = [torch.empty_like(t) for t in (dt, dtx, bm, cm, A)]
    dh0 = torch.empty((B, D, N), device="cuda")
    da_part = torch.empty((B, D, N), device="cuda")
    dbc_part = torch.empty((groups, B, S, 2, N), device="cuda")
    err = fn(dt.data_ptr(), dtx.data_ptr(), bm.data_ptr(), cm.data_ptr(), A.data_ptr(),
             hs.data_ptr(), dy.data_ptr(), None, *(o.data_ptr() for o in out), dh0.data_ptr(),
             da_part.data_ptr(), dbc_part.data_ptr(), B, S, D, N, groups, passes,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent selective_scan_bwd failed: {err}")
    return (*out, dh0)


def split(call) -> str:
    """Device ms a call by kernel (torch.profiler over 5 calls)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        hit = re.search(r"selective_scan_\w*kernel", e.key)
        if us and hit:
            out.append(f"{hit.group(0)} {us / 5e3:.4f}")
    return ", ".join(out) or "no device time in the profile"


def y_err(got, want) -> float:
    top = want[0].abs().max().item()
    return max((g - w).abs().max().item() for g, w in zip(got[:2], want)) / top


def g_err(got, want) -> str:
    return " ".join(f"{n} {((g - w).abs().max() / w.abs().max()).item():.1e}"
                    for n, g, w in zip(NAMES, got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a directory with the first design's two sources")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("selective_scan_ablation: no CUDA device", file=sys.stderr)
        return 1
    table = variants((build.CSRC / "selective_scan.cu").read_text(),
                     (build.CSRC / "selective_scan_bwd.cu").read_text())
    srcs, names = {}, {}  # each distinct text built once, under the first name that has it
    for name, (fwd, bwd, _, _) in table.items():
        for key, text in ((f"fwd_{name}", fwd), (f"bwd_{name}", bwd)):
            names[key] = next((k for k, t in srcs.items() if t == text), key)
            srcs.setdefault(names[key], text)
    if args.parent:
        for stem, key in (("selective_scan", "parent_fwd"), ("selective_scan_bwd", "parent_bwd")):
            with open(os.path.join(args.parent, f"{stem}.cu")) as f:
                srcs[key], names[key] = f.read(), key
    built = build_variants(srcs, os.path.join(ROOT, "build", "ablation_selective_scan"))
    libs = {key: built[src] for key, src in names.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; ms per call (median of 30, CUDA events, L2 flushed), each entry twice")
    for key in built:
        if not key.startswith("parent"):
            for line in ptxas_report(built[key][1]):
                if "<16" in line and ("sweep" in line or "fwd_kernel" in line):
                    print(f"  ptxas {key}: {line}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (B, S, D, N) in SHAPES.items():
        a = inputs(gen, B, S, D, N)
        dy = torch.randn((B, S, D), generator=gen, device="cuda")
        want_y = ref.selective_scan_reference(*a)
        want_g = ref.selective_scan_backward_reference(*a, dy)
        saved = {}
        for name in BWD_VARIANTS:
            use(libs, name, table)
            saved[name] = ss._launch(*a, keep=True)[2]
        calls = {}
        for name in BWD_VARIANTS:
            def call(name=name):
                use(libs, name, table)
                return ss.selective_scan_bwd(*a, dy, hs=saved[name])
            calls[f"bwd {name}"] = (call, lambda got: g_err(got, want_g))
        for name in FWD_VARIANTS:
            def call(name=name):
                use(libs, name, table)
                return ss._launch(*a, keep=True)
            calls[f"fwd {name}"] = (call, lambda got: f"y {y_err(got, want_y):.1e}")
        calls["fwd new serving"] = (lambda: (use(libs, "new", table), ss._launch(*a, False))[1],
                                    lambda got: f"y {y_err(got, want_y):.1e}")
        if args.parent:
            pf, pb = (ctypes.CDLL(libs[k][0]) for k in ("parent_fwd", "parent_bwd"))
            phs = parent_fwd(pf, *a, keep=True)[2]
            calls["bwd parent"] = (lambda: parent_bwd(pb, *a[:5], phs, dy),
                                   lambda got: g_err(got, want_g))
            calls["fwd parent"] = (lambda: parent_fwd(pf, *a, keep=True),
                                   lambda got: f"y {y_err(got, want_y):.1e}")
        times = {name: [] for name in calls}
        for name in [*calls, *reversed(list(calls))]:  # each twice, in turns
            times[name].append(time_ms(calls[name][0]))
        bb, bf = scan_bytes(B, S, D, N, True), scan_bytes(B, S, D, N, False)
        print(f"{label} (B={B}, S={S}, d_in={D}, N={N}); bound: backward "
              f"{bound(*bb, torch.float32)[0]:.4f} ms ({bb[0] / 1e6:.1f} MB), forward "
              f"{bound(*bf, torch.float32)[0]:.4f} ms; saved states at 64 tokens "
              f"{saved['new'].numel() * 4 / 1e6:.1f} MB, at 32 "
              f"{saved['chunk32'].numel() * 4 / 1e6:.1f} MB, at 16 "
              f"{saved['chunk16'].numel() * 4 / 1e6:.1f} MB")
        for name, (call, err) in calls.items():
            got = call()
            torch.cuda.synchronize()
            print(f"  {name:16s} {times[name][0]:.4f} / {times[name][1]:.4f}   {err(got)}")
        for name in ("bwd new", "fwd new"):
            print(f"  {name} by kernel (ms a call): {split(calls[name][0])}")
        del a, dy, want_y, want_g, saved
        torch.cuda.empty_cache()
    # the decode step, and the fast exponential at decays near 1
    a = inputs(gen, *DECODE, h0=True)
    want = ref.selective_scan_reference(*a)
    calls = {"new": lambda: (use(libs, "new", table), ss._launch(*a, keep=False))[1]}
    if args.parent:
        calls["parent"] = lambda: parent_fwd(ctypes.CDLL(libs["parent_fwd"][0]), *a)
    times = {name: [] for name in calls}
    for name in [*calls, *reversed(list(calls))]:
        times[name].append(time_ms(calls[name]))
    nbytes, flops = scan_bytes(*DECODE, False)
    print(f"decode step (B={DECODE[0]}, S=1, d_in={DECODE[2]}, N={DECODE[3]}): bound "
          f"{bound(nbytes, flops, torch.float32)[0]:.4f} ms ({nbytes / 1e6:.1f} MB); states "
          f"a thread {WRAPPER_FWD_STATES(1, DECODE[3])}")
    for name in calls:
        print(f"  fwd {name:11s} {times[name][0]:.4f} / {times[name][1]:.4f}   "
              f"y {y_err(calls[name](), want):.1e}")
    a = inputs(gen, 4, 1024, 4096, 16, decay="near 1", h0=True)
    want = ref.selective_scan_reference(*a)
    for name in ("new", "fast_exp"):
        use(libs, name, table)
        print(f"decays near 1 (B=4, S=1024, d_in=4096): fwd {name} y and h_S at "
              f"{y_err(ss._launch(*a, keep=False), want):.2e} of max|y| (limit 1e-5)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
