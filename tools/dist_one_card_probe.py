"""What two ranks on one card get from each process-group backend.

    python3 tools/dist_one_card_probe.py [OUT.json]

Starts two processes on ``cuda:0``, first over NCCL, then over gloo with
CUDA tensors, and has each try the collectives of the port's distributed
steps (``repro_torch.train.trainstep.MeshStep``): an fp32 all-reduce (sum
and max), an int32 all-reduce, a reduce-scatter, an all-gather and a
broadcast.  Then it asks the port's ``launch.mesh.make_mesh`` for a cuda
mesh of two ranks on the one card, which must refuse.  Prints one JSON
object (also written to OUT.json) with, per backend and rank, each
collective's outcome: "ok" or the error's first line.  Every process it
starts is killed after 120 s.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(backend: str, rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    res = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # the outcome is the result
            res[name] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:300]}"

    attempt("init", lambda: dist.init_process_group(backend, init_method=f"file://{store}",
                                                     world_size=2, rank=rank))
    if res["init"] == "ok":
        x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
        attempt("all_reduce_sum_fp32", lambda: dist.all_reduce(x.clone()))
        attempt("all_reduce_max_fp32", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX))
        attempt("all_reduce_sum_int32", lambda: dist.all_reduce(x.to(torch.int32)))
        attempt("reduce_scatter_tensor",
                lambda: dist.reduce_scatter_tensor(torch.empty(4, device="cuda"), x.clone()))
        attempt("all_gather_into_tensor",
                lambda: dist.all_gather_into_tensor(torch.empty(16, device="cuda"), x.clone()))
        attempt("broadcast", lambda: dist.broadcast(x.clone(), src=0))
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def mesh_refusal() -> str:
    """What ``make_mesh`` says to a cuda mesh of two ranks on one card."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import make_mesh

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        make_mesh((2, 1), ("data", "model"), device="cuda", init_method="file:///nonexistent",
                  world_size=2, rank=0)
    except RuntimeError as e:
        return f"RuntimeError: {e}"
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return "no refusal"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dist_one_card_probe: no CUDA device", file=sys.stderr)
        return 1
    report = {"device": torch.cuda.get_device_name(0), "cards": torch.cuda.device_count(),
              "torch": torch.__version__}
    work = tempfile.mkdtemp(prefix="dist_probe_")
    for backend in ("nccl", "gloo"):
        store = os.path.join(work, f"{backend}.store")
        outs = [os.path.join(work, f"{backend}.{r}.json") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", backend,
                                   str(r), store, outs[r]],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, 120 - (time.perf_counter() - t0)))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0] + "\n(killed after 120 s)")
        report[backend] = {}
        for r, (p, out, log) in enumerate(zip(procs, outs, logs)):
            if os.path.exists(out):
                with open(out) as f:
                    report[backend][f"rank{r}"] = json.load(f)
            else:
                report[backend][f"rank{r}"] = {"exit": p.returncode, "log": log[-1500:]}
        report[backend]["seconds"] = round(time.perf_counter() - t0, 1)
    report["make_mesh"] = mesh_refusal()
    text = json.dumps(report, indent=1)
    print(text)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
        with open(sys.argv[1], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        sys.exit(main())
