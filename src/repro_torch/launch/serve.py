"""Batched serving command line: prefill + greedy KV-cache decode on the port.

Runs on the card unless ``--device`` says otherwise:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --batch 4 --prompt-len 1024 --max-new 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-1b --smoke --device cpu

whisper-small takes random frame embeddings and internvl2-1b random patch
embeddings (the JAX package's frontend stubs), drawn after the prompt from
one generator, as JAX's command line draws them.

Under ``python -m torch.distributed.run`` (or with ``--model`` above 1 or
``--fsdp``) every rank serves its part of one model on the host mesh
(``launch.mesh.make_host_mesh``: ``model`` ranks on the model axis, the
rest on the data axes), and rank 0 prints:
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch qwen2.5-14b --smoke --device cpu --model 2
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch gemma2-9b --smoke --device cpu --fsdp
``--model`` takes every family: rwkv6's time mix is head-parallel,
jamba's Mamba mixers channel-parallel, whisper's attentions and
cross-attentions and the VLM's projector and LM as the attention models':
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch rwkv6-1.6b --model 4 --batch 4 --prompt-len 1024
``--fsdp`` takes every family too (rwkv6, jamba, whisper and the VLM
gather each module's blocks just before its use):
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.serve --arch jamba-1.5-large-398b --smoke --device cpu --fsdp
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch.distributed as dist

from .. import configs
from ..models import get_api, modality_inputs, smoke_config
from ..serve.engine import ServeEngine
from .mesh import make_host_mesh, shutdown


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--model", type=int, default=1,
                    help="ranks of the model axis: tensor and expert parallelism")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: each rank keeps a block of every parameter over the DP axes")
    args = ap.parse_args(argv)

    mesh = None
    if args.fsdp or "RANK" in os.environ or args.model > 1:
        mesh = make_host_mesh(model=args.model, device=args.device)
    try:
        serve(args, mesh)
    finally:
        if mesh is not None:
            shutdown()


def serve(args, mesh) -> None:
    """Serve one batch of random prompts from ``args`` (on ``mesh``'s rank
    when it is given; rank 0 prints)."""
    cfg = smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    api = get_api(cfg, device=args.device, mesh=mesh, fsdp=args.fsdp)
    model = api.init(seed=0)
    rng = np.random.default_rng(0)
    inputs = {
        "tokens": rng.integers(
            0, cfg.vocab_size, size=(args.batch, args.prompt_len)
        ).astype(np.int64)
    }
    inputs.update(modality_inputs(cfg, rng, args.batch))
    s_max = args.prompt_len + args.max_new + (
        cfg.vision_tokens if cfg.family == "vlm" else 0) + 2
    eng = ServeEngine(api, model, batch=args.batch, s_max=s_max, mesh=mesh)

    t0 = time.perf_counter()
    out = eng.generate(inputs, max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    if mesh is None or dist.get_rank() == 0:
        where = "" if mesh is None else f" on mesh {dict(zip(mesh.axis_names, mesh.shape))}"
        print(f"generated {out.shape}{where} in {dt:.2f}s → {toks/dt:,.1f} tok/s")
        print("first row:", out[0][:12].tolist())


if __name__ == "__main__":
    main()
