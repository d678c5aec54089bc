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
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from .. import configs
from ..models import get_api, modality_inputs, smoke_config
from ..serve.engine import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    api = get_api(cfg, device=args.device)
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
    eng = ServeEngine(api, model, batch=args.batch, s_max=s_max)

    t0 = time.perf_counter()
    out = eng.generate(inputs, max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"generated {out.shape} in {dt:.2f}s → {toks/dt:,.1f} tok/s")
    print("first row:", out[0][:12].tolist())


if __name__ == "__main__":
    main()
