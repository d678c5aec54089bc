"""Training command line on the port: the data plane of ``repro.launch.train``.

Runs on the card unless ``--device`` says otherwise:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --steps 6 --batch 4 --seq 1024 --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
      --steps 6 --batch 4 --seq 1024 --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke --device cpu

Every family the port serves trains: the dense ones (gemma-2b, olmo-1b,
gemma2-9b, qwen2.5-14b) and rwkv6.  It trains one model on one device with
AdamW (``train.trainstep``) on the deterministic synthetic data of
``train.data`` and prints the JAX launcher's ``step … loss … lr … tok/s``
line.  Two parts of the JAX launcher are not
ported yet, so their flags are not offered: the control-plane line
(``[control-plane] … LTRR``), which needs the port's own copies of
``core.topology``, ``core.decomposition``, ``core.reconfig`` and
``core.logical.ring_demand`` (ROADMAP A.2), and checkpoints with resume
(``--ckpt-dir``, ROADMAP A.3).  The distributed steps (``--hierarchical``,
``--compress``, ``--zero1``) wait for ROADMAP A.7.
"""
from __future__ import annotations

import argparse
import time

from .. import configs
from ..models import get_api, smoke_config
from ..train.data import DataConfig, SyntheticData
from ..train.optimizer import OptConfig
from ..train.trainstep import TrainHparams, batch_to_torch, make_train_state, train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
    api = get_api(cfg, device=args.device)
    data = SyntheticData(
        DataConfig(vocab_size=cfg.vocab_size, batch=args.batch, seq=args.seq),
        model_cfg=cfg,
    )
    opt = OptConfig(lr=args.lr, warmup_steps=5, total_steps=max(args.steps, 10))
    hp = TrainHparams(grad_accum=args.grad_accum)
    state = make_train_state(api, seed=0)

    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = batch_to_torch(data.batch_at(i), api.device)
        metrics = train_step(state["model"], state["opt"], batch, opt, hp)
        if i % args.log_every == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])  # waits for the step
            toks = args.batch * args.seq * (i + 1)
            dt = time.perf_counter() - t0
            print(
                f"step {i:5d}  loss {loss:.4f}  "
                f"lr {float(metrics['lr']):.2e}  {toks/dt:,.0f} tok/s"
            )


if __name__ == "__main__":
    main()
