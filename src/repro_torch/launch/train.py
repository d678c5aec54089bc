"""Training command line on the port: control plane (Cross Wiring) + data
plane, as ``repro.launch.train`` does on one device.

1. **Control plane**: the job is placed onto ``--pods`` pods of an 8-pod
   OCS cluster; its parallelism plan becomes a logical-topology demand
   (``configs.job_demand``, the DP ring across pods); MDMCF
   (``core.reconfig.mdmcf_reconfigure``) computes the OCS configuration, and
   the ``[control-plane] … demand=… links  LTRR=… mdmcf=… ms`` line reports
   it.  On a 2-pod ring the port asks ``2 × links`` per pair where the
   reference asks ``links`` (``repro_torch.core.logical``, ROADMAP C.2).
2. **Data plane**: one model on one device trained with AdamW
   (``train.trainstep``) on the deterministic synthetic data of
   ``train.data``, printing ``step … loss … lr … tok/s``.  With
   ``--ckpt-dir`` it writes a checkpoint in the background every
   ``--ckpt-every`` steps and a final one, in the JAX package's format
   (``ckpt.manager``), and a rerun resumes from the latest one.
   Under ``python -m torch.distributed.run`` (``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK`` set), or with ``--hierarchical``, ``--compress``,
   ``--zero1``, ``--fsdp`` or ``--model``, it builds ``make_host_mesh(model=)`` over
   the world (data × model; ``--model N`` > 1: pod 1 × data × model N,
   tensor and expert parallel over ``model``) and trains through
   ``train.trainstep.make_train_step``, as JAX's ``--smoke`` path does:
   the flat all-reduce step, or with
   ``--hierarchical`` the reduce-scatter / cross-pod / ZeRO-1 step
   (``--compress``: int8 values across pods; ``--zero1``: sharded moments
   in the flat step; ``--fsdp``: ZeRO-3, each rank holding its blocks of
   the parameters and the moments over the DP axes and gathering each
   layer as it runs).  Each rank takes its block of the global batch; the
   checkpoint gathers the moments and rank 0 writes it, and a rerun at
   another world size restores its own slices.  Only rank 0 prints.

Runs on the card unless ``--device`` says otherwise:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --steps 6 --batch 4 --seq 1024 --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b --smoke \
      --device cpu --steps 4 --ckpt-dir /tmp/ckpt     # twice: the second resumes
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \
      --steps 6 --batch 4 --seq 448 --lr 3e-4
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 2 \
      -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu \
      --hierarchical --zero1 --compress --steps 4     # 2 gloo ranks on the CPU
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch gemma-2b --steps 6 --batch 8 --seq 1024 \
      --hierarchical --zero1                          # NCCL, one card a rank
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch qwen2.5-14b --model 4 --hierarchical --zero1 \
      --steps 6 --batch 4 --seq 1024                  # tensor parallel over 4 cards
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch gemma2-9b --fsdp --steps 6 --batch 8 \
      --seq 1024                                      # ZeRO-3 over 4 cards

Every family trains with its own loss (``ModelAPI.loss``): the dense ones
(gemma-2b, olmo-1b, gemma2-9b, qwen2.5-14b), rwkv6, the MoE ones
(deepseek-v3-671b with MLA, grok-1-314b), whisper-small on ``frames`` of
``encoder_seq`` frames (``--seq`` at most its ``max_target_positions``, 448)
and internvl2-1b on ``patches`` before ``--seq`` tokens; the synthetic data
draws the frames and patches; jamba-1.5-large-398b's hybrid through the
selective-scan kernel and its backward (``kernels/selective_scan.py``),
with 0.01 x the MoE auxiliary loss.  At full width one card holds
whisper-small and internvl2-1b whole; the MoE models and jamba only cut
(``chip_smoke.py`` cuts them), qwen2.5-14b over ``--model 4`` and
gemma2-9b with ``--fsdp`` over 4 cards.  ``--model`` takes every family
(rwkv6 head-parallel, jamba's Mamba mixers channel-parallel, whisper and
internvl2 as the attention families):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
      --arch rwkv6-1.6b --model 4 --hierarchical --zero1 --steps 6 --batch 4 --seq 1024
``--fsdp`` takes every family (each gathers its modules' blocks just
before their use), and with ``--hierarchical`` one pod (ROADMAP C.9):
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 \
      -m repro_torch.launch.train --arch whisper-small --smoke --device cpu --fsdp --steps 4
"""
from __future__ import annotations

import argparse
import os
import time

import torch.distributed as dist

from .. import configs
from ..ckpt.manager import latest_step, restore_checkpoint, save_checkpoint
from ..core.reconfig import mdmcf_reconfigure
from ..core.topology import ClusterSpec
from ..models import get_api, smoke_config
from ..train.data import DataConfig, SyntheticData
from ..train.optimizer import OptConfig
from ..train.trainstep import (TrainHparams, batch_to_torch, make_train_state, make_train_step,
                               train_step)
from .mesh import make_host_mesh, shutdown


def control_plane(arch: str, num_pods_used: int, cluster_pods: int = 8) -> dict:
    """Place the job, derive its OCS demand, run MDMCF.  Returns a report."""
    spec = ClusterSpec(num_pods=cluster_pods, k_spine=16, k_leaf=16)
    plan = configs.get_plan(arch)
    pods = tuple(range(num_pods_used))
    demand = configs.job_demand(plan, spec, pods)
    t0 = time.perf_counter()
    res = mdmcf_reconfigure(spec, demand) if demand.any() else None
    dt = time.perf_counter() - t0
    return {
        "spec": spec,
        "plan": plan,
        "pods": pods,
        "demand_links": int(demand.sum() // 2),
        "ltrr": (res.ltrr if res is not None else 1.0),
        "reconfig_s": dt,
        "config": (res.config if res is not None else None),
    }


def control_plane_line(arch: str, cp: dict) -> str:
    """JAX's ``[control-plane]`` line for a :func:`control_plane` report."""
    return (
        f"[control-plane] arch={arch} pods={cp['pods']} "
        f"plan(tp={cp['plan'].tp}, ep={cp['plan'].ep}) "
        f"demand={cp['demand_links']} links  LTRR={cp['ltrr']:.3f} "
        f"mdmcf={cp['reconfig_s']*1e3:.1f} ms"
    )


def train_loop(cfg, *, steps: int, batch: int, seq: int, lr: float, grad_accum: int = 1,
               log_every: int = 5, device="cuda", seed: int = 0, ckpt_dir=None,
               ckpt_every: int = 20, mesh=None, hierarchical: bool = False,
               compress: bool = False, zero1: bool = False, fsdp: bool = False) -> dict:
    """The data plane: train ``cfg`` from ``make_train_state(seed)``, or from
    the latest checkpoint in ``ckpt_dir``, up to ``steps``.  With ``mesh``
    (``launch.mesh``; this process is one of its ranks, on ``mesh.device``)
    through the distributed step of ``hierarchical``, ``compress``,
    ``zero1`` and ``fsdp`` (``make_train_step``), and only rank 0 prints.

    The periodic save after step ``i`` (``(i + 1) % ckpt_every == 0``) runs
    in the background and is joined before the next one; the last step is
    written once, by the final synchronous save (JAX's loop writes it twice).

    Returns ``{"state", "restore_s", "log", "saves"}``: the live state; the
    seconds the restore took (None without one); per logged step ``{"step",
    "loss", "lr", "ms", "writing"}``, ``ms`` the host time of the step, which
    ends in a wait for the loss, ``writing`` whether a background write was
    still running then; per save ``{"step", "blocked_s", "writer"}``
    (``blocked_s`` the seconds the loop waited: the host copy of a
    background save, the whole final save; ``writer`` the finished
    :class:`~repro_torch.ckpt.manager.Writer`, None for the final save and
    on the ranks that do not write).
    """
    api = get_api(cfg, device=mesh.device if mesh is not None else device, mesh=mesh,
                  fsdp=fsdp)
    data = SyntheticData(DataConfig(vocab_size=cfg.vocab_size, batch=batch, seq=seq),
                         model_cfg=cfg)
    opt = OptConfig(lr=lr, warmup_steps=5, total_steps=max(steps, 10))
    hp = TrainHparams(grad_accum=grad_accum, hierarchical=hierarchical, compress=compress,
                      zero1=zero1, fsdp=fsdp)
    if mesh is None:
        mesh_step = None
        state = make_train_state(api, seed=seed)
        run = lambda b: train_step(state["model"], state["opt"], b, opt, hp)  # noqa: E731
    else:
        mesh_step = make_train_step(api, cfg, opt, mesh, hp, data.batch_at(0))
        state = mesh_step.init_state(seed)
        run = lambda b: mesh_step(state, b)  # noqa: E731
    talks = mesh is None or dist.get_rank() == 0
    out = {"state": state, "restore_s": None, "log": [], "saves": []}

    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        t0 = time.perf_counter()
        start = restore_checkpoint(ckpt_dir, state, mesh_step=mesh_step) + 1
        out["restore_s"] = time.perf_counter() - t0
        if talks:
            print(f"[resume] from step {start - 1}")

    def save(i, background):
        t0 = time.perf_counter()
        writer = save_checkpoint(ckpt_dir, i, state, background=background, mesh_step=mesh_step)
        out["saves"].append({"step": i, "blocked_s": time.perf_counter() - t0,
                             "writer": writer})
        return writer

    pending = None
    t0 = time.perf_counter()
    for i in range(start, steps):
        t_step = time.perf_counter()
        metrics = run(batch_to_torch(data.batch_at(i), api.device))
        if i % log_every == 0 or i == steps - 1:
            loss, step_lr = float(metrics["loss"]), float(metrics["lr"])  # waits for the step
            now = time.perf_counter()
            out["log"].append({"step": i, "loss": loss, "lr": step_lr,
                               "ms": (now - t_step) * 1e3,
                               "writing": pending is not None and pending.is_alive()})
            toks = batch * seq * (i - start + 1)
            if talks:
                print(f"step {i:5d}  loss {loss:.4f}  lr {step_lr:.2e}  "
                      f"{toks/(now - t0):,.0f} tok/s")
        if ckpt_dir and (i + 1) % ckpt_every == 0 and i < steps - 1:
            if pending is not None:
                pending.join()
            pending = save(i, background=True)
    if pending is not None:
        pending.join()
    if ckpt_dir:
        save(steps - 1, background=False)
        if talks:
            print(f"[ckpt] final at step {steps - 1}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--pods", type=int, default=2, help="pods the job occupies")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hierarchical", action="store_true",
                    help="reduce-scatter in-pod, all-reduce across pods, ZeRO-1")
    ap.add_argument("--compress", action="store_true",
                    help="int8 cross-pod gradients (with --hierarchical)")
    ap.add_argument("--zero1", action="store_true", help="shard the AdamW moments over data")
    ap.add_argument("--fsdp", action="store_true",
                    help="ZeRO-3: shard the parameters and moments over the DP axes")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks of the model axis: tensor and expert parallelism")
    args = ap.parse_args(argv)

    flags = dict(hierarchical=args.hierarchical, compress=args.compress, zero1=args.zero1,
                 fsdp=args.fsdp)
    mesh = None
    if any(flags.values()) or "RANK" in os.environ or args.model > 1:
        mesh = make_host_mesh(model=args.model, device=args.device)
    try:
        if mesh is None or dist.get_rank() == 0:
            print(control_plane_line(args.arch, control_plane(args.arch, args.pods)))
        cfg = smoke_config(args.arch) if args.smoke else configs.get_config(args.arch)
        train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                   grad_accum=args.grad_accum, log_every=args.log_every, device=args.device,
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, mesh=mesh, **flags)
    finally:
        if mesh is not None:
            shutdown()


if __name__ == "__main__":
    main()
