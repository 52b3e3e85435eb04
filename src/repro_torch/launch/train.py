"""Training launcher: the OSDP pipeline, then training on one device or
sharded over the ranks of `torchrun`.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced \\
        --cpu --steps 3
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced --cpu \\
        --steps 2 --force-mode ZDP
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --batch 8 \\
        --device h100-sxm --memory-gib 64 --steps 5
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --batch 8 \\
        --device h100-sxm --memory-gib 64 --steps 100 \\
        --ckpt-dir ckpt --ckpt-every 10 --keep-last 2 [--resume]
    python -m repro_torch.launch.train --arch mamba2-2.7b --batch 8 \\
        --device h100-sxm --memory-gib 64 --steps 5

It trains the dense and SSM decoder families; the others are refused
when the model is built (`models.transformer.check_supported`).

Runs the OSDP pipeline (describe -> search -> plan) for the data mesh,
builds the model with the plan's segments and remat policy, and trains
on the synthetic pipeline through the port's kernels.  It runs on the
card unless `--cpu` is given (the kernels' plain versions); without a
card and without `--cpu` it raises, and never falls back.  Under
`torchrun` (`WORLD_SIZE` and `RANK` set) it plans for W data-parallel
devices (`MeshConfig((W, 1))`), opens a process group (NCCL on the
card, gloo with `--cpu`), shards the plan's ZDP segments over the ranks
and trains on each rank's rows of the global batch; only rank 0 prints.
Without `torchrun` it trains at world 1, unsharded.
With `--reduced` and no `--seq`/`--batch` the shape is cut to seq 128
and batch 4 (smoke scale; the JAX launcher keeps the shape's own).

`--ckpt-dir` writes crash-safe checkpoints in the JAX package's format
(every `--ckpt-every` steps and at the end, keeping the newest
`--keep-last`); `--resume` restores the latest valid one and treats
`--steps` as the total step target, so a killed run restarts where its
last checkpoint left it.  The JAX launcher's `--overlap*` flags
(OverlapConfig, ROADMAP section 1 item 6) are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from repro_torch.configs import (DeviceInfo, MeshConfig, OSDPConfig,
                                 RunConfig, get_arch, get_shape, reduced)
from repro_torch.core.plan import make_plan
from repro_torch.launch.mesh import init_data_mesh, make_mesh_from_config
from repro_torch.models.registry import build_model, resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-sized)")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--memory-gib", type=float, default=16.0)
    ap.add_argument("--device", default=None, metavar="PRESET",
                    help="DeviceInfo preset the planner prices against "
                         "(tpu-v5e, tpu-v4, a100-80g, h100-sxm)")
    ap.add_argument("--force-mode", default=None, choices=["DP", "ZDP"])
    ap.add_argument("--no-osdp", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=0,
                    help="checkpoint retention: keep the newest N "
                         "completed steps (0 = keep everything)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest valid checkpoint under "
                         "--ckpt-dir and treat --steps as the TOTAL "
                         "step target (completed steps are skipped)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (the kernels' plain versions) "
                         "instead of the card")
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    dev = resolve_device("cpu" if args.cpu else None)
    distributed = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    world = int(os.environ["WORLD_SIZE"]) if distributed else 1
    rank = int(os.environ["RANK"]) if distributed else 0
    say = print if rank == 0 else (lambda *a, **k: None)

    model_cfg = get_arch(args.arch)
    if args.reduced:
        model_cfg = reduced(model_cfg)
    shape = get_shape(args.shape)
    if args.seq or args.batch:
        shape = dataclasses.replace(
            shape, seq_len=args.seq or shape.seq_len,
            global_batch=args.batch or shape.global_batch)
    if args.reduced and not args.seq:
        shape = dataclasses.replace(shape, seq_len=min(shape.seq_len, 128))
    if args.reduced and not args.batch:
        shape = dataclasses.replace(shape,
                                    global_batch=min(shape.global_batch, 4))

    mesh_cfg = MeshConfig((world, 1), ("data", "model"))
    osdp = OSDPConfig(enabled=not args.no_osdp,
                      memory_limit_bytes=args.memory_gib * 2**30,
                      force_mode=args.force_mode)
    run = RunConfig(model=model_cfg, shape=shape, mesh=mesh_cfg, osdp=osdp)
    device = DeviceInfo.preset(args.device) if args.device else None
    plan = make_plan(run, device)
    say(plan.summary())
    mesh = None
    if distributed:
        init_data_mesh("gloo" if args.cpu else "nccl")
        mesh = make_mesh_from_config(mesh_cfg)
        dev = resolve_device("cpu" if args.cpu
                             else f"cuda:{torch.cuda.current_device()}")
    try:
        built = build_model(run, plan, mesh)
        if mesh is not None:
            sharded = built.pset.sharded()
            say(f"data mesh: W = {mesh.world} ({mesh.backend}); "
                f"{len(sharded)} leaves sharded, "
                f"{len(built.pset.guarded)} ZDP leaves kept whole by the "
                f"divisibility guard")
        say(f"remat: {built.model.remat}; microbatch {run.microbatch}; "
            f"device {dev}")
        res = train(built, args.steps, seed=args.seed,
                    opt_cfg=AdamWConfig(lr=args.lr), warmup=args.warmup,
                    ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                    keep_last=args.keep_last, resume=args.resume,
                    device=dev, print_fn=say)
    finally:
        if mesh is not None:
            mesh.destroy()
    if not res.steps:
        say(f"nothing to train: checkpoint already at step "
            f"{res.start_step} >= target {args.steps}")
        return 0
    say(f"done: {res.steps} steps, loss {res.losses[0]:.4f} -> "
        f"{res.losses[-1]:.4f}, {res.tokens_per_s:.0f} tok/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
