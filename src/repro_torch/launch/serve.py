"""Serving launcher: OSDP-planned continuous batching on PyTorch.

Default path: run the serving search (`search_serve`) for the target
device preset, print the plan (sharding decisions + KV-budget admission
limit), build the model with the plan's decisions, and serve a
synthetic request stream through the continuous-batching engine on the
card.  `--no-plan` is the unplanned path (OSDP off, static batch
engine); `--engine static` runs the planned model through the static
engine.  `--cpu` runs on the CPU with the kernels' plain versions.

    python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --device h100-sxm --memory-limit-gib 64 --prompt-len 256
    python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduced --cpu
    python -m repro_torch.launch.serve --arch mamba2-2.7b --reduced --cpu

The dense (phi4-mini-3.8b, qwen1.5-0.5b, llama3-405b) and SSM
(mamba2-2.7b) decoder families are ported; the others raise.

Multi-replica fleet planning (`--fleet` in the JAX launcher) needs the
traffic simulator and comes with a later slice.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.configs import (DeviceInfo, MeshConfig, OSDPConfig,
                                 RunConfig, get_arch, get_shape, reduced)
from repro_torch.core.api import search_serve
from repro_torch.models.registry import build_model, resolve_device
from repro_torch.serving.engine import ContinuousEngine, Engine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions) "
                         "instead of the card")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size (--no-plan / --engine static)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    # --- planning ----------------------------------------------------------
    ap.add_argument("--no-plan", action="store_true",
                    help="unplanned path: OSDP disabled, static batching")
    ap.add_argument("--device", default=None, metavar="PRESET",
                    help="DeviceInfo preset to plan for "
                         "(tpu-v5e, tpu-v4, a100-80g, h100-sxm)")
    ap.add_argument("--n-devices", type=int, default=1,
                    help="data extent the plan targets")
    ap.add_argument("--memory-limit-gib", type=float, default=16.0)
    ap.add_argument("--max-slots", type=int, default=0,
                    help="cap the admission limit (0 = searched)")
    # --- workload ----------------------------------------------------------
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=0,
                    help="synthetic requests to serve (0 = 2x batch)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed decode lengths (every 4th request "
                         "decodes the full --new-tokens, the rest 1/4)")
    # --- hardening ---------------------------------------------------------
    ap.add_argument("--max-queue", type=int, default=-1,
                    help="queue-depth backpressure: REJECT requests "
                         "beyond max_slots + this many waiting "
                         "(-1 = unbounded)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="retry budget for transiently-failed attempts")
    ap.add_argument("--backoff-steps", type=int, default=2,
                    help="base engine-step backoff between retries "
                         "(doubles per attempt)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request engine-step deadline "
                         "(0 = none); expired requests end TIMED_OUT")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if not cfg.is_decoder:
        print(f"{cfg.name} is encoder-only; nothing to decode")
        return 1

    rng = np.random.default_rng(args.seed)
    if args.no_plan:
        return _serve_static(cfg, args, rng, device, plan=None)

    preset = DeviceInfo.preset(args.device) if args.device else None
    plan = search_serve(
        cfg, prompt_len=args.prompt_len, decode_len=args.new_tokens,
        n_devices=args.n_devices,
        memory_limit_gib=args.memory_limit_gib, device=preset)
    print(plan.summary())
    if not plan.feasible:
        print("plan infeasible: no concurrency fits the memory limit "
              "(shrink the workload or add devices)")
        return 2
    if args.engine == "static":
        return _serve_static(cfg, args, rng, device, plan=plan)

    n_req = args.requests or 2 * args.batch
    slots = plan.max_slots_per_device
    if args.max_slots:
        slots = min(slots, args.max_slots)
    slots = max(1, min(slots, n_req))
    run = RunConfig(model=cfg, shape=get_shape("decode_32k"),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    osdp=OSDPConfig(
                        enabled=True, checkpointing=False,
                        memory_limit_bytes=args.memory_limit_gib * 2**30))
    built = build_model(run, plan)
    params = built.init(args.seed, device)
    eng = ContinuousEngine(built, params, max_slots=slots,
                           cache_len=args.prompt_len + args.new_tokens,
                           temperature=args.temperature,
                           max_queue=(None if args.max_queue < 0
                                      else args.max_queue),
                           max_retries=args.max_retries,
                           backoff_steps=args.backoff_steps)
    reqs = []
    for i in range(n_req):
        n_new = args.new_tokens
        if args.mixed and i % 4 != 0:
            n_new = max(1, args.new_tokens // 4)
        prompt = rng.integers(0, cfg.vocab_size,
                              args.prompt_len).astype(np.int32)
        reqs.append(Request(i, prompt, n_new,
                            deadline_steps=args.deadline_steps or None))
    results, stats = eng.run(reqs, seed=args.seed)
    print(f"served {stats.completed} requests "
          f"({stats.useful_tokens} tokens) in {stats.wall_s:.2f}s on "
          f"{device}: {stats.tokens_per_s:.1f} tok/s, "
          f"{stats.prefill_steps} prefills + {stats.decode_steps} decode "
          f"steps on {slots} slots "
          f"(utilization {stats.slot_utilization:.0%})")
    if stats.terminal > stats.completed:
        print(f"  non-OK terminals: {stats.rejected} rejected, "
              f"{stats.invalid} invalid, {stats.timed_out} timed out, "
              f"{stats.failed} failed ({stats.retries} retries, "
              f"{stats.wasted_tokens} wasted tokens)")
    for r in results[:3]:
        print(f"  req {r.rid}: {r.n_generated} tokens, queue "
              f"{r.queue_wait_s * 1e3:.0f} ms, ttft "
              f"{r.ttft_s * 1e3:.0f} ms, latency "
              f"{r.latency_s * 1e3:.0f} ms")
    return 0


def _serve_static(cfg, args, rng, device, plan=None) -> int:
    """One batch, lockstep decode."""
    run = RunConfig(model=cfg, shape=get_shape("decode_32k"),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    osdp=(OSDPConfig(enabled=True, checkpointing=False)
                          if plan is not None
                          else OSDPConfig(enabled=False)))
    built = build_model(run, plan)
    params = built.init(args.seed, device)
    cache_len = (args.prompt_len + args.new_tokens
                 if plan is not None else None)
    eng = Engine(built, params, temperature=args.temperature,
                 cache_len=cache_len)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    res = eng.generate(prompts, args.new_tokens, seed=args.seed)
    print(f"prefill {args.batch}x{args.prompt_len} in {res.prefill_s:.2f}s; "
          f"decoded {args.new_tokens} tokens/seq in {res.decode_s:.2f}s "
          f"({res.tokens_per_s:.1f} tok/s) on {device}")
    print("first sequence:", res.tokens[0][:16], "...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
