#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0] [--layers 0] [--requests 8]

Phases, each of which raises on failure (so the exit code is nonzero and
the final line is not printed):

1. build the CUDA kernels from `src/repro_torch/csrc` with nvcc for
   sm_90a (into `build/`) and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   serve path's shapes (phi4-mini-3.8b: K=3072 with N in {3072, 1024,
   16384, 200192}, K=8192 with N=3072, at prompt and slot row counts;
   attention (1, S, 8, 3, 128) causal at a ragged and a full prompt),
   and time kernel, plain version and one PyTorch library call; then
   the kernels' other options (f32 at 2e-4, ragged shapes, windows...);
3. plan phi4-mini-3.8b with `search_serve` for the h100-sxm preset, build
   it at full width with random bf16 weights from --seed, and serve
   --requests greedy requests of mixed prompt lengths through
   `ContinuousEngine`, launch counters zeroed just before and read just
   after; every request must end OK and both kernels must have run;
4. on one prompt, check the kernel path's prefill logits against the
   same model run with the plain versions on the card;
5. print a {"kernels": [...]} line, the card's name and power limit, the
   serve metrics, and last {"ok": true, "device": {...}}.

Tolerances: 2e-2 absolute + relative per kernel in bf16 (one bf16 ulp of
an O(1) output; the two sides accumulate in fp32 in different orders).
For the full model, where per-layer ulp differences compound over 32
random layers, the noise floor is measured: the plain version against
itself with its K sums in another order (one fp32 product instead of
512-wide slices); the kernel path must stay within 4x that floor, or
2e-2 of the largest logit if that is larger.  Details of every phase go to
--out (default build/chip_smoke.json).  Needs one CUDA card; nothing of
JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "phi4-mini-3.8b"
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BW = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
KERNEL_TOL = 2e-2
LOGIT_TOL = 2e-2            # of the largest logit, the least tolerance
LOGIT_FLOOR_FACTOR = 4      # x the plain version's own reordering noise
SOURCES = {
    "split_matmul": ("src/repro_torch/csrc/split_matmul.cu",
                     "src/repro/kernels/split_matmul.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _setup():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script needs a "
              "CUDA card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        _fail(f"{ROOT} holds no src/repro_torch: run from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        _fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, args_list, iters=20, warmup=3) -> float:
    """Mean device time of fn(*args) over `iters` calls, cycling through
    `args_list` (distinct weight copies keep L2 cold, as on the path)."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phase 2: kernels against their plain versions --------------------------

def check_split_matmul(torch, M, K, N, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_matmul as sm
    dev = "cuda"
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    w_bytes = K * N * 2
    copies = max(1, min(8, math.ceil(120e6 / w_bytes)))
    ws = [(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K))
          .to(torch.bfloat16) for _ in range(copies)]
    y = sm.split_matmul(x, ws[0])
    torch.cuda.synchronize()
    y_ref = ref.split_matmul_ref(x, ws[0])
    err = (y.float() - y_ref.float()).abs()
    bad = err > KERNEL_TOL + KERNEL_TOL * y_ref.float().abs()
    if not torch.isfinite(y.float()).all() or bad.any():
        _fail(f"split_matmul {M}x{K}x{N}: max error {err.max().item()} "
              f"beyond {KERNEL_TOL} abs+rel")
    args = [(x, w) for w in ws]
    ms = _time_ms(torch, sm.split_matmul, args)
    plain_ms = _time_ms(torch, ref.split_matmul_ref, args, iters=5)
    lib_ms = _time_ms(torch, torch.matmul, args)
    flops = 2.0 * M * N * K
    nbytes = 2.0 * (M * K + K * N + M * N)
    return dict(shape=[M, K, N], max_abs_err=err.max().item(), ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BW),
                bound_by="operations" if flops / PEAK_BF16
                > nbytes / PEAK_BW else "bytes")


def check_flash(torch, S, gen, KV=8, G=3, hd=128):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = "cuda"
    q = torch.randn(1, S, KV, G, hd, generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn(1, S, KV, hd, generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn(1, S, KV, hd, generator=gen, device=dev
                    ).to(torch.bfloat16)
    o = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_ref = ref.flash_attention_ref(q, k, v, causal=True)
    err = (o.float() - o_ref.float()).abs()
    bad = err > KERNEL_TOL + KERNEL_TOL * o_ref.float().abs()
    if not torch.isfinite(o.float()).all() or bad.any():
        _fail(f"flash_attention S={S}: max error {err.max().item()} "
              f"beyond {KERNEL_TOL} abs+rel")

    def kern(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def plain(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=True)

    # the library yardstick in its own (B, H, S, hd) layout, kv heads
    # repeated per group; the layout change is not timed
    qh = q.reshape(1, S, KV * G, hd).transpose(1, 2).contiguous()
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    ms = _time_ms(torch, kern, [(q, k, v)])
    plain_ms = _time_ms(torch, plain, [(q, k, v)], iters=5)
    lib_ms = _time_ms(torch, sdpa, [(qh, kh, vh)])
    H = KV * G
    flops = 4.0 * hd * H * S * (S + 1) / 2      # causal: s+1 keys per row
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    return dict(shape=[1, S, KV, G, hd], max_abs_err=err.max().item(),
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BW),
                bound_by="operations" if flops / PEAK_BF16
                > nbytes / PEAK_BW else "bytes")


def check_options(torch, gen) -> int:
    """The kernels' options beyond the serve path (f32, ragged and tiny
    shapes, K slices, head dim 64, windows, a query offset, cross
    lengths, no causal mask) against the plain versions.  Returns the
    number of cases."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_matmul as sm
    n = 0
    for dtype, tol in ((torch.bfloat16, KERNEL_TOL), (torch.float32, 2e-4)):
        for M, K, N, bk in ((5, 37, 19, 512), (65, 33, 70, 512),
                            (1, 3072, 7, 100), (130, 200, 129, 64)):
            x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
            w = (torch.randn(K, N, generator=gen, device="cuda")
                 / math.sqrt(K)).to(dtype)
            y = sm.split_matmul(x, w, bk=bk).float()
            y_ref = ref.split_matmul_ref(x, w).float()
            if not torch.allclose(y, y_ref, atol=tol, rtol=tol):
                _fail(f"split_matmul {dtype} {M}x{K}x{N} bk={bk}: max error "
                      f"{(y - y_ref).abs().max().item()}")
            n += 1
        for B, S, T, KV, G, hd, causal, window, q_off in (
                (2, 37, 37, 2, 3, 64, True, 0, 0),
                (1, 45, 45, 2, 1, 128, True, 17, 0),
                (1, 20, 45, 1, 4, 64, True, 13, 25),
                (2, 33, 70, 2, 2, 128, False, 0, 0)):
            q = torch.randn(B, S, KV, G, hd, generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn(B, T, KV, hd, generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn(B, T, KV, hd, generator=gen, device="cuda"
                            ).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=q_off)
            o = fa.flash_attention(q, k, v, **kw).float()
            o_ref = ref.flash_attention_ref(q, k, v, **kw).float()
            if not torch.allclose(o, o_ref, atol=tol, rtol=tol):
                _fail(f"flash_attention {dtype} {(B, S, T, KV, G, hd)} {kw}: "
                      f"max error {(o - o_ref).abs().max().item()}")
            n += 1
    return n


@contextlib.contextmanager
def plain_versions(bk=512):
    """Route the model's kernel calls to the plain versions on the card
    (for the full-model comparison only; the port itself never does).
    `bk` sets the plain matmul's K slice (None: one fp32 product)."""
    from repro_torch.kernels import ops, ref
    saved = ops.split_matmul, ops.flash_attention
    ops.split_matmul = lambda x, w, **_: ref.split_matmul_ref(x, w, bk=bk)
    ops.flash_attention = lambda q, k, v, **kw: ref.flash_attention_ref(
        q, k, v, **kw)
    try:
        yield
    finally:
        ops.split_matmul, ops.flash_attention = saved


def profile_split(torch, fn) -> dict:
    """Device time of one call of `fn` by kernel (torch.profiler), and
    the share of the call's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    out = {"split_matmul": 0.0, "flash_attention": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        key = ("split_matmul" if "split_matmul" in ev.key else
               "flash_attention" if "flash_fwd" in ev.key else "other")
        out[key] += us / 1e3
    busy = sum(out.values())
    out["wall_ms"] = wall_ms
    out["device_busy_share"] = busy / wall_ms if busy else None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = full)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the JSON report goes (relative to the "
                         "repository root)")
    args = ap.parse_args(argv)
    torch = _setup()
    import numpy as np

    from repro_torch.configs import (DeviceInfo, MeshConfig, OSDPConfig,
                                     RunConfig, get_arch, get_shape)
    from repro_torch.core.api import search_serve
    from repro_torch.kernels import _lib, ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import OK, ContinuousEngine, Request

    report: dict = {"card": _card(),
                    "device": torch.cuda.get_device_name(0)}
    out_path = ROOT / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)

    # 1. build -----------------------------------------------------------------
    t0 = time.perf_counter()
    _lib.lib()
    report["build_s"] = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {report['build_s']:.1f} s (nvcc sm_90a, "
          f"{len(list((ROOT / 'src/repro_torch/csrc').glob('*.cu')))} "
          f"sources)")
    for ln in ptxas:
        print("  ptxas:", ln)
    report["ptxas"] = ptxas

    # 2. kernels at the path's shapes -----------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cfg_full = get_arch(ARCH)
    d, ff, Vp = cfg_full.d_model, cfg_full.d_ff, cfg_full.padded_vocab
    qf = cfg_full.n_heads * cfg_full.resolved_head_dim
    kvf = cfg_full.n_kv_heads * cfg_full.resolved_head_dim
    prompt_rows, slot_rows = 333, 8        # a ragged prompt; 8 decode slots
    mm = []
    for M in (prompt_rows, slot_rows):
        for K, N in ((d, qf), (d, kvf), (d, 2 * ff), (ff, d)):
            mm.append(check_split_matmul(torch, M, K, N, gen))
    for M in (1, slot_rows):               # head: last prompt row; decode
        mm.append(check_split_matmul(torch, M, d, Vp, gen))
    fl = [check_flash(torch, S, gen) for S in (prompt_rows, 512)]
    for r in mm + fl:
        name = "flash_attention" if len(r["shape"]) == 5 else "split_matmul"
        print(f"  {name:15s} {str(r['shape']):24s} err {r['max_abs_err']:.3g}"
              f" (tol {KERNEL_TOL}) kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    report["split_matmul"], report["flash_attention"] = mm, fl
    n_opt = check_options(torch, gen)
    print(f"  options: {n_opt} cases off the serve path (f32, ragged, "
          f"K slices, hd 64, windows, offsets, non-causal) agree with the "
          f"plain versions")
    torch.cuda.empty_cache()

    # 3. serve phi4-mini at full width ----------------------------------------
    rng = np.random.default_rng(args.seed)
    prompt_max, new_max = 512, 32
    plan = search_serve(cfg_full, prompt_len=prompt_max, decode_len=new_max,
                        n_devices=1, memory_limit_gib=64.0,
                        device=DeviceInfo.preset("h100-sxm"))
    print(plan.summary())
    if not plan.feasible:
        _fail("serve plan infeasible")
    cfg = cfg_full
    if args.layers and args.layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        print(f"depth cut: {cfg.n_layers} of {cfg_full.n_layers} layers")
    slots = max(1, min(plan.max_slots_per_device, args.requests))
    run = RunConfig(model=cfg, shape=get_shape("decode_32k"),
                    mesh=MeshConfig((1, 1), ("data", "model")),
                    osdp=OSDPConfig(enabled=True, checkpointing=False,
                                    memory_limit_bytes=64.0 * 2**30))
    built = build_model(run, plan)
    params = built.init(args.seed, "cuda")
    n_params = sum(p.numel() for p in params.values())
    print(f"model: {ARCH} {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params (bf16) on "
          f"{torch.cuda.get_device_name(0)}")
    cache_len = prompt_max + new_max
    eng = ContinuousEngine(built, params, max_slots=slots,
                           cache_len=cache_len)
    lens = rng.integers(100, prompt_max + 1, args.requests)
    news = rng.integers(16, new_max + 1, args.requests)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(lens[i]))
                    .astype("int32"), int(news[i]))
            for i in range(args.requests)]
    eng.run([Request(-1, reqs[0].prompt, 2)], seed=args.seed)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    results, stats = eng.run(reqs, seed=args.seed)
    counts = ops.launch_counts()
    bad = [r for r in results if r.status != OK]
    if bad or stats.completed != len(reqs):
        _fail(f"{len(bad)} requests not OK: "
              f"{[(r.rid, r.status, r.error) for r in bad]}")
    for r in results:
        toks = r.tokens
        if len(toks) != reqs[r.rid].max_new_tokens or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            _fail(f"request {r.rid}: bad tokens {toks}")
    if min(counts.values()) < 1:
        _fail(f"a kernel never ran on the serve path: {counts}")
    per_pass = 6 * cfg.n_layers + 1
    single = not any(lay.is_split
                     for lay in built.model.pset.layouts.values())
    want_mm = per_pass * (stats.prefill_steps + stats.decode_steps)
    if single and counts["split_matmul"] != want_mm:
        _fail(f"split_matmul ran {counts['split_matmul']} times, the path "
              f"needs {want_mm}")
    if counts["flash_attention"] != cfg.n_layers * stats.prefill_steps:
        _fail(f"flash_attention ran {counts['flash_attention']} times")
    ttft = sorted(r.ttft_s for r in results)
    serve = dict(requests=len(results), slots=slots,
                 prompt_lens=[int(x) for x in lens],
                 new_tokens=[int(x) for x in news],
                 useful_tokens=stats.useful_tokens, wall_s=stats.wall_s,
                 tokens_per_s=stats.tokens_per_s,
                 prefill_steps=stats.prefill_steps,
                 decode_steps=stats.decode_steps,
                 ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
                 ttft_max_ms=1e3 * ttft[-1],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 launches=counts, n_layers=cfg.n_layers)

    # where the time goes: one prefill and one full-slot decode step
    model = built.model
    tok512 = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, prompt_max))
                             .astype("int32"), device="cuda")
    caches = model.init_caches(slots, cache_len, device="cuda")
    last = torch.zeros(slots, 1, dtype=torch.int32, device="cuda")
    tvec = torch.full((slots,), prompt_max, dtype=torch.int32,
                      device="cuda")

    def host_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n

    serve["prefill512_ms"] = host_ms(lambda: model.prefill(
        params, {"tokens": tok512}, cache_len=cache_len))
    serve["decode_step_ms"] = host_ms(lambda: model.decode_step(
        params, caches, last, tvec), n=10)
    serve["profile_prefill512"] = profile_split(torch, lambda: model.prefill(
        params, {"tokens": tok512}, cache_len=cache_len))
    serve["profile_decode_step"] = profile_split(
        torch, lambda: model.decode_step(params, caches, last, tvec))
    for k in ("profile_prefill512", "profile_decode_step"):
        print(f"  {k}: " + ", ".join(
            f"{n} {v:.2f}" if isinstance(v, float) else f"{n} {v}"
            for n, v in serve[k].items()))
    report["serve"] = serve
    print(f"serve: {len(results)} requests OK, {stats.useful_tokens} "
          f"tokens, {stats.prefill_steps} prefills + {stats.decode_steps} "
          f"decode steps on {slots} slots; launches {counts}")

    # 4. whole-model logits: kernels vs plain versions on the card -----------
    probe = {"tokens": torch.as_tensor(reqs[1].prompt[None], device="cuda")}
    lk, _ = model.prefill(params, probe)
    with plain_versions():
        lp, _ = model.prefill(params, probe)
    with plain_versions(bk=None):
        lr, _ = model.prefill(params, probe)
    a, b, c = (t[0, -1, :cfg.vocab_size].float() for t in (lk, lp, lr))
    if not torch.isfinite(a).all():
        _fail("non-finite logits on the kernel path")
    logit_err = (a - b).abs().max().item()
    floor = (c - b).abs().max().item()     # plain vs plain, sums reordered
    scale = b.abs().max().item()
    tol = max(LOGIT_FLOOR_FACTOR * floor, LOGIT_TOL * scale)
    report["logits"] = dict(prompt_len=int(lens[1]), max_abs_err=logit_err,
                            reorder_floor=floor, max_abs_logit=scale,
                            tol=tol,
                            argmax_equal=bool(a.argmax() == b.argmax()))
    print(f"logits: kernel vs plain max error {logit_err:.4g}; plain vs "
          f"plain with its K sums reordered {floor:.4g}; max |logit| "
          f"{scale:.4g}; tol {tol:.4g}; argmax equal "
          f"{report['logits']['argmax_equal']}")
    if logit_err > tol:
        _fail("kernel path logits disagree with the plain versions")

    # 5. report -----------------------------------------------------------------
    def entry(name, r):
        src, replaces = SOURCES[name]
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=counts[name], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], shape=r["shape"])

    # representative shapes: the decode head product, the full prompt
    kernels = [entry("split_matmul", mm[-1]),
               entry("flash_attention", fl[-1])]
    out_path.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(f"serve metrics ({report['card']}): "
          f"{serve['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{serve['ttft_p50_ms']:.1f} ms max {serve['ttft_max_ms']:.1f} ms"
          f", prefill(512) {serve['prefill512_ms']:.1f} ms, decode step "
          f"({slots} slots) {serve['decode_step_ms']:.2f} ms, peak "
          f"{serve['peak_mem_gib']:.2f} GiB")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
