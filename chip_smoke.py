#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py [--seed 0] [--layers 0] [--requests 8]

Phases, each of which raises on failure (so the exit code is nonzero and
the final line is not printed):

1. build the CUDA kernels from `src/repro_torch/csrc` with nvcc for
   sm_90a (into `build/`) and print the build time;
2. hold each kernel against its plain PyTorch version on the card at the
   serve paths' shapes (phi4-mini-3.8b: K=3072 with N in {3072, 1024,
   16384, 200192}, K=8192 with N=3072, at prompt and slot row counts;
   attention (1, S, 8, 3, 128) causal at a ragged and a full prompt;
   mamba2-2.7b: K=2560 with N in {10240, 336, 50432} and K=5120 with
   N=2560 at the same row counts, the SSD scan (B, S, 80, 64) with state
   128, chunk 256, at (1, 333), (1, 512) and (8, 512)); print the
   `split_matmul` design each shape takes (fail if one takes the general
   first-version kernel); time kernel, plain version and one PyTorch
   library call where one computes the same function (device time from
   a CUDA graph of 20 calls, and the eager time with the host's launch
   cost, of the kernel's wrapper and of the model path's differentiable
   entry `ops.matmul` / `ops.attention` under no_grad); then the kernels' other options (f32, ragged shapes, each
   matmul design at its edge cases, the persistent design's ragged last
   row tile, N against bn, fewer tiles than SMs, tiles not a multiple of
   the blocks and split-K, windows, an initial state, hymba-1.5b's
   SSD shapes, the scan's chunk counts and lengths...); for `ssd_scan`
   also the device time of each of its three passes, a bit-identical
   repeat of one call, and no register spill in its kernels;
3. for each of phi4-mini-3.8b and mamba2-2.7b: plan it with
   `search_serve` for the h100-sxm preset, build it at full width with
   random bf16 weights from --seed, and serve --requests greedy requests
   of mixed prompt lengths through `ContinuousEngine`, launch counters
   zeroed just before and read just after each run; every request must
   end OK and the counts must be the ones the model's code implies;
4. on one prompt per model, check the kernel path's prefill logits
   against the same model run with the plain versions on the card, at
   full depth and on the first 4 layers of the same weights, with the
   residual stream's size and its reordering divergence by layer; a
   second prefill of the prompt must give identical logits (split-K
   sums its partials in a fixed order, with no atomics);
5. the kernels at qwen1.5-0.5b's training shapes (B*S = 32,768 rows):
   the `split_matmul` forward ("nn") at every layer product (q/k/v/o,
   w13, w2, and the chunked FFN's w13 chunk, d x 2 ff/4), its
   accumulating form (fp32 acc + x @ w) at the chunked FFN's w2 chunk,
   and `split_matmul_dgrad` and `split_matmul_wgrad` there and
   at the tied head's CE chunk (8 x 512 rows against the 152,064-row
   embedding, whose forward takes the "nt" layout, checked too), each
   backward against the plain version summed in the plan's split-K
   order; the accumulating form and dgrad take the persistent design
   (each row prints its plan: blocks, tile-order group, bn, ring stages,
   shared memory and the modelled memory bytes of both operands; the
   accumulating form's library call is `torch.addmm(acc, x, w,
   out_dtype=torch.float32)`), and its kernels show no register spill; `flash_attention` forward (output and logsumexp) and backward
   at (8, 4096, 16, 1, 64), causal; each timed as in phase 2 beside its
   bound and the library call (`torch.matmul`; SDPA's flash forward and
   its backward op, both by CUDA-graph replay); then the backward's
   other options (G 3 at hd 128, window 1024, ragged S and T, an
   offset, non-causal, a window of 17 at S 45; both matmul layouts at
   ragged and odd sizes in bf16 and f32), every repeated backward
   bit-identical; for the attention backward also no register spill in
   its kernels, its plan at the training shape (blocks, tiles, masked
   tile pairs, shared memory, scratch) and the device time of its three
   kernels (the row pass, the key-major kernel and the dq pass);
6. train qwen1.5-0.5b at full width and depth: plan it with `osdp` for
   train_4k at global batch 8 on a 1x1 mesh with 64 GiB and the h100-sxm
   preset (checkpointing "selective": the search co-decides remat,
   and picks none when everything fits) and print the decisions, remat
   bits and microbatch; the plan splits every layer op in 4, so each
   FFN runs `chunked_ffn` (4 chunks of the hidden, each w2 product
   added into one fp32 sum by `split_matmul`'s accumulating form); the
   regrouping copy of w13 is timed; check step 1's loss and every gradient leaf on
   the first 2 layers of the same weights and batch against the plain
   versions on the card (binding: within 4x their own reordering noise
   and at least 2e-2 of a leaf's norm); a repeated forward + backward
   must be bit-identical; then 5 AdamW steps through `train()` on
   `data/synthetic.py` batches, launch counters zeroed just before and
   read just after and held to the counts the plan implies; per step
   loss, grad norm, host ms (synchronised), tokens/s; MFU from the
   model FLOPs 6 N tokens + 12 L B S^2 d_attn / 2; peak memory; one more
   step under the profiler, device ms by bucket (split_matmul forward,
   its accumulating form, dgrad, wgrad, flash forward and backward,
   AdamW, plain torch), every accumulating and dgrad launch of the steps
   through the persistent design (launches counted by role and design);
   then
   3 steps of the same model under global remat (the planner's default
   checkpointing: every layer's forward again in the backward), with
   their launch counts, step time and peak; 3 steps under the plan the
   searcher returns at 20 GiB (a selective plan whose kept names tag no
   product of the layer body), whose losses must equal global remat's
   bit for bit; 3 steps under a hand-built mixed plan (the attention
   products kept, the rest recomputed), whose products are counted by
   tag (a kept one computed once a layer), whose peak must lie between
   global remat's and remat off's, and whose losses must match remat
   off's; then a checkpoint round trip at full width and 2 layers: 2
   steps saving every step, a resume to step 4 in a fresh run, losses
   equal to an uninterrupted 4-step run bit for bit, MB written and
   seconds to save and restore, and a corrupted leaf refused;
7. the OSDP plan sharded over torch.distributed: a world-1 NCCL group
   (a `file://` store under build/; the card is one GPU and NCCL refuses
   two ranks on one device, so every collective is a copy), then 3 steps
   each under the forced ZDP plan at remat off (phase 6's weights) and
   under the mixed DP/ZDP plan of tests/test_torch_train.py at remat on,
   sharded and on one device without a group: the ZDP plan's losses,
   grad norms and final parameters bit-identical, the mixed plan's
   losses within 1e-3; the kernel launches the plan's; the mesh's
   collectives the plan's (each sharded leaf 2 all-gathers and 1
   reduce-scatter a use, +1 gather in a recomputed layer; one all-reduce
   of the DP leaves and one of the norm a step) and a profiled step's
   NCCL calls the same; step ms and peak against one device and phase
   6, the peak within one device's plus twice the largest gathered
   weight;
8. calibration and the planner against the card: the three sweeps of
   `python -m repro_torch calibrate` at the committed h100-sxm profile's
   ladder (square bf16 products of 32 to 16,384 through `split_matmul`)
   and remat chain (depth 8, width 16,384, batch 64, plain and under
   `torch.utils.checkpoint`; forward, dgrad and wgrad through the
   kernels), launch counters zeroed just before and read just after and
   held to the counts the sweeps imply; a world-1 mesh moves no bytes
   and fits no link; no raw achieved rate above 989 TFLOP/s; each ladder
   product and the chain's three products against their plain
   versions; the checkpointed chain's gradients equal to the plain
   chain's bit for bit; the fitted profile round-trips JSON and the
   committed one loads through `store.load_and_register`; then phase
   6's 64 GiB and 20 GiB plans, phase 3's phi4 serve plan and phase 7's
   forced ZDP plan replanned with the preset and with the committed
   profile: the decisions that differ, the estimated step ms and GiB
   under each beside the measured step and peak, and the fitted remat
   factor beside the model's global remat step over its remat-off step
   (an estimate's error is reported, not a gate);
9. print a {"kernels": [...]} line, the card's name and power limit, the
   serve, train and calibration metrics, and last {"ok": true,
   "device": {...}}.

Tolerances: 2e-2 absolute + relative for `split_matmul` and
`flash_attention` in bf16 (one bf16 ulp of an O(1) output; the two sides
accumulate in fp32 in different orders).  `ssd_scan` returns fp32 from
bf16 inputs: its tensor-core products take each fp32 factor as two bf16
terms (three for f32 inputs), which its CPU emulation
(`ref.ssd_scan_split_ref`) puts at about 1e-5 of 1 + |y| against the
fp32 plain version (1.5e-6 with f32 inputs): 1e-3 absolute + relative,
1e-4 with f32 inputs.  For the full
models, where per-layer differences compound over the layers, the noise
floor is measured: the plain versions against themselves with their
sums in another order (one fp32 product instead of 512-wide K slices,
and an SSD chunk of 64 instead of the model's); the kernel path must
stay within 4x that floor, or 2e-2 of the largest logit if that is
larger.  Random deep stacks amplify that noise (at mamba2's 64 layers
the floor is about a quarter of the largest logit), so the check runs
again on the first 4 layers, where the floor is small.  A check whose
tolerance reaches the largest logit cannot fail and is reported as not
binding; each model must pass at least one binding check.  Details of
every phase go to --out (default build/chip_smoke.json).  Needs one
CUDA card; nothing of JAX.
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
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
ARCHS = ("phi4-mini-3.8b", "mamba2-2.7b")
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BW = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
KERNEL_TOL = 2e-2
SSD_TOL = 1e-3              # fp32 outputs of bf16 inputs (see above)
SSD_TOL_F32 = 1e-4
SSD_CHUNK_FLOOR = 64        # the plain scan's other chunk (noise floor)
# ssd_scan_bwd, ||kernel - plain|| / ||plain|| an output, and at least 4x
# the plain version's own noise at SSD_CHUNK_FLOOR: outputs in bf16 (dx,
# db, dc of bf16 inputs) 1e-3, under half a bf16 ulp (2^-9) on average;
# fp32 outputs 2e-4 (the bf16-term products keep about 2^-16 of each
# term; ddt measured 4e-6, da_log, a sum over every row of a head with
# cancellation, 5e-5)
SSD_BWD_TOL = 1e-3
SSD_BWD_TOL_F32 = 2e-4
SSD_BWD_NAMES = ("dx", "ddt", "da_log", "db", "dc")
SHALLOW = 4                 # layers of the second, shallow logit check
LOGIT_TOL = 2e-2            # of the largest logit, the least tolerance
LOGIT_FLOOR_FACTOR = 4      # x the plain version's own reordering noise
TRAIN_ARCH = "qwen1.5-0.5b"
SSM_TRAIN_ARCH = "mamba2-2.7b"  # phase 6b: the SSM family's training path
TRAIN_BATCH = 8             # x seq 4096: 32,768 tokens a step
TRAIN_STEPS = 5
REMAT_STEPS = 3             # the same steps under global remat, and
                            # under the selective and mixed plans
TRAIN_SPLIT = 4             # the plan's uniform operator split (phase 5
                            # checks its chunk shapes; phase 6 the plan)
SELECTIVE_GIB = 20.0        # below 25 GiB the searcher mixes remat bits
CKPT_LAYERS = 2             # depth of the checkpoint round trip
CKPT_STEPS = 2              # steps before the cut; the resume runs to 2x
GRAD_LAYERS = 2             # depth of the binding gradient check
GRAD_TOL = 2e-2             # of a gradient leaf's norm, the least tolerance
SHARD_STEPS = 3             # phase 7: steps a plan, sharded and not
SHARD_MIXED_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
                   "layers.ffn_w2", "head.out")
SHARD_MIXED = ("DP", "ZDP", "DP", "ZDP")    # tests/test_torch_train.py
MIXED_LOSS_TOL = 1e-3
# phase 8: the sweeps of the committed h100-sxm profile
# (`python -m repro_torch calibrate`), at its ladder and remat chain
CALIBRATE_PROFILE = "src/repro_torch/calibrate/profiles/h100-sxm.json"
CALIBRATE_LADDER = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
CALIBRATE_REMAT = (8, 16384, 64)            # depth, width, batch
CALIBRATE_REPEATS = 3
SOURCES = {
    "split_matmul": ("src/repro_torch/csrc/split_matmul.cu",
                     "src/repro/kernels/split_matmul.py:39"),
    "split_matmul_acc": ("src/repro_torch/csrc/split_matmul.cu",
                         "src/repro/kernels/split_matmul.py:39"),
    "split_matmul_dgrad": ("src/repro_torch/csrc/split_matmul.cu",
                           "src/repro/kernels/split_matmul.py:39"),
    "split_matmul_wgrad": ("src/repro_torch/csrc/split_matmul.cu",
                           "src/repro/kernels/split_matmul.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:80"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:62"),
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:62"),
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


def _ptxas(log: str) -> list:
    """One line a kernel from nvcc's `-Xptxas -v` output: its name (the
    template arguments kept) with its registers, spills and static
    shared memory."""
    import re
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            # name<template args> from the mangled name in the anonymous
            # namespace: ..._cu_<8 hex><len><id>[<len><id>...]I<args>E...
            rest = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "",
                          m.group(1))
            ids = []
            while rest[:1].isdigit():
                n = int(re.match(r"\d+", rest).group())
                rest = rest[len(str(n)):]
                ids.append(rest[:n])
                rest = rest[n:]
            args = [a or ("bf16" if b else "float") for a, b, _ in
                    re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(^If)",
                               rest.split("EEv")[0])] \
                if rest.startswith("I") else []
            name = "::".join(ids) + (f"<{', '.join(args)}>" if args else "")
        elif name and ("spill" in ln or "registers" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}"
                       if "ptxas info" in ln else f"{name}: {ln.strip()}")
    return out


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


def _graph_ms(torch, fn, args_list, iters=20) -> float:
    """Device time of fn(*args) per call: `iters` calls (cycling through
    `args_list`) captured in one CUDA graph, one replay timed with CUDA
    events.  Unlike `_time_ms` no host work is timed, so a product that
    takes less device time than Python takes to launch it still reads
    its own time."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phase 2: kernels against their plain versions --------------------------

def check_split_matmul(torch, M, K, N, gen):
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import split_matmul as sm
    dev = "cuda"
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    w_bytes = K * N * 2
    copies = max(1, min(8, math.ceil(120e6 / w_bytes)))
    ws = [(torch.randn(K, N, generator=gen, device=dev) / math.sqrt(K))
          .to(torch.bfloat16) for _ in range(copies)]
    plan = sm.plan_for(x, ws[0], 512)
    if plan.variant == "general":
        _fail(f"split_matmul {M}x{K}x{N}: a path shape took the general "
              f"kernel ({plan.reason})")
    y = sm.split_matmul(x, ws[0])
    torch.cuda.synchronize()
    y_ref = ref.split_matmul_ref(x, ws[0])
    err = (y.float() - y_ref.float()).abs()
    bad = err > KERNEL_TOL + KERNEL_TOL * y_ref.float().abs()
    if not torch.isfinite(y.float()).all() or bad.any():
        _fail(f"split_matmul {M}x{K}x{N}: max error {err.max().item()} "
              f"beyond {KERNEL_TOL} abs+rel")
    args = [(x, w) for w in ws]
    ms = _graph_ms(torch, sm.split_matmul, args)
    eager_ms = _time_ms(torch, sm.split_matmul, args)
    with torch.no_grad():      # the model path's entry, as serving calls it
        path_eager_ms = _time_ms(torch, ops.matmul, args)
    plain_ms = _time_ms(torch, ref.split_matmul_ref, args, iters=5)
    lib_ms = _graph_ms(torch, torch.matmul, args)
    flops = 2.0 * M * N * K
    nbytes = 2.0 * (M * K + K * N + M * N)
    return dict(shape=[M, K, N], max_abs_err=err.max().item(), ms=ms,
                eager_ms=eager_ms, path_eager_ms=path_eager_ms,
                variant=plan.variant, bn=plan.bn,
                splits=plan.splits, blocks=plan.blocks,
                plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BW),
                bound_by="operations" if flops / PEAK_BF16
                > nbytes / PEAK_BW else "bytes")


def check_split_matmul_acc(torch, M, K, N, gen):
    """The accumulating form y = acc + x @ w (fp32 acc and y) at one
    shape, against its plain version on the same inputs, repeated
    bit-identically, timed beside its bound and the library call that
    computes the same function, `torch.addmm(acc, x, w,
    out_dtype=torch.float32)` (where this torch refuses it, `torch.matmul`
    of the same product with bf16 out stands in, and the row says so)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_matmul as sm
    x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)
         ).to(torch.bfloat16)
    acc = torch.randn(M, N, generator=gen, device="cuda")
    plan = sm.plan_for(x, w, 512, role="acc")
    if plan.variant == "general":
        _fail(f"split_matmul acc {M}x{K}x{N}: a path shape took the general "
              f"kernel ({plan.reason})")
    library, lib_call = "torch.addmm(acc, x, w, out_dtype=torch.float32)", \
        lambda: torch.addmm(acc, x, w, out_dtype=torch.float32)
    try:
        lib_call()
    except (TypeError, RuntimeError) as e:
        print(f"  split_matmul acc {M}x{K}x{N}: {library} refused ({e}); "
              f"torch.matmul with bf16 out stands in")
        library, lib_call = ("torch.matmul (bf16 out, a stand-in)",
                             lambda: torch.matmul(x, w))
    y = sm.split_matmul(x, w, acc=acc)
    torch.cuda.synchronize()
    want = ref.split_matmul_ref(x, w, bk=512, acc=acc)
    err = (y - want).abs()
    if y.dtype != torch.float32 or not torch.isfinite(y).all() or (
            err > KERNEL_TOL + KERNEL_TOL * want.abs()).any():
        _fail(f"split_matmul acc {M}x{K}x{N}: max error "
              f"{err.max().item()} beyond {KERNEL_TOL} abs+rel")
    if not torch.equal(y, sm.split_matmul(x, w, acc=acc)):
        _fail(f"split_matmul acc {M}x{K}x{N}: two calls on the same inputs "
              f"differ")
    kern = lambda: sm.split_matmul(x, w, acc=acc)
    flops = 2.0 * M * N * K
    nbytes = 2.0 * (M * K + K * N) + 8.0 * M * N   # acc read, y written
    bound_ms, bound_by = _bound(flops, nbytes)
    return dict(shape=[M, K, N], acc=True, max_abs_err=err.max().item(),
                ms=_graph_ms(torch, kern, [()]),
                eager_ms=_time_ms(torch, kern, [()]),
                plain_ms=_time_ms(torch, lambda: ref.split_matmul_ref(
                    x, w, bk=512, acc=acc), [()], iters=3),
                library_ms=_graph_ms(torch, lib_call, [()]),
                library=library,
                bf16_out_ms=_graph_ms(torch, lambda: sm.split_matmul(x, w),
                                      [()]),
                bound_ms=bound_ms, bound_by=bound_by, **_plan_fields(plan))


def _plan_fields(plan) -> dict:
    """The launch plan's fields a report row carries: the design, its
    tile and split, and for the persistent design its blocks, tile-order
    group, ring stages, shared memory and modelled operand bytes."""
    return dict(variant=plan.variant, bn=plan.bn, splits=plan.splits,
                blocks=plan.blocks, group=plan.group, stages=plan.stages,
                smem=plan.smem, row_bytes=plan.row_bytes,
                col_bytes=plan.col_bytes)


def _plan_text(r) -> str:
    """A report row's plan as the phase prints it."""
    text = (f" [{r['variant']} bn {r['bn']} x {r['splits']} splits, "
            f"{r['blocks']} blocks")
    if r.get("variant") == "persistent":
        text += (f", group {r['group']}, {r['stages']} stages, "
                 f"{r['smem']} B shared, modelled HBM reads A "
                 f"{r['row_bytes'] / 1e6:.1f} MB, B "
                 f"{r['col_bytes'] / 1e6:.1f} MB")
    return text + "]"


def check_flash(torch, S, gen, KV=8, G=3, hd=128, B=1):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    dev = "cuda"
    q = torch.randn(B, S, KV, G, hd, generator=gen, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn(B, S, KV, hd, generator=gen, device=dev
                    ).to(torch.bfloat16)
    v = torch.randn(B, S, KV, hd, generator=gen, device=dev
                    ).to(torch.bfloat16)
    o = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_ref = ref.flash_attention_ref(q, k, v, causal=True)
    err = (o.float() - o_ref.float()).abs()
    bad = err > KERNEL_TOL + KERNEL_TOL * o_ref.float().abs()
    if not torch.isfinite(o.float()).all() or bad.any():
        _fail(f"flash_attention {(B, S, KV, G, hd)}: max error "
              f"{err.max().item()} beyond {KERNEL_TOL} abs+rel")

    def kern(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def plain(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=True)

    # the library yardstick in its own (B, H, S, hd) layout, kv heads
    # repeated per group; the layout change is not timed
    qh = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def path(q, k, v):
        return ops.attention(q, k, v, causal=True)

    ms = _graph_ms(torch, kern, [(q, k, v)])
    eager_ms = _time_ms(torch, kern, [(q, k, v)])
    with torch.no_grad():      # the model path's entry, as serving calls it
        path_eager_ms = _time_ms(torch, path, [(q, k, v)])
    plain_ms = _time_ms(torch, plain, [(q, k, v)], iters=5)
    lib_ms = _graph_ms(torch, sdpa, [(qh, kh, vh)])
    H = KV * G
    flops = 4.0 * hd * B * H * S * (S + 1) / 2  # causal: s+1 keys per row
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    return dict(shape=[B, S, KV, G, hd], max_abs_err=err.max().item(),
                ms=ms, eager_ms=eager_ms, path_eager_ms=path_eager_ms,
                plain_ms=plain_ms,
                library_ms=lib_ms,
                bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BW),
                bound_by="operations" if flops / PEAK_BF16
                > nbytes / PEAK_BW else "bytes")


def _ssd_inputs(torch, gen, B, S, nh, hd, ns, dtype=None, init=False):
    """Inputs of the scan as the model makes them: x, b, c slices of one
    conv output row (bf16), dt a softplus in fp32, a_log U[0, log 16)."""
    dtype = dtype or torch.bfloat16
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    conv = (r(B, S, nh * hd + 2 * ns) * 0.5).to(dtype)
    x = conv[..., :nh * hd].reshape(B, S, nh, hd)
    b, c = conv[..., nh * hd:nh * hd + ns], conv[..., nh * hd + ns:]
    dt = torch.nn.functional.softplus(r(B, S, nh) - 1.0)
    a_log = torch.rand(nh, generator=gen, device="cuda") * math.log(16.0)
    s0 = r(B, nh, hd, ns) if init else None
    return (x, dt, a_log, b, c), s0


def _ssd_err(torch, got, want, tol, what):
    """(max |got - want|, max |got - want| / (1 + |want|)) over y and the
    final state; fails when the second is beyond `tol`."""
    err = scaled = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            _fail(f"ssd_scan {what}: non-finite output")
        d = (g - w).abs()
        err = max(err, d.max().item())
        scaled = max(scaled, (d / (1 + w.abs())).max().item())
    if scaled > tol:
        _fail(f"ssd_scan {what}: error {scaled:.3g} beyond {tol} abs+rel")
    return err, scaled


def ssd_flops(B, S, nh, hd, ns, chunk) -> tuple:
    """(forward, backward) operations of the scan's least work, the
    masked half of each chunk's square not counted (tri rows x columns a
    chunk): forward c.b once per (batch, chunk) and per head the intra
    product, the chunk states and the carried term; backward c.b, dc and
    db from the head-summed dCB once, and per head the two intra
    products (dy . xd^T and (CB L)^T dy) and six (hd x ns) products over
    the rows (the chunk states again, dS_y, e dy P, c P^T for dcsum,
    b D^T, w xd D)."""
    Q = min(chunk, S)
    tri = sum(n * (n + 1) / 2 for n in
              [Q] * (S // Q) + ([S % Q] if S % Q else []))
    fwd = 2.0 * B * (tri * ns + nh * (tri * hd + 2 * S * hd * ns))
    bwd = 2.0 * B * (3 * tri * ns + nh * (2 * tri * hd + 6 * S * hd * ns))
    return fwd, bwd


def check_ssd(torch, B, S, gen, nh=80, hd=64, ns=128, chunk=256):
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    args, _ = _ssd_inputs(torch, gen, B, S, nh, hd, ns)
    y, fin = sk.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    want = ref.ssd_scan_ref(*args, chunk=chunk)
    err, scaled = _ssd_err(torch, (y, fin), want, SSD_TOL,
                           f"{(B, S, nh, hd, ns)}")

    def kern(*a):
        return sk.ssd_scan(*a, chunk=chunk)

    def plain(*a):
        return ref.ssd_scan_ref(*a, chunk=chunk)

    ms = _graph_ms(torch, kern, [args])
    eager_ms = _time_ms(torch, kern, [args])
    plain_ms = _time_ms(torch, plain, [args], iters=5 if B * S < 8192 else 1)
    flops = ssd_flops(B, S, nh, hd, ns, chunk)[0]
    nbytes = (2.0 * (B * S * nh * hd + 2 * B * S * ns)     # bf16 x, b, c
              + 4.0 * (B * S * nh + nh)                     # fp32 dt, a_log
              + 4.0 * (B * S * nh * hd + B * nh * hd * ns))  # fp32 y, state
    plan = sk.plan_launch(B, S, nh, hd, ns, chunk)
    return dict(shape=[B, S, nh, hd, ns, chunk], max_abs_err=err,
                max_scaled_err=scaled, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, library_ms=None,
                head_group=plan.head_group, blocks=list(plan.blocks),
                workspace_bytes=plan.workspace_bytes,
                bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BW),
                bound_by="operations" if flops / PEAK_BF16
                > nbytes / PEAK_BW else "bytes",
                flops=flops, bytes=nbytes)


def check_ssd_design(torch, gen, mam) -> dict:
    """`ssd_scan` beyond agreement at the path's shapes: no register
    spill in its kernels, a repeated call bit-identical, and the device
    time of each of its three passes at (1, 512) (profiler, 20 calls)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _lib
    from repro_torch.kernels import ssd_scan as sk
    nh, hd, ns, chunk = (mam.ssm_n_heads, mam.ssm_head_dim, mam.ssm_state,
                         mam.ssm_chunk)
    spills = [ln for ln in _ptxas(_lib.build_log) if "ssd_scan" in ln
              and any(int(v) for v in re.findall(
                  r"(\d+) bytes spill (?:stores|loads)", ln))]
    if spills:
        _fail(f"ssd_scan kernels spill registers: {spills}")
    args, _ = _ssd_inputs(torch, gen, 1, 512, nh, hd, ns)
    first = sk.ssd_scan(*args, chunk=chunk)
    again = sk.ssd_scan(*args, chunk=chunk)
    if not all(torch.equal(u, v) for u, v in zip(first, again)):
        _fail("ssd_scan: two calls on the same inputs differ")
    sk.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    calls = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sk.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
    passes = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and "ssd_scan" in ev.key:
            name = next((k for k in ("states", "pass", "chunk")
                         if f"ssd_scan_{k}_kernel" in ev.key), ev.key)
            passes[name] = (passes.get(name, 0.0)
                            + ev.self_device_time_total / 1e3 / calls)
    if sorted(passes) != ["chunk", "pass", "states"]:
        _fail(f"ssd_scan: profiler saw kernels {sorted(passes)}")
    return dict(bit_identical=True, pass_ms=passes,
                kernels_per_call=len(passes))


def _rel_errs(torch, got, want) -> list:
    """||got - want|| / ||want|| of each output, in fp32."""
    return [((g.float() - w.float()).norm()
             / w.float().norm().clamp_min(1e-30)).item()
            for g, w in zip(got, want)]


def check_ssd_bwd(torch, gen, B, S, nh=80, hd=64, ns=128, chunk=256,
                  dtype=None, dfin=False, init=False, timed=True,
                  autograd=False) -> dict:
    """`ssd_scan_bwd` against `ref.ssd_scan_bwd_ref` on the same inputs
    (and, with `autograd`, torch autograd of `ref.ssd_scan_ref`), each
    output within SSD_BWD_TOL (bf16 outputs) or SSD_BWD_TOL_F32 of its
    norm and within 4x the plain version's own noise (the plain backward
    at chunk SSD_CHUNK_FLOOR against the model's chunk); a repeated call
    bit-identical; with `timed`, its time (CUDA graph and eager), the
    plain version's and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as sk
    args, s0 = _ssd_inputs(torch, gen, B, S, nh, hd, ns, dtype, init)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    dy = r(B, S, nh, hd)
    df = r(B, nh, hd, ns) if dfin else None
    kw = dict(chunk=chunk, d_final_state=df, init_state=s0)
    what = f"ssd_scan_bwd {(B, S, nh, hd, ns, chunk)} {args[0].dtype}"
    got = sk.ssd_scan_bwd(*args, dy, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in
               zip(got, sk.ssd_scan_bwd(*args, dy, **kw))):
        _fail(f"{what}: two calls on the same inputs differ")
    want = ref.ssd_scan_bwd_ref(*args, dy, **kw)
    floor = _rel_errs(torch, ref.ssd_scan_bwd_ref(
        *args, dy, **dict(kw, chunk=SSD_CHUNK_FLOOR)), want)
    errs = _rel_errs(torch, got, want)
    f32 = args[0].dtype == torch.float32
    tols = [max(LOGIT_FLOOR_FACTOR * fl, SSD_BWD_TOL_F32
                if f32 or n in ("ddt", "da_log") else SSD_BWD_TOL)
            for n, fl in zip(SSD_BWD_NAMES, floor)]
    checks = [("plain", errs)]
    if autograd:
        ts = [t.detach().clone().requires_grad_(True) for t in args]
        y, fin = ref.ssd_scan_ref(*ts, chunk=chunk, init_state=s0)
        loss = (y * dy).sum() + ((fin * df).sum() if dfin else 0.0)
        checks.append(("autograd", _rel_errs(
            torch, got, torch.autograd.grad(loss, ts))))
        del ts, y, fin, loss
    for name, es in checks:
        for n, e, t, g in zip(SSD_BWD_NAMES, es, tols, got):
            if not torch.isfinite(g).all() or not e <= t:
                _fail(f"{what}: {n} off the {name} version by {e:.3g} of "
                      f"its norm (tol {t:.3g})")
    max_abs = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    out = dict(shape=[B, S, nh, hd, ns, chunk], dtype=str(args[0].dtype),
               dfin=dfin, init=init, max_abs_err=max_abs,
               rel_errs=dict(zip(SSD_BWD_NAMES, errs)),
               floors=dict(zip(SSD_BWD_NAMES, floor)),
               tols=dict(zip(SSD_BWD_NAMES, tols)),
               autograd_errs=(dict(zip(SSD_BWD_NAMES, checks[1][1]))
                              if autograd else None))
    del got, want
    if not timed:
        return out
    kern = lambda: sk.ssd_scan_bwd(*args, dy, **kw)
    plain = lambda: ref.ssd_scan_bwd_ref(*args, dy, **kw)
    es = 2 if args[0].dtype == torch.bfloat16 else 4
    nbytes = (es * (2 * B * S * nh * hd + 4 * B * S * ns)  # x, dx; b, c, db, dc
              + 4.0 * (2 * B * S * nh + 2 * nh)          # dt, ddt; a_log, da
              + 4.0 * B * S * nh * hd                    # fp32 dy
              + 4.0 * B * nh * hd * ns * (dfin + init))
    flops = ssd_flops(B, S, nh, hd, ns, chunk)[1]
    bound_ms, bound_by = _bound(flops, nbytes)
    out.update(ms=_graph_ms(torch, kern, [()], iters=5 if B * S > 8192
                            else 20),
               eager_ms=_time_ms(torch, kern, [()], iters=5, warmup=1),
               plain_ms=_time_ms(torch, plain, [()], iters=1, warmup=1),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
               flops=flops, bytes=nbytes,
               workspace_bytes=sk.plan_bwd(B, S, nh, hd, ns, chunk,
                                           str(args[0].dtype)[6:])
               .workspace_bytes)
    return out


def check_ssd_bwd_design(torch, gen, B, S, nh, hd, ns, chunk) -> dict:
    """No register spill in the backward's kernels (their `-Xptxas -v`
    lines), the persistent chunk-term kernels' plan at (B, S) (head
    groups, items, blocks, shared memory), and the device time of each of
    its eight kernels a call there (profiler, 3 calls)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _lib
    from repro_torch.kernels import ssd_scan as sk
    lines = [ln for ln in _ptxas(_lib.build_log) if "ssd_bwd" in ln]
    spills = [ln for ln in lines if any(int(v) for v in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", ln))]
    if not lines or spills:
        _fail(f"ssd_scan_bwd kernels spill registers (or none built): "
              f"{spills or lines}")
    args, _ = _ssd_inputs(torch, gen, B, S, nh, hd, ns)
    dy = torch.randn(B, S, nh, hd, generator=gen, device="cuda")
    sk.ssd_scan_bwd(*args, dy, chunk=chunk)
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sk.ssd_scan_bwd(*args, dy, chunk=chunk)
        torch.cuda.synchronize()
    names = {"ssd_scan_states_kernel": "F1 states", "ssd_scan_pass_kernel":
             "F2 pass", "ssd_bwd_dstate_kernel": "B1 dstate",
             "ssd_bwd_pass_kernel": "B2 pass",
             "ssd_bwd_cols_kernel": "B3a columns",
             "ssd_bwd_rows_kernel": "B3b rows",
             "ssd_bwd_finish_kernel": "B4 finish",
             "ssd_bwd_da_kernel": "B5 da"}
    kernel_ms = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        k = next((v for n, v in names.items() if n in ev.key), None)
        if k:
            kernel_ms[k] = (kernel_ms.get(k, 0.0)
                            + ev.self_device_time_total / 1e3 / calls)
    if sorted(kernel_ms) != sorted(names.values()):
        _fail(f"ssd_scan_bwd: profiler saw kernels {sorted(kernel_ms)}")
    p = sk.plan_bwd(B, S, nh, hd, ns, chunk)
    plan = dict(groups=p.groups, heads_per_group=p.heads_per_group,
                col_items=p.col_items, row_items=p.row_items,
                col_blocks=p.grids[3][0], row_blocks=p.grids[4][0],
                head_stages=p.head_stages, smem=[p.smem[3], p.smem[4]])
    return dict(ptxas=lines, kernel_ms=kernel_ms,
                kernels_per_call=len(kernel_ms), plan=plan)


# (B, S, dtype, d_final_state, initial state, what it exercises) of
# `ssd_scan_bwd` at mamba2's widths off the training path
SSD_BWD_CASES = (
    (2, 100, "bfloat16", True, False, "S < chunk, B = 2"),
    (1, 300, "float32", True, False, "f32 inputs, ragged S"),
    (1, 1000, "bfloat16", True, True,
     "4 chunks, the last ragged, an initial state"),
)


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
            plan = sm.plan_for(x, w, bk)
            if plan.variant == "general":
                print(f"  split_matmul {M}x{K}x{N} {dtype}: general kernel "
                      f"({plan.reason})")
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
    # bf16 cases of the two designs: each must take the design named
    n += check_matmul_designs(torch, gen)
    for B, S, T, KV, G, hd, causal, window, q_off in (
            (1, 333, 333, 8, 3, 64, True, 0, 0),       # hd 64, path size
            (1, 200, 200, 2, 4, 128, True, 70, 0),     # window over tiles
            (1, 100, 300, 1, 3, 128, True, 0, 200),    # q_offset, T > S
            (2, 130, 300, 2, 1, 64, False, 0, 0)):     # non-causal T != S
        q = torch.randn(B, S, KV, G, hd, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        k = torch.randn(B, T, KV, hd, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        v = torch.randn(B, T, KV, hd, generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        o = fa.flash_attention(q, k, v, **kw).float()
        o_ref = ref.flash_attention_ref(q, k, v, **kw).float()
        if not torch.allclose(o, o_ref, atol=KERNEL_TOL, rtol=KERNEL_TOL):
            _fail(f"flash_attention bf16 {(B, S, T, KV, G, hd)} {kw}: max "
                  f"error {(o - o_ref).abs().max().item()}")
        n += 1
    # the scan: f32 inputs, an initial state, S shorter than one chunk,
    # B = 2, and hymba-1.5b's heads (64 of 50, state 16); then SSD_CASES
    from repro_torch.kernels import ssd_scan as sk
    for B, S, nh, hd, ns, chunk, dtype, init in (
            (2, 77, 8, 32, 16, 32, torch.float32, True),
            (1, 20, 8, 32, 16, 32, torch.float32, False),
            (2, 300, 80, 64, 128, 256, torch.bfloat16, True),
            (1, 100, 80, 64, 128, 256, torch.bfloat16, False),
            (1, 333, 64, 50, 16, 256, torch.bfloat16, False),
            (2, 512, 64, 50, 16, 256, torch.float32, True)) + tuple(
                case[:-1] for case in SSD_CASES):
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        args, s0 = _ssd_inputs(torch, gen, B, S, nh, hd, ns, dtype, init)
        got = sk.ssd_scan(*args, chunk=chunk, init_state=s0)
        want = ref.ssd_scan_ref(*args, chunk=chunk, init_state=s0)
        _ssd_err(torch, got, want,
                 SSD_TOL_F32 if dtype == torch.float32 else SSD_TOL,
                 f"{(B, S, nh, hd, ns, chunk)} {dtype} init={init}")
        n += 1
    return n


# (B, S, nh, hd, ns, chunk, dtype, init, what it exercises) of `ssd_scan`
# off the serve path (mamba2's widths unless named); dtype by name
SSD_CASES = (
    (2, 1000, 80, 64, 128, 256, "bfloat16", True,
     "4 chunks, the last ragged (232 rows), an initial state"),
    (1, 1, 80, 64, 128, 256, "bfloat16", False, "S = 1"),
    (1, 256, 80, 64, 128, 256, "bfloat16", True, "S = chunk exactly"),
    (1, 2048, 80, 64, 128, 64, "bfloat16", False,
     "chunk 64: 32 chunks, a long state pass"),
    (1, 512, 80, 64, 128, 256, "float32", False, "f32 inputs"),
    (1, 300, 4, 128, 64, 128, "bfloat16", True, "head dim 128"),
    (1, 700, 6, 72, 20, 1024, "bfloat16", True,
     "chunk 1024, head dim 72, state 20"),
)


# (M, K, N, bk, design, what it exercises), all bf16
MATMUL_DESIGN_CASES = (
    (1, 1024, 512, 512, "stream", "M = 1"),
    (16, 2048, 1024, 512, "stream", "M = 16"),
    (17, 1536, 384, 512, "stream", "M = 17"),
    (64, 3072, 1024, 512, "stream", "M = 64, the last stream row count"),
    (65, 3072, 1024, 512, "wgmma", "M = 65, the first wgmma row count"),
    (8, 3000, 512, 512, "stream", "K not a multiple of splits x bk"),
    (200, 2600, 256, 512, "wgmma", "K not a multiple of splits x bk"),
    (8, 2048, 256, 512, "stream", "bk = K/4: a split-4 plan"),
    (256, 4096, 128, 1024, "wgmma", "bk = K/4: a split-4 plan"),
    (8, 1000, 336, 40, "stream", "bk not a multiple of 32"),
    (100, 1000, 336, 100, "wgmma", "bk not a multiple of 8"),
    (5, 600, 64, 13, "stream", "bk odd"),
    (300, 4096, 336, 512, "wgmma", "N = 336 against a 128 tile"),
    (129, 3072, 3000, 512, "wgmma", "ragged M and N against a 192 tile"),
    (200, 8192, 2000, 512, "wgmma", "ragged N against a 256 tile, split 8"),
)


# the accumulating form (fp32 y = acc + x @ w) in each design's epilogue
# and in the split-K reduce: (M, K, N, bk, dtype, design, what)
ACC_CASES = (
    (8, 704, 1024, 512, "bfloat16", "stream", "acc, decode rows, split-K"),
    (1, 3072, 8192, 512, "bfloat16", "stream", "acc, M = 1, 6 splits"),
    (256, 8192, 256, 512, "bfloat16", "persistent",
     "acc, split-K reduce (16 splits)"),
    (129, 704, 72, 512, "bfloat16", "persistent", "acc, ragged M and N"),
    (32845, 704, 1024, 512, "bfloat16", "persistent",
     "acc, a ragged last row tile at the path's width"),
    (300, 704, 1000, 512, "bfloat16", "persistent",
     "acc, N not a multiple of bn, fewer tiles than SMs"),
    (4000, 704, 2000, 512, "bfloat16", "persistent",
     "acc, tiles not a multiple of the blocks"),
    (200, 2600, 520, 512, "bfloat16", "persistent",
     "acc, split-K with a short last slice"),
    (300, 1000, 256, 100, "bfloat16", "persistent",
     "acc, bk 100: slices cut inside a k-step (one slice of all of K)"),
    (100, 36, 20, 512, "bfloat16", "general", "acc, N not a multiple of 8"),
    (300, 100, 56, 512, "float32", "general", "acc, float32"),
)


def check_matmul_designs(torch, gen) -> int:
    """`split_matmul` off the path in bf16: each case must take the
    design it names (never the general kernel) and agree with the plain
    version, with the same K slices, at 2e-2 abs+rel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_matmul as sm
    for M, K, N, bk, design, what in MATMUL_DESIGN_CASES:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(K, N, generator=gen, device="cuda")
             / math.sqrt(K)).bfloat16()
        plan = sm.plan_for(x, w, bk)
        if plan.variant != design:
            _fail(f"split_matmul {M}x{K}x{N} bk={bk} ({what}): took "
                  f"{plan.variant}, not {design}")
        y = sm.split_matmul(x, w, bk=bk).float()
        y_ref = ref.split_matmul_ref(x, w, bk=bk).float()
        if not torch.allclose(y, y_ref, atol=KERNEL_TOL, rtol=KERNEL_TOL):
            _fail(f"split_matmul {M}x{K}x{N} bk={bk} ({what}, {design}, "
                  f"{plan.splits} splits): max error "
                  f"{(y - y_ref).abs().max().item()}")
    for M, K, N, bk, dtype, design, what in ACC_CASES:
        dt = getattr(torch, dtype)
        x = torch.randn(M, K, generator=gen, device="cuda").to(dt)
        w = (torch.randn(K, N, generator=gen, device="cuda")
             / math.sqrt(K)).to(dt)
        acc = torch.randn(M, N, generator=gen, device="cuda")
        plan = sm.plan_for(x, w, bk, role="acc")
        y = sm.split_matmul(x, w, bk=bk, acc=acc)
        y_ref = ref.split_matmul_ref(x, w, bk=bk, acc=acc)
        if plan.variant != design or y.dtype != torch.float32 or \
                not torch.allclose(y, y_ref, atol=KERNEL_TOL,
                                   rtol=KERNEL_TOL) or \
                not torch.equal(y, sm.split_matmul(x, w, bk=bk, acc=acc)):
            _fail(f"split_matmul {M}x{K}x{N} {dtype} ({what}): took "
                  f"{plan.variant} ({design} expected, {plan.splits} "
                  f"splits), {y.dtype}, max error "
                  f"{(y - y_ref).abs().max().item()}, or a repeat differs")
    return len(MATMUL_DESIGN_CASES) + len(ACC_CASES)


@contextlib.contextmanager
def plain_versions(bk=512, ssd_chunk=None, bq=512):
    """Route the model's kernel calls, forward and backward, to the plain
    versions on the card (for the whole-model comparisons only; the port
    itself never does).  `bk` sets the plain forward matmul's K slice
    (None: one fp32 product), `ssd_chunk` the plain scan's chunk (None:
    the model's), `bq` the plain attention's query block: each an order
    of summation."""
    from repro_torch.kernels import ops, ref
    names = ("split_matmul", "split_matmul_dgrad", "split_matmul_wgrad",
             "flash_attention", "flash_attention_bwd", "ssd_scan",
             "ssd_scan_bwd")
    saved = [getattr(ops, n) for n in names]
    ops.split_matmul = lambda x, w, transpose_w=False, acc=None, **_: \
        ref.split_matmul_ref(x, w.t() if transpose_w else w, bk=bk, acc=acc)
    ops.split_matmul_dgrad = lambda dy, w, **kw: \
        ref.split_matmul_dgrad_ref(dy.contiguous(), w, bk=bk, **kw)
    ops.split_matmul_wgrad = lambda x, dy, **kw: \
        ref.split_matmul_wgrad_ref(x, dy.contiguous(), bk=bk, **kw)
    ops.flash_attention = lambda q, k, v, **kw: ref.flash_attention_ref(
        q, k, v, bq=bq, **kw)
    ops.flash_attention_bwd = lambda *a, **kw: ref.flash_attention_bwd_ref(
        *[t.contiguous() for t in a], bq=bq, **kw)
    ops.ssd_scan = lambda *a, chunk, init_state=None: ref.ssd_scan_ref(
        *a, chunk=ssd_chunk or chunk, init_state=init_state)
    ops.ssd_scan_bwd = lambda *a, chunk, **kw: ref.ssd_scan_bwd_ref(
        *a, chunk=ssd_chunk or chunk, **kw)
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(ops, n, fn)


def profile_split(torch, fn) -> dict:
    """Device time of one call of `fn` by kernel (torch.profiler), and
    the share of the call's wall time the device was busy.  Only the
    device's own rows are summed: a host-side row (an aten op, a launch
    call) also carries the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    out = {"split_matmul": 0.0, "flash_attention": 0.0, "ssd_scan": 0.0,
           "other": 0.0}
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if ev.device_type != DeviceType.CUDA or us <= 0:
            continue
        key = ("split_matmul" if "split_matmul" in ev.key else
               "flash_attention" if "flash_bf16" in ev.key
               or "flash_f32" in ev.key else
               "ssd_scan" if "ssd_scan" in ev.key else "other")
        out[key] += us / 1e3
    busy = sum(out.values())
    out["wall_ms"] = wall_ms
    out["device_busy_share"] = busy / wall_ms if busy else None
    return out


def serve_phase(torch, np, arch, args) -> dict:
    """Plan `arch` for one H100, build it at full width (depth cut by
    --layers), serve --requests greedy requests through
    `ContinuousEngine` with the launch counts zeroed just before and
    read just after, and time a prefill and a decode step."""
    from repro_torch.configs import (DeviceInfo, MeshConfig, OSDPConfig,
                                     RunConfig, get_arch, get_shape)
    from repro_torch.core.api import search_serve
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import OK, ContinuousEngine, Request

    rng = np.random.default_rng(args.seed)
    prompt_max, new_max = 512, 32
    cfg_full = get_arch(arch)
    plan = search_serve(cfg_full, prompt_len=prompt_max, decode_len=new_max,
                        n_devices=1, memory_limit_gib=64.0,
                        device=DeviceInfo.preset("h100-sxm"))
    print(plan.summary())
    if not plan.feasible:
        _fail(f"{arch}: serve plan infeasible")
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
    print(f"model: {arch} {cfg.n_layers} layers, d={cfg.d_model}, "
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
        _fail(f"{arch}: {len(bad)} requests not OK: "
              f"{[(r.rid, r.status, r.error) for r in bad]}")
    for r in results:
        toks = r.tokens
        if len(toks) != reqs[r.rid].max_new_tokens or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            _fail(f"{arch} request {r.rid}: bad tokens {toks}")
    # the launches the model's code implies: per layer 4 products (q, k,
    # v, o) in attention, 3 (w_zx, w_bcdt, wo) in the SSD block, 2 (w13,
    # w2) in the FFN, plus the head; attention and the scan once a layer
    # in each prefill (decode runs plain torch there)
    L, passes = cfg.n_layers, stats.prefill_steps + stats.decode_steps
    per_pass = L * (4 * cfg.has_attention + 3 * cfg.has_ssm
                    + 2 * bool(cfg.d_ff)) + 1
    want = {"split_matmul": per_pass * passes, "split_matmul_acc": 0,
            "flash_attention": L * stats.prefill_steps
            if cfg.has_attention else 0,
            "ssd_scan": L * stats.prefill_steps if cfg.has_ssm else 0}
    single = not any(lay.is_split
                     for lay in built.model.pset.layouts.values())
    for name, n in want.items():
        if (name != "split_matmul" or single) and counts[name] != n:
            _fail(f"{arch}: {name} ran {counts[name]} times, the path "
                  f"needs {n}")
        if name == "split_matmul" and counts[name] < 1:
            _fail(f"{arch}: split_matmul never ran")
    ttft = sorted(r.ttft_s for r in results)
    serve = dict(arch=arch, requests=len(results), slots=slots,
                 plan_slots=plan.max_slots_per_device,
                 prompt_lens=[int(x) for x in lens],
                 new_tokens=[int(x) for x in news],
                 useful_tokens=stats.useful_tokens, wall_s=stats.wall_s,
                 tokens_per_s=stats.tokens_per_s,
                 prefill_steps=stats.prefill_steps,
                 decode_steps=stats.decode_steps,
                 ttft_p50_ms=1e3 * ttft[len(ttft) // 2],
                 ttft_max_ms=1e3 * ttft[-1],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                 launches=counts, n_layers=cfg.n_layers,
                 params_b=n_params / 1e9)

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
    print(f"serve {arch}: {len(results)} requests OK, {stats.useful_tokens} "
          f"tokens, {stats.prefill_steps} prefills + {stats.decode_steps} "
          f"decode steps on {slots} slots; launches {counts}")
    serve["logits"] = logits_phase(torch, model, params, reqs[1].prompt,
                                   cfg)
    # random deep stacks amplify reordering noise (mamba2's 64 layers:
    # the floor is a quarter of the largest logit), so the same check
    # runs on the first SHALLOW layers of the same weights, where the
    # floor stays small and the tolerance means something
    if cfg.n_layers > SHALLOW:
        cut = dataclasses.replace(cfg, n_layers=SHALLOW)
        serve["logits_shallow"] = logits_phase(
            torch, dataclasses.replace(model, cfg=cut),
            {k: v[:SHALLOW] if k.startswith("layers/") else v
             for k, v in params.items()}, reqs[1].prompt, cut)
    if not any(serve[k]["binding"] for k in ("logits", "logits_shallow")
               if k in serve):
        _fail(f"{arch}: no logit check had a tolerance below the largest "
              f"logit")
    return serve


@contextlib.contextmanager
def residuals(model, out: list):
    """Append the residual stream after each layer of `model` (fp32, on
    the card) to `out` while the context is open."""
    layer_end = model._ffn          # the last step of every layer

    def record(lp, x):
        x = layer_end(lp, x)
        out.append(x.float())
        return x

    model._ffn = record
    try:
        yield
    finally:
        del model._ffn


def logits_phase(torch, model, params, prompt, cfg) -> dict:
    """The kernel path's prefill logits against the plain versions on
    the card, within 4x the plain versions' own reordering noise (their
    K sums in one fp32 product and, with a scan, another SSD chunk).
    Also reports, at layers 1, 2, 4, ... and the last, the plain path's
    residual rms and how far the reordered run has moved from it."""
    dev = next(iter(params.values())).device
    probe = {"tokens": torch.as_tensor(prompt[None], device=dev)}
    runs, resid = {}, {"plain": [], "reordered": []}
    for name, kw in (("plain", dict()),
                     ("reordered", dict(bk=None, ssd_chunk=SSD_CHUNK_FLOOR))):
        with plain_versions(**kw), residuals(model, resid[name]):
            runs[name] = model.prefill(params, probe)[0]
    runs["kernel"] = model.prefill(params, probe)[0]
    again = model.prefill(params, probe)[0]
    deterministic = torch.equal(again, runs["kernel"])
    if not deterministic:
        _fail(f"{cfg.name}: two prefills of one prompt gave different "
              f"logits")
    lg = {k: t[0, -1, :cfg.vocab_size].float() for k, t in runs.items()}
    a, b = lg["kernel"], lg["plain"]
    if not torch.isfinite(a).all():
        _fail(f"{cfg.name}: non-finite logits on the kernel path")
    logit_err = (a - b).abs().max().item()
    floor = (lg["reordered"] - b).abs().max().item()
    scale = b.abs().max().item()
    tol = max(LOGIT_FLOOR_FACTOR * floor, LOGIT_TOL * scale)
    by_layer = []
    for l, (xp, xr) in enumerate(zip(resid["plain"], resid["reordered"]),
                                 1):
        if l & (l - 1) == 0 or l == cfg.n_layers:
            by_layer.append(dict(
                layer=l, rms=xp.pow(2).mean().sqrt().item(),
                rel_div=((xr - xp).norm() / xp.norm()).item()))
    out = dict(prompt_len=int(len(prompt)), n_layers=cfg.n_layers,
               max_abs_err=logit_err, reorder_floor=floor,
               max_abs_logit=scale, tol=tol, binding=tol < scale,
               deterministic=deterministic,
               argmax_equal=bool(a.argmax() == b.argmax()),
               residual_by_layer=by_layer)
    print(f"logits {cfg.name} ({cfg.n_layers} layers): kernel vs plain max "
          f"error {logit_err:.4g}; plain vs plain with its sums reordered "
          f"{floor:.4g}; max |logit| {scale:.4g}; tol {tol:.4g}"
          f"{'' if out['binding'] else ' (not binding: tol >= max |logit|)'}"
          f"; argmax equal {out['argmax_equal']}; a second prefill "
          f"identical")
    print("  residual by layer (rms, reordered/plain divergence): " +
          ", ".join(f"{r['layer']}: {r['rms']:.4g}, {r['rel_div']:.3g}"
                    for r in by_layer))
    if logit_err > tol:
        _fail(f"{cfg.name}: kernel path logits disagree with the plain "
              f"versions")
    return out



# --- phase 5: the backward kernels against their plain versions -------------

def _grad_err(torch, got, want, what, tol=KERNEL_TOL):
    """max |got - want|; fails beyond tol of the largest entry plus tol
    relative (bf16 outputs: one ulp of the largest entry and more)."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        _fail(f"{what}: non-finite output")
    err = (g - w).abs()
    top = w.abs().max().item()
    if (err > tol * top + tol * w.abs()).any():
        _fail(f"{what}: max error {err.max().item():.4g} beyond {tol} of "
              f"the largest entry {top:.4g} plus {tol} relative")
    return err.max().item()


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BW
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def check_matmul_grad(torch, role, M, K, N, gen, transpose_w=False):
    """dgrad (dx = dy w^T) or wgrad (dw = x^T dy) of y = x @ w at
    x (M, K), w (K, N) ((N, K) with transpose_w), on the card against
    the plain version summed in the plan's split-K order."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_matmul as sm
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * scale).bfloat16()
    w = r(*((N, K) if transpose_w else (K, N)), scale=K ** -0.5)
    if role == "forward":          # the tied head's x @ emb^T ("nt")
        x = r(M, K)
        plan = sm.plan_for(x, w, 512, "nt")
        got = sm.split_matmul(x, w, transpose_w=True)
        want = ref.split_matmul_splitk_ref(x, w.t(), plan.kslice,
                                           plan.k_ranges(K))
        kern = lambda: sm.split_matmul(x, w, transpose_w=True)
        plain = lambda: ref.split_matmul_ref(x, w.t())
        lib = lambda: torch.matmul(x, w.t())
        shape, out_elems = [M, K, N], M * N
        in_bytes = 2.0 * (M * K + K * N)
    elif role == "dgrad":
        dy = r(M, N)
        layout = "nn" if transpose_w else "nt"
        plan = sm.plan_for(dy, w, sm.BWD_KSLICE, layout, role="dgrad")
        got = sm.split_matmul_dgrad(dy, w, transpose_w=transpose_w)
        b = w if transpose_w else w.t()
        want = ref.split_matmul_splitk_ref(dy, b, plan.kslice,
                                           plan.k_ranges(N))
        kern = lambda: sm.split_matmul_dgrad(dy, w, transpose_w=transpose_w)
        plain = lambda: ref.split_matmul_dgrad_ref(dy, w,
                                                   transpose_w=transpose_w)
        lib = lambda: torch.matmul(dy, b)
        shape, out_elems = [M, N, K], M * K
        in_bytes = 2.0 * (M * N + K * N)
    else:
        x, dy = r(M, K), r(M, N, scale=M ** -0.5)
        a, b = (dy, x) if transpose_w else (x, dy)
        plan = sm.plan_for(a, b, sm.BWD_KSLICE, "tn", role="wgrad")
        got = sm.split_matmul_wgrad(x, dy, transpose_w=transpose_w)
        want = ref.split_matmul_splitk_ref(a.t(), b, plan.kslice,
                                           plan.k_ranges(M))
        kern = lambda: sm.split_matmul_wgrad(x, dy, transpose_w=transpose_w)
        plain = lambda: ref.split_matmul_wgrad_ref(x, dy,
                                                   transpose_w=transpose_w)
        lib = lambda: torch.matmul(a.t(), b)
        shape, out_elems = [M, K, N], K * N
        in_bytes = 2.0 * (M * K + M * N)
    torch.cuda.synchronize()
    if plan.variant == "general":
        _fail(f"split_matmul {role} {shape}: a path shape took the general "
              f"kernel ({plan.reason})")
    err = _grad_err(torch, got, want, f"split_matmul {role} {shape}")
    if not torch.equal(got, kern()):
        _fail(f"split_matmul {role} {shape}: two calls on the same inputs "
              f"differ")
    flops = 2.0 * M * N * K
    bound_ms, bound_by = _bound(flops, in_bytes + 2.0 * out_elems)
    return dict(shape=shape, transpose_w=transpose_w, max_abs_err=err,
                ms=_graph_ms(torch, lambda: kern(), [()]),
                eager_ms=_time_ms(torch, lambda: kern(), [()]),
                plain_ms=_time_ms(torch, lambda: plain(), [()], iters=3),
                library_ms=_graph_ms(torch, lambda: lib(), [()]),
                bound_ms=bound_ms, bound_by=bound_by, **_plan_fields(plan))


def check_persistent_spills() -> list:
    """`-Xptxas -v`'s line for each of `split_matmul`'s persistent
    kernels; fails on a register spill, or when an instantiation the C
    entry launches is missing: each bn in each layout (NN, NT, TN) with
    bf16 out and with fp32 partials, and the accumulating form at bn
    128."""
    import re
    from repro_torch.kernels import _lib
    from repro_torch.kernels import split_matmul as sm
    ptx = [ln for ln in _ptxas(_lib.build_log) if "persistent" in ln]
    spills = [ln for ln in ptx if any(int(v) for v in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", ln))]
    want = [f"<{bn}, {layout}, {out}>" for bn in sm.PERSISTENT_BNS
            for layout in sm.LAYOUTS.values() for out in (0, 1)]
    want.append("<128, 0, 2>")
    missing = [w for w in want if not any(w + ":" in ln for ln in ptx)]
    if missing or spills:
        _fail(f"split_matmul persistent kernels spill registers, or ptxas "
              f"reported no line for {missing}: {spills or ptx}")
    return ptx


def _flash_bwd_inputs(torch, gen, B, S, T, KV, G, hd, dtype, kw):
    from repro_torch.kernels import flash_attention as fa
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    q, k, v = r(B, S, KV, G, hd), r(B, T, KV, hd), r(B, T, KV, hd)
    do = r(B, S, KV, G, hd)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    return q, k, v, o, lse, do


def _flash_bwd_case(torch, gen, B, S, T, KV, G, hd, kw, dtype, tol):
    """(kernel grads, plain grads, inputs) of one backward case; fails on
    a disagreement, a lse off the plain one or a repeat that differs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    args = _flash_bwd_inputs(torch, gen, B, S, T, KV, G, hd, dtype, kw)
    q, k, v, o, lse, do = args
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    what = f"flash_attention_bwd {(B, S, T, KV, G, hd)} {kw} {dtype}"
    _grad_err(torch, o, o_ref, f"{what}: forward output", tol)
    if (lse - lse_ref).abs().max().item() > 1e-3:
        _fail(f"{what}: forward logsumexp off the plain one")
    got = fa.flash_attention_bwd(*args, **kw)
    again = fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        _fail(f"{what}: two backward calls on the same inputs differ")
    want = ref.flash_attention_bwd_ref(*args, **kw)
    err = max(_grad_err(torch, g, w, f"{what} d{n}", tol)
              for n, g, w in zip("qkv", got, want))
    return err, args


def _sdpa_bwd(torch, q, k, v, do):
    """The library yardstick for the backward: SDPA's flash backward op
    alone, on (B, H, S, hd) copies (kv heads repeated per group), as a
    call that a CUDA graph can capture."""
    H = q.shape[2] * q.shape[3]
    B, S, hd = q.shape[0], q.shape[1], q.shape[-1]
    G = q.shape[3]
    qh = q.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    kh = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    vh = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    doh = do.reshape(B, S, H, hd).transpose(1, 2).contiguous()
    aten = torch.ops.aten
    out, lse, cq, ck, mq, mk, seed, off, _ = \
        aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, True)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        doh, qh, kh, vh, out, lse, cq, ck, mq, mk, 0.0, True, seed, off)


def check_flash_bwd(torch, gen, B, S=4096, KV=16, G=1, hd=64):
    """The backward at the training step's shape, causal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    kw = dict(causal=True)
    err, args = _flash_bwd_case(torch, gen, B, S, S, KV, G, hd, kw,
                                torch.bfloat16, KERNEL_TOL)
    q, k, v, o, lse, do = args
    H = KV * G
    lib = _sdpa_bwd(torch, q, k, v, do)
    pairs = B * H * S * (S + 1) / 2            # causal (query, key) pairs
    flops = 10.0 * hd * pairs                  # q.k, dO.v, P^T dO, dS k, dS^T q
    nbytes = (2.0 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel())
              + 4.0 * lse.numel())             # q o dO dq, k v dk dv, lse
    bound_ms, bound_by = _bound(flops, nbytes)
    return dict(shape=[B, S, KV, G, hd], max_abs_err=err,
                ms=_graph_ms(torch, lambda: fa.flash_attention_bwd(
                    *args, **kw), [()]),
                eager_ms=_time_ms(torch, lambda: fa.flash_attention_bwd(
                    *args, **kw), [()]),
                plain_ms=_time_ms(torch, lambda: ref.flash_attention_bwd_ref(
                    *args, **kw), [()], iters=2),
                library_ms=_graph_ms(torch, lib, [()]),
                fwd_lse_ms=_graph_ms(torch, lambda: fa.flash_attention(
                    *args[:3], return_lse=True, **kw), [()]),
                bound_ms=bound_ms, bound_by=bound_by)


def check_flash_bwd_design(torch, gen, B, S=4096, KV=16, G=1, hd=64) -> dict:
    """The key-major backward beyond agreement: no register spill in its
    kernels, its plan at the training shape, and the device time of its
    three kernels there (profiler, 10 calls)."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import _lib
    from repro_torch.kernels import flash_attention as fa
    ptx = [ln for ln in _ptxas(_lib.build_log) if "flash_bwd" in ln]
    spills = [ln for ln in ptx if any(int(v) for v in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", ln))]
    if not ptx or spills:
        _fail(f"flash_attention_bwd kernels spill registers (or ptxas "
              f"reported none): {spills or ptx}")
    kw = dict(causal=True)
    args = _flash_bwd_inputs(torch, gen, B, S, S, KV, G, hd, torch.bfloat16,
                             kw)
    plan = fa.plan_launch(B, S, S, KV, G, hd, True)
    fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    calls = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fa.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and "flash_bwd" in ev.key:
            name = ("rows" if "stats" in ev.key else "dq" if "dq_store"
                    in ev.key else "key_major")
            kernels[name] = (kernels.get(name, 0.0)
                             + ev.self_device_time_total / 1e3 / calls)
    if sorted(kernels) != ["dq", "key_major", "rows"]:
        _fail(f"flash_attention_bwd: profiler saw kernels {sorted(kernels)}")
    edge = sum(not plan.full(qt, kt) for kt in range(plan.n_kt)
               for qt in range(*plan.walk(kt)))
    pairs = sum(max(0, e - b_) for b_, e in map(plan.walk,
                                                range(plan.n_kt)))
    return dict(ptxas=ptx, kernel_ms=kernels, blocks=plan.items,
                tiles=[plan.bq, plan.bk], smem=plan.smem,
                scratch_mib=4 * (plan.acc_floats + plan.row_floats) / 2**20,
                tile_pairs=pairs, edge_pairs=edge)


# off the training path: the backward's other options and edges
FLASH_BWD_CASES = (
    # (B, S, T, KV, G, hd, causal, window, q_offset, dtype, what)
    (1, 512, 512, 8, 3, 128, True, 0, 0, "bfloat16", "G 3, hd 128 (phi4)"),
    (1, 1500, 1500, 2, 2, 64, True, 1024, 0, "bfloat16",
     "window 1024 (hymba)"),
    (2, 333, 333, 2, 1, 64, True, 0, 0, "bfloat16", "ragged S and T"),
    (1, 100, 300, 1, 3, 128, True, 0, 200, "bfloat16", "T > S, an offset"),
    (2, 130, 300, 2, 1, 64, False, 0, 0, "bfloat16", "non-causal, T != S"),
    (1, 45, 45, 2, 1, 64, True, 17, 0, "bfloat16", "a window of 17, S 45"),
    (2, 37, 50, 2, 3, 128, False, 0, 0, "bfloat16",
     "G 3, hd 128, non-causal, S 37 T 50"),
)
MATMUL_GRAD_CASES = (
    # (role, M, K, N, transpose_w, design of the bf16 call, what); dgrad
    # is dy (M, N) . w^T -> (M, K), wgrad x^T (K, M) . dy -> (K, N)
    ("dgrad", 300, 136, 200, False, "general",
     "ragged M (300 not a multiple of 8), K 136, N 200"),
    ("dgrad", 296, 136, 200, False, "persistent", "ragged M, K 136, N 200"),
    ("wgrad", 300, 136, 200, False, "general",
     "ragged M (the contracted rows, 300 not a multiple of 8)"),
    ("dgrad", 8, 1024, 1024, False, "persistent",
     "M 8: 128-row tiles at 8 rows, split-K"),
    ("dgrad", 5, 37, 19, False, "general", "odd sizes: the strided kernel"),
    ("wgrad", 5, 37, 19, False, "general", "odd sizes: the strided kernel"),
    ("dgrad", 200, 64, 264, True, "persistent", "a transposed weight"),
    ("wgrad", 200, 64, 264, True, "persistent", "a transposed weight"),
    ("dgrad", 2000, 1000, 1024, False, "persistent",
     "a ragged last row tile, K 1000 not a multiple of bn"),
    ("dgrad", 33000, 704, 1024, False, "persistent",
     "a ragged last row tile at the path's width"),
    ("dgrad", 200, 520, 4096, False, "persistent",
     "split-K, fewer tiles than SMs"),
    ("dgrad", 4000, 2000, 1024, False, "persistent",
     "tiles not a multiple of the blocks"),
    ("dgrad", 296, 1024, 8192, True, "persistent",
     "the tied head's layout (nn), split-K"),
    ("dgrad", 8192, 1152, 192, False, "persistent",
     "bn 192 (3 staging chunks a tile), 3 k-steps, about 3 tiles a block"),
    ("wgrad", 4000, 1024, 1024, False, "persistent",
     "contracted rows 4000, not a multiple of 64"),
    ("wgrad", 4096, 704, 1024, False, "persistent",
     "output rows 704, ragged against 128"),
    ("wgrad", 512, 8, 1024, False, "persistent",
     "output rows 8, one box of x^T mostly outside"),
    ("wgrad", 32768, 256, 512, False, "persistent",
     "split-K, fewer tiles than SMs"),
    ("wgrad", 4096, 1024, 8192, True, "persistent",
     "the tied head's form dy^T x, ragged tiles against 128 x 256"),
)


# (M, N, K) of out = A(M, K) . B at which the persistent kernel is run at
# each tile width through its C entry: one k-step a tile (a split) and
# 768 tiles of bn 192 on 132 blocks, so a staging buffer rewritten before
# its store has read it shows (the plan takes bn 192 at no such K)
PERSISTENT_SWEEP = (32768, 576, 64)


def check_persistent_widths(torch, gen) -> list:
    """The persistent kernel at each bn it is built for, in each layout,
    with one split (bf16 out) and with two (fp32 partials, then the
    reduce), at PERSISTENT_SWEEP, against the fp32 product, each call
    repeated bit-identically; returns the (layout, bn, splits) run."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import split_matmul as sm
    M, N, k_step = PERSISTENT_SWEEP
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tiles_m = math.ceil(M / sm.WGMMA_BM)
    ran = []
    for layout in ("nt", "nn", "tn"):
        for splits in (1, 2):
            K = k_step * splits
            r = lambda *s: torch.randn(*s, generator=gen,
                                       device="cuda").bfloat16()
            a = r(*((K, M) if layout == "tn" else (M, K)))
            b = r(*((N, K) if layout == "nt" else (K, N)))
            want = (a.float().t() if layout == "tn" else a.float()) @ (
                b.float().t() if layout == "nt" else b.float())
            ws = (torch.empty(splits, M, N, device="cuda") if splits > 1
                  else None)
            for bn in sm.PERSISTENT_BNS:
                tiles_n = math.ceil(N / bn)
                blocks = min(n_sm, tiles_m * tiles_n * splits)
                group = max(1, min(tiles_m, blocks // tiles_n))

                def call():
                    y = torch.empty(M, N, dtype=torch.bfloat16,
                                    device="cuda")
                    _lib.check(_lib.lib().split_matmul_persistent_bf16(
                        a.data_ptr(), b.data_ptr(), y.data_ptr(),
                        ws.data_ptr() if ws is not None else None, None,
                        sm.LAYOUTS[layout], M, N, K, k_step, bn, splits, 1,
                        blocks, group, _lib.stream_of(a)),
                        "split_matmul_persistent_bf16")
                    return y
                what = (f"persistent kernel {layout} bn {bn} x {splits} "
                        f"splits at {M}x{N}x{K} ({blocks} blocks, group "
                        f"{group})")
                got = call()
                _grad_err(torch, got, want, what)
                if not torch.equal(got, call()):
                    _fail(f"{what}: two calls on the same inputs differ")
                ran.append((layout, bn, splits))
    return ran


def check_backward_options(torch, gen) -> int:
    """The backward kernels off the training path, each against its plain
    version: flash G/hd/window/offset/non-causal (bf16, the only type
    its backward takes), matmul layouts at ragged and odd sizes in bf16
    and f32."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import split_matmul as sm
    for B, S, T, KV, G, hd, causal, window, q_off, dt, _ in FLASH_BWD_CASES:
        _flash_bwd_case(torch, gen, B, S, T, KV, G, hd,
                        dict(causal=causal, window=window, q_offset=q_off),
                        getattr(torch, dt), KERNEL_TOL)
    for role, M, K, N, tw, design, what in MATMUL_GRAD_CASES:
        for dtype, tol in ((torch.bfloat16, KERNEL_TOL), (torch.float32,
                                                          1e-4)):
            r = lambda *s: torch.randn(*s, generator=gen,
                                       device="cuda").to(dtype)
            w = r(*((N, K) if tw else (K, N)))
            if role == "dgrad":
                dy = r(M, N)
                plan = sm.plan_for(dy, w, sm.BWD_KSLICE, "nn" if tw else "nt",
                                   role="dgrad")
                call = lambda: sm.split_matmul_dgrad(dy, w, transpose_w=tw)
                want = ref.split_matmul_dgrad_ref(dy, w, transpose_w=tw)
            else:
                x, dy = r(M, K), r(M, N)
                a, b = (dy, x) if tw else (x, dy)
                plan = sm.plan_for(a, b, sm.BWD_KSLICE, "tn", role="wgrad")
                call = lambda: sm.split_matmul_wgrad(x, dy, transpose_w=tw)
                want = ref.split_matmul_wgrad_ref(x, dy, transpose_w=tw)
            got = call()
            what_ = f"split_matmul_{role} {what} {dtype}"
            if dtype == torch.bfloat16 and plan.variant != design:
                _fail(f"{what_}: took {plan.variant}, not {design}")
            _grad_err(torch, got, want, what_, tol)
            if not torch.equal(got, call()):
                _fail(f"{what_}: two calls on the same inputs differ")
    return len(FLASH_BWD_CASES) + 2 * len(MATMUL_GRAD_CASES)


# --- phase 6: train qwen1.5-0.5b --------------------------------------------

@contextlib.contextmanager
def annotated_kernels():
    """Name each kernel wrapper's calls with a profiler range, so a
    profiled step's device time splits by role: the head's dgrad runs
    the forward's layout, so kernel names alone cannot tell it from a
    forward product; `split_matmul(..., acc=)` is `split_matmul_acc`."""
    from torch.profiler import record_function
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import split_matmul as sm
    from repro_torch.kernels import ssd_scan as sk
    saved = []

    def wrap(mod, attr, name):
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def inner(*a, **k):
            # the accumulating form is a bucket of its own
            with record_function(name + ("_acc" if k.get("acc") is not None
                                         else "")):
                return fn(*a, **k)
        setattr(mod, attr, inner)
    for mod, attr, name in ((sm, "split_matmul", "bucket:split_matmul"),
                            (sm, "split_matmul_dgrad",
                             "bucket:split_matmul_dgrad"),
                            (sm, "split_matmul_wgrad",
                             "bucket:split_matmul_wgrad"),
                            (fa, "flash_attention", "bucket:flash_attention"),
                            (fa, "flash_attention_bwd",
                             "bucket:flash_attention_bwd"),
                            (sk, "ssd_scan", "bucket:ssd_scan"),
                            (sk, "ssd_scan_bwd", "bucket:ssd_scan_bwd")):
        wrap(mod, attr, name)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _profiled(torch, fn):
    """(device ms of the kernels, device ms of each `bucket:` range, host
    ms, the 10 torch ops with the most device time) of one call of `fn`.  A range
    shows on the device as an annotation span from its first kernel to
    its last: for a kernel wrapper (one to three kernels back to back)
    that is their device time; the spans are not counted as kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with annotated_kernels():
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels, spans, others = 0.0, {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            # the torch ops' own kernels (the port's ctypes launches have
            # no op of their own)
            if ev.key.startswith("aten::") and ev.self_device_time_total:
                others.append((ev.self_device_time_total / 1e3, ev.key,
                               ev.count))
            continue
        if ev.key.startswith("bucket:"):
            spans[ev.key[7:]] = (spans.get(ev.key[7:], 0.0) + max(
                ev.device_time_total, ev.self_device_time_total) / 1e3)
        elif ev.self_device_time_total > 0:
            kernels += ev.self_device_time_total / 1e3
    return kernels, spans, wall_ms, sorted(others, reverse=True)[:10]


def profile_step(torch, grads_fn, update_fn, roles) -> dict:
    """Device ms of one training step by bucket: the kernels by role
    (from their wrappers' ranges; `roles`: the kernels the step runs),
    plain torch (every other kernel of the forward and backward), and
    the AdamW update (all the kernels of `update_fn`, profiled on its
    own)."""
    k1, spans, w1, others = _profiled(torch, grads_fn)
    k2, _, w2, _ = _profiled(torch, update_fn)
    if not k1 or not all(spans.get(r, 0.0) > 0 for r in roles):
        _fail(f"profiler: no device time for some kernel role: {spans}")
    out = {r: spans[r] for r in roles}
    out["plain_torch"] = k1 - sum(out.values())
    out["adamw"] = k2
    out["device_total"] = k1 + k2
    out["wall_ms"] = w1 + w2
    out["device_busy_share"] = (k1 + k2) / (w1 + w2)
    out["top_plain_ops"] = [dict(ms=ms, name=n, count=cnt)
                            for ms, n, cnt in others]
    return out


def grad_check(torch, model, params, batch, n_layers) -> dict:
    """Step-1 loss and every gradient leaf of the first `n_layers` of the
    model (same weights, same batch) through the kernels against the
    plain versions on the card, within 4x the plain versions' own
    reordering noise (their sums in another order: one fp32 product per
    forward matmul, 256-row attention blocks, an SSD chunk of
    SSD_CHUNK_FLOOR), and at least GRAD_TOL of
    a leaf's norm (the kernels round P and dS to bf16 as tensor-core
    operands where the plain versions keep fp32, and every leaf is bf16:
    one ulp is 2^-8 = 0.4 percent) or 1e-3 of the loss; a leaf's check
    binds when its tolerance is below the leaf's own norm."""
    from repro_torch.train.loop import loss_and_grads
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    cut = dataclasses.replace(model, cfg=cfg)
    p = {k: (v[:n_layers] if k.startswith("layers/") else v).detach().clone()
         for k, v in params.items()}
    runs = {}
    for name, ctx in (("plain", plain_versions()),
                      ("reordered", plain_versions(
                          bk=None, bq=256, ssd_chunk=SSD_CHUNK_FLOOR)),
                      ("kernel", contextlib.nullcontext())):
        with ctx:
            loss, _, grads = loss_and_grads(cut, p, batch)
        runs[name] = (float(loss), {k: g.float() for k, g in grads.items()})
        del grads
    lp, gp = runs["plain"]
    lk, gk = runs["kernel"]
    lr_, gr = runs["reordered"]
    loss_tol = max(LOGIT_FLOOR_FACTOR * abs(lr_ - lp), 1e-3 * abs(lp))
    if not math.isfinite(lk) or abs(lk - lp) > loss_tol:
        _fail(f"train grad check: loss {lk} vs plain {lp} (tol {loss_tol})")
    leaves, binding = {}, 0
    for k in gp:
        norm = gp[k].norm().item()
        rel = (gk[k] - gp[k]).norm().item() / max(norm, 1e-30)
        floor = (gr[k] - gp[k]).norm().item() / max(norm, 1e-30)
        tol = max(LOGIT_FLOOR_FACTOR * floor, GRAD_TOL)
        if not torch.isfinite(gk[k]).all() or rel > tol:
            _fail(f"train grad check: {k} off the plain versions by "
                  f"{rel:.4g} of its norm (tol {tol:.4g}, floor {floor:.4g})")
        binding += tol < 1.0
        leaves[k] = dict(rel_err=rel, floor=floor, tol=tol)
    if not binding:
        _fail("train grad check: no leaf's tolerance is below its norm")
    worst = max(leaves.items(), key=lambda kv: kv[1]["rel_err"] / kv[1]["tol"])
    print(f"grad check ({n_layers} layers): loss kernel {lk:.6f} plain "
          f"{lp:.6f} reordered {lr_:.6f} (tol {loss_tol:.3g}); "
          f"{len(leaves)} leaves, {binding} binding; worst {worst[0]}: "
          f"{worst[1]['rel_err']:.4g} of its norm (floor "
          f"{worst[1]['floor']:.4g}, tol {worst[1]['tol']:.4g})")
    return dict(n_layers=n_layers, loss=dict(kernel=lk, plain=lp,
                                              reordered=lr_, tol=loss_tol),
                leaves=leaves, binding_leaves=binding)


def _layer_products(model) -> list:
    """One layer's forward products as (role, tag, launches): role
    "split_matmul" or "split_matmul_acc" (the chunked FFN's w2 chunks),
    tag the name `seg_matmul` gives the output ("" for none: the FFN's
    plain and chunked products, as in the JAX package).  A single
    segment is one product named by its path; an input-dim split one
    named sum of a launch a segment; an output-dim split a named product
    a segment.  The SSD block's w_zx, w_bcdt and wo take attention's
    place; a model without an FFN has no more."""
    lay = model.pset.layouts

    def seg(path):
        lo = lay[path]
        if len(lo.segments) == 1:
            return [("split_matmul", path, 1)]
        if lo.spec.zdp_axis - lo.spec.stacked == 0:
            return [("split_matmul", path, len(lo.segments))]
        return [("split_matmul", path + sg.key, 1) for sg in lo.segments]

    cfg = model.cfg
    if cfg.has_attention:
        out = [p for w in ("wq", "wk", "wv", "wo")
               for p in seg(f"layers/attn/{w}")]
    else:                      # the SSD block's projections
        out = [p for w in ("w_zx", "w_bcdt", "wo")
               for p in seg(f"layers/ssm/{w}")]
    if not cfg.d_ff:
        return out
    g = model._split_g("layers.ffn_w13")
    if lay["layers/ffn/w13"].is_split or lay["layers/ffn/w2"].is_split:
        out += seg("layers/ffn/w13") + seg("layers/ffn/w2")
    elif g > 1 and cfg.d_ff % g == 0:
        out += [("split_matmul", "", g), ("split_matmul_acc", "", g)]
    else:
        out += [("split_matmul", "", 2)]
    return out


def _want_train_launches(built, steps, S) -> tuple:
    """The launches `steps` training steps imply from the plan, by kernel
    and, for `split_matmul`, by operand layout: each layer product
    (`_layer_products`) once in the forward, again in the backward when
    the layer's remat recomputes it (all of them under full remat; under
    a selective policy those whose tag it does not keep), and one dgrad
    and one wgrad; the head one product a CE chunk and, chunked, its
    recompute; attention, or the SSD block's scan, one forward (again
    under any remat: it carries no tag) and one backward a layer; all of
    it once a microbatch.  A
    tied head's forward reads the embedding as stored ("nt", as the
    layers' dgrad) and its dgrad is "nn" (as the layers' forward); every
    wgrad is "tn".  Layouts are returned for the tied head only (None
    otherwise)."""
    from repro_torch.models import transformer as tm
    model, cfg = built.model, built.model.cfg
    lay = model.pset.layouts
    prods = _layer_products(model)
    remat = model.remat
    again = [p for p in prods if remat is True
             or (isinstance(remat, tuple) and p[1] not in remat)]
    head_segs = 1 if cfg.tie_embeddings else len(lay["head/out"].segments)
    chunked = (S % tm.CE_CHUNK == 0 and S > tm.CE_CHUNK
               and S * cfg.padded_vocab >= tm.CE_MIN_ELEMS)
    n = steps * max(1, built.run.microbatch)
    nL = n * cfg.n_layers
    head = n * head_segs * (S // tm.CE_CHUNK if chunked else 1)
    fwd = lambda ps, role: sum(k for r, _, k in ps if r == role)
    layer_fwd = {r: nL * (fwd(prods, r) + fwd(again, r))
                 for r in ("split_matmul", "split_matmul_acc")}
    layer_bwd = nL * sum(k for _, _, k in prods)
    head_fwd = head * (2 if chunked else 1)
    want = {"split_matmul": layer_fwd["split_matmul"] + head_fwd,
            "split_matmul_acc": layer_fwd["split_matmul_acc"],
            "split_matmul_dgrad": layer_bwd + head,
            "split_matmul_wgrad": layer_bwd + head,
            "flash_attention": nL * (2 if remat else 1) * cfg.has_attention,
            "flash_attention_bwd": nL * cfg.has_attention,
            "ssd_scan": nL * (2 if remat else 1) * cfg.has_ssm,
            "ssd_scan_bwd": nL * cfg.has_ssm}
    layouts = ({"nn": sum(layer_fwd.values()) + head,
                "nt": layer_bwd + head_fwd,
                "tn": layer_bwd + head} if cfg.tie_embeddings else None)
    return want, layouts


def _check_persistent_roles(variants: dict, what: str) -> None:
    """Fails unless every accumulating, dgrad and wgrad launch counted in
    `variants` (`ops.split_matmul_variant_counts()`, "role:design") took
    the persistent design: at the training shapes (rows > 64, bf16)
    nothing else is planned for them."""
    off = {k: n for k, n in variants.items() if k.split(":")[0] in
           ("acc", "dgrad", "wgrad") and k.split(":")[1] != "persistent"}
    if off:
        _fail(f"{what}: acc, dgrad or wgrad launches off the persistent "
              f"design: {off} (all by design: {variants})")


def _want_product_counts(built, steps, S) -> dict:
    """Tagged products computed in `steps` steps, by tag: once a layer in
    the forward, and again unless the layer's remat keeps the tag; an
    untied head's ("head/out", one product or one sum of its segments)
    once a CE chunk and, chunked, again in the chunk's recompute."""
    from repro_torch.models import transformer as tm
    model, cfg = built.model, built.model.cfg
    n = steps * max(1, built.run.microbatch)
    nL = n * cfg.n_layers
    remat = model.remat
    out = {tag: nL * (1 + (remat is True or (isinstance(remat, tuple)
                                             and tag not in remat)))
           for _, tag, _ in _layer_products(model) if tag}
    if not cfg.tie_embeddings:
        lo = model.pset.layouts["head/out"]
        if len(lo.segments) > 1 and lo.spec.zdp_axis != 0:
            raise NotImplementedError("an output-split untied head")
        chunked = (S % tm.CE_CHUNK == 0 and S > tm.CE_CHUNK
                   and S * cfg.padded_vocab >= tm.CE_MIN_ELEMS)
        out["head/out"] = n * (2 * S // tm.CE_CHUNK if chunked else 1)
    return out


def train_phase(torch, args) -> dict:
    """Plan qwen1.5-0.5b's training step with OSDP for one H100, build it
    at full width (depth cut by --layers), check its gradients against
    the plain versions on a shallow cut and a repeated step for
    bit-identity, then train TRAIN_STEPS steps through `train()` with the
    launch counts zeroed just before and read just after, and profile
    one more step; then global remat, the searched selective plan, a
    mixed plan and a checkpoint round trip (`_remat_runs`,
    `checkpoint_round_trip`)."""
    from repro_torch.configs import (DeviceInfo, MeshConfig, RunConfig,
                                     get_arch, get_shape)
    from repro_torch.core.api import osdp
    from repro_torch.data.synthetic import Dataset
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig, apply_update, init_state
    from repro_torch.train.loop import loss_and_grads, train

    cfg_full = get_arch(TRAIN_ARCH)
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=TRAIN_BATCH)
    mesh = MeshConfig((1, 1), ("data", "model"))
    plan = osdp(cfg_full, shape, mesh, memory_limit_gib=64.0,
                device=DeviceInfo.preset("h100-sxm"),
                checkpointing="selective")
    print(plan.summary())
    for op, dec in plan.decisions.items():
        print(f"  {op}: modes {dec.modes} remat {dec.remat}")
    cfg = cfg_full
    if args.layers and args.layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        print(f"depth cut: {cfg.n_layers} of {cfg_full.n_layers} layers")
    run = RunConfig(model=cfg, shape=shape, mesh=mesh, osdp=plan.run.osdp)
    built = build_model(run, plan)
    model = built.model
    B, S = shape.global_batch, shape.seq_len
    split = model._split_g("layers.ffn_w13")
    if split != TRAIN_SPLIT:
        _fail(f"train: the plan splits the FFN in {split}, phase 5 checked "
              f"the chunk shapes of a split in {TRAIN_SPLIT}")
    print(f"train {TRAIN_ARCH}: remat {model.remat}, microbatch "
          f"{run.microbatch}, batch {B} x seq {S}, FFN in {split} chunks "
          f"(chunked_ffn)")
    params = built.init(args.seed, "cuda")
    n_params = sum(p.numel() for p in params.values())
    ds = Dataset(cfg, shape, seed=args.seed)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.global_batch(0).items()}

    check = grad_check(torch, model, params, batch,
                       min(GRAD_LAYERS, cfg.n_layers))
    torch.cuda.empty_cache()
    # a repeated forward + backward of one batch is bit-identical
    runs = [loss_and_grads(model, params, batch) for _ in range(2)]
    if not (torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(runs[0][2][k], runs[1][2][k]) for k in params)):
        _fail("train: two forward + backward passes of one batch differ")
    del runs
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train(built, TRAIN_STEPS, seed=args.seed, warmup=1, device="cuda",
                params=params, log_every=1)
    res.params = None       # the runs below start from `params`
    counts = ops.launch_counts()
    layouts = ops.split_matmul_layout_counts()
    variants = ops.split_matmul_variant_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in res.losses):
        _fail(f"train: non-finite loss {res.losses}")
    _check_persistent_roles(variants, "train")
    want, want_layouts = _want_train_launches(built, TRAIN_STEPS, S)
    for name, n in want.items():
        if counts[name] != n:
            _fail(f"train: {name} ran {counts[name]} times, the plan's step "
                  f"needs {n}")
    if want_layouts and layouts != want_layouts:
        _fail(f"train: split_matmul launches by layout {layouts}, the "
              f"layers and the tied head (read as stored, no transposed "
              f"copy) need {want_layouts}")
    tokens = B * S
    flops = (6.0 * n_params * tokens + 12.0 * cfg.n_layers * B * S * S
             * cfg.n_heads * cfg.resolved_head_dim / 2)
    steady = sorted(res.step_ms[1:]) or res.step_ms
    step_ms = steady[len(steady) // 2]
    out = dict(arch=TRAIN_ARCH, n_layers=cfg.n_layers, params_b=n_params / 1e9,
               batch=B, seq=S, remat=str(model.remat),
               microbatch=run.microbatch, steps=res.steps,
               losses=res.losses, grad_norms=res.grad_norms,
               step_ms=res.step_ms, median_step_ms=step_ms,
               tokens_per_step=tokens, tokens_per_s=tokens / (step_ms / 1e3),
               model_flops_per_step=flops,
               mfu=flops / (PEAK_BF16 * step_ms / 1e3),
               peak_mem_gib=peak, launches=counts,
               split_matmul_layouts=layouts, split_matmul_variants=variants,
               grad_check=check,
               plan_est_step_ms=plan.cost.time * 1e3,
               plan_est_mem_gib=plan.cost.memory / 2**30)
    for i, (l, g, ms) in enumerate(zip(res.losses, res.grad_norms,
                                       res.step_ms)):
        print(f"  step {i}: loss {l:.4f} grad_norm {g:.4f} {ms:.1f} ms "
              f"({tokens / (ms / 1e3):.0f} tok/s)")
    # one more step under the profiler, by bucket
    # (on a copy: the runs below start from the same weights as this one)
    pp = {k: v.detach().clone() for k, v in params.items()}
    opt = init_state(pp)
    got = {}
    out["profile_step"] = prof = profile_step(
        torch, lambda: got.update(g=loss_and_grads(model, pp, batch)[2]),
        lambda: apply_update(AdamWConfig(), pp, got["g"], opt, 1.0),
        roles=[r for r in ("split_matmul", "split_matmul_acc",
                           "split_matmul_dgrad", "split_matmul_wgrad",
                           "flash_attention", "flash_attention_bwd")
               if want[r] > 0])
    del got, pp, opt
    print("  profiled step (device ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in prof.items() if k != "top_plain_ops"))
    print("  plain-torch ops with the most device time (ms, calls): "
          + "; ".join(f"{r['name']} {r['ms']:.2f} x{r['count']}"
                      for r in prof["top_plain_ops"]))
    print(f"train {TRAIN_ARCH}: {res.steps} steps, median step {step_ms:.1f} "
          f"ms, {out['tokens_per_s']:.0f} tok/s, MFU {out['mfu']:.3f}, peak "
          f"{peak:.2f} GiB; launches {counts}; split_matmul by layout "
          f"{layouts}, by role and design {variants}")
    out["w13_regroup"] = w13_regroup(torch, cfg, split)
    print(f"  w13 regrouped into {split} chunks: "
          f"{out['w13_regroup']['fwd_ms']:.4f} ms a layer, its gradient "
          f"{out['w13_regroup']['bwd_ms']:.4f} ms; "
          f"{out['w13_regroup']['step_ms']:.3f} ms a step")
    torch.cuda.empty_cache()
    out.update(_remat_runs(torch, args, built, plan, params, res, out,
                           batch))
    torch.cuda.empty_cache()
    out["checkpoint"] = checkpoint_round_trip(torch, args, built, params)
    torch.cuda.empty_cache()
    out["sharded"] = sharded_phase(torch, args, built, params, out)
    return out


def ssm_plan(args):
    """(plan, built) of mamba2-2.7b's step: `osdp` for train_4k at global
    batch 8 on a 1x1 mesh with 64 GiB and the h100-sxm preset
    (checkpointing "selective", as phase 6), built without weights at
    full width, depth cut by --layers."""
    from repro_torch.configs import (DeviceInfo, MeshConfig, RunConfig,
                                     get_arch, get_shape)
    from repro_torch.core.api import osdp
    from repro_torch.models.registry import build_model
    cfg_full = get_arch(SSM_TRAIN_ARCH)
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=TRAIN_BATCH)
    mesh = MeshConfig((1, 1), ("data", "model"))
    plan = osdp(cfg_full, shape, mesh, memory_limit_gib=64.0,
                device=DeviceInfo.preset("h100-sxm"),
                checkpointing="selective")
    cfg = cfg_full
    if args.layers and args.layers < cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    run = RunConfig(model=cfg, shape=shape, mesh=mesh, osdp=plan.run.osdp)
    return plan, build_model(run, plan)


def ssm_products(built) -> list:
    """(path, rows, K, N) of every distinct forward product of the SSM
    step: each segment of w_zx, w_bcdt and wo at B x S rows, of the
    untied head at a CE chunk (B x 512 rows)."""
    from repro_torch.models import transformer as tm
    shape = built.run.shape
    rows = shape.global_batch * shape.seq_len
    out = []
    for path, M in (("layers/ssm/w_zx", rows), ("layers/ssm/w_bcdt", rows),
                    ("layers/ssm/wo", rows),
                    ("head/out", shape.global_batch * tm.CE_CHUNK)):
        lo = built.model.pset.layouts[path]
        K, N = lo.spec.shape[-2:]
        ax = lo.spec.zdp_axis - lo.spec.stacked
        for size in sorted({sg.size for sg in lo.segments}):
            out.append((path, M, size if ax == 0 else K,
                        size if ax == 1 else N))
    return out


def ssm_train_phase(torch, args, plan, built) -> dict:
    """Train mamba2-2.7b (the SSM family) at full width and depth under
    the 64 GiB plan: a 2-layer gradient check against the plain versions
    (the scan's backward `ref.ssd_scan_bwd_ref` included), a repeated
    forward + backward bit-identical, then TRAIN_STEPS steps through
    `train()` with the launch counts zeroed just before and read just
    after (every product through `split_matmul`'s roles, `ssd_scan` once
    a layer and again under remat, `ssd_scan_bwd` once a layer: any
    other count fails), and one more step under the profiler by bucket.
    MFU counts 6 N tokens plus the scan's own operations, forward and
    backward (`ssd_flops`)."""
    from repro_torch.data.synthetic import Dataset
    from repro_torch.kernels import ops
    from repro_torch.optim import AdamWConfig, apply_update, init_state
    from repro_torch.train.loop import loss_and_grads, train
    print(plan.summary())
    for op, dec in plan.decisions.items():
        print(f"  {op}: modes {dec.modes} remat {dec.remat}")
    model, cfg, run = built.model, built.model.cfg, built.run
    B, S = run.shape.global_batch, run.shape.seq_len
    if cfg.n_layers < plan.run.model.n_layers:
        print(f"depth cut: {cfg.n_layers} of {plan.run.model.n_layers} "
              f"layers")
    print(f"train {SSM_TRAIN_ARCH}: remat {model.remat}, microbatch "
          f"{run.microbatch}, batch {B} x seq {S}")
    params = built.init(args.seed, "cuda")
    n_params = sum(p.numel() for p in params.values())
    ds = Dataset(cfg, run.shape, seed=args.seed)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.global_batch(0).items()}
    check = grad_check(torch, model, params, batch,
                       min(GRAD_LAYERS, cfg.n_layers))
    torch.cuda.empty_cache()
    first = loss_and_grads(model, params, batch)
    again = loss_and_grads(model, params, batch)
    if not (torch.equal(first[0], again[0]) and all(
            torch.equal(first[2][k], again[2][k]) for k in params)):
        _fail(f"train {SSM_TRAIN_ARCH}: two forward + backward passes of "
              f"one batch differ")
    del first, again, params       # train() draws the same weights
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train(built, TRAIN_STEPS, seed=args.seed, warmup=1, device="cuda",
                log_every=1)
    counts = ops.launch_counts()
    products = dict(ops.product_counts)
    variants = ops.split_matmul_variant_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in res.losses):
        _fail(f"train {SSM_TRAIN_ARCH}: non-finite loss {res.losses}")
    _check_persistent_roles(variants, f"train {SSM_TRAIN_ARCH}")
    want, _ = _want_train_launches(built, TRAIN_STEPS, S)
    want_p = _want_product_counts(built, TRAIN_STEPS, S)
    if counts != want or products != want_p:
        _fail(f"train {SSM_TRAIN_ARCH}: launches {counts}, tagged products "
              f"{products}; the plan's steps need {want} and {want_p}")
    tokens = B * S
    fwd, bwd = ssd_flops(B, S, cfg.ssm_n_heads, cfg.ssm_head_dim,
                         cfg.ssm_state, cfg.ssm_chunk)
    flops = 6.0 * n_params * tokens + cfg.n_layers * (fwd + bwd)
    steady = sorted(res.step_ms[1:]) or res.step_ms
    step_ms = steady[len(steady) // 2]
    out = dict(arch=SSM_TRAIN_ARCH, n_layers=cfg.n_layers,
               params_b=n_params / 1e9, batch=B, seq=S,
               remat=str(model.remat), microbatch=run.microbatch,
               steps=res.steps, losses=res.losses,
               grad_norms=res.grad_norms, step_ms=res.step_ms,
               median_step_ms=step_ms, tokens_per_step=tokens,
               tokens_per_s=tokens / (step_ms / 1e3),
               model_flops_per_step=flops, ssd_flops_per_step=cfg.n_layers
               * (fwd + bwd), mfu=flops / (PEAK_BF16 * step_ms / 1e3),
               peak_mem_gib=peak, launches=counts, products=products,
               split_matmul_variants=variants, grad_check=check,
               plan_est_step_ms=plan.cost.time * 1e3,
               plan_est_mem_gib=plan.cost.memory / 2**30)
    for i, (l, g, ms) in enumerate(zip(res.losses, res.grad_norms,
                                       res.step_ms)):
        print(f"  step {i}: loss {l:.4f} grad_norm {g:.4f} {ms:.1f} ms "
              f"({tokens / (ms / 1e3):.0f} tok/s)")
    # one more step under the profiler, by bucket, on the trained weights
    pp = res.params
    del res
    torch.cuda.empty_cache()
    opt = init_state(pp)
    got = {}
    out["profile_step"] = prof = profile_step(
        torch, lambda: got.update(g=loss_and_grads(model, pp, batch)[2]),
        lambda: apply_update(AdamWConfig(), pp, got["g"], opt, 1.0),
        roles=("split_matmul", "split_matmul_dgrad", "split_matmul_wgrad",
               "ssd_scan", "ssd_scan_bwd"))
    del got, pp, opt
    print("  profiled step (device ms): " + ", ".join(
        f"{k} {v:.2f}" for k, v in prof.items() if k != "top_plain_ops"))
    print("  plain-torch ops with the most device time (ms, calls): "
          + "; ".join(f"{r['name']} {r['ms']:.2f} x{r['count']}"
                      for r in prof["top_plain_ops"]))
    print(f"train {SSM_TRAIN_ARCH}: {out['steps']} steps, median step "
          f"{step_ms:.1f} ms, {out['tokens_per_s']:.0f} tok/s, MFU "
          f"{out['mfu']:.3f}, peak {peak:.2f} GiB; launches {counts}; "
          f"split_matmul by role and design {variants}")
    return out


def w13_regroup(torch, cfg, g) -> dict:
    """Device time of `chunked_ffn`'s one copy of w13 a layer (d x 2 ff
    regrouped into g contiguous (d, 2 ff / g) chunks) and of its
    gradient's way back (the g chunk gradients stacked and regrouped),
    by CUDA-graph replay; a step takes each once a layer (the forward
    copy twice under remat)."""
    d, ff = cfg.d_model, cfg.d_ff
    c = ff // g
    w13 = torch.randn(d, 2 * ff, device="cuda").bfloat16()
    grads = [torch.randn(d, 2 * c, device="cuda").bfloat16()
             for _ in range(g)]
    fwd = lambda: w13.reshape(d, 2, g, c).permute(2, 0, 1, 3).reshape(
        g, d, 2 * c).unbind(0)
    bwd = lambda: torch.stack(grads).reshape(g, d, 2, c).permute(
        1, 2, 0, 3).reshape(d, 2 * ff)
    f_ms, b_ms = _graph_ms(torch, fwd, [()]), _graph_ms(torch, bwd, [()])
    return dict(g=g, fwd_ms=f_ms, bwd_ms=b_ms,
                step_ms=cfg.n_layers * (f_ms + b_ms))


def _train_run(torch, built, steps, params, seed, what, S,
               batch=None) -> dict:
    """`steps` steps of `built` through `train()` from `params`, with the
    kernel launches and the tagged products counted from zero and held
    to what the plan implies, and the peak memory; with `batch`, one
    more forward + backward under the profiler: its device time and the
    share of its wall time the device was busy."""
    from repro_torch.kernels import ops
    from repro_torch.train.loop import loss_and_grads, train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = train(built, steps, seed=seed, warmup=1, device="cuda",
                params=params, log_every=0)
    counts, products = ops.launch_counts(), dict(ops.product_counts)
    _check_persistent_roles(ops.split_matmul_variant_counts(),
                            f"train {what}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    want, _ = _want_train_launches(built, steps, S)
    want_p = _want_product_counts(built, steps, S)
    if counts != want or products != want_p or not all(
            math.isfinite(x) for x in res.losses):
        _fail(f"train {what}: launches {counts} (the plan's steps need "
              f"{want}), tagged products {products} (need {want_p}), "
              f"losses {res.losses}")
    ms = sorted(res.step_ms[1:])[len(res.step_ms[1:]) // 2]
    out = dict(steps=res.steps, losses=res.losses, step_ms=res.step_ms,
               median_step_ms=ms, peak_mem_gib=peak, launches=counts,
               products=products, remat=str(built.model.remat))
    if batch is not None:
        del res
        dev_ms, _, wall_ms, _ = _profiled(
            torch, lambda: loss_and_grads(built.model, params, batch))
        out.update(grads_device_ms=dev_ms, grads_wall_ms=wall_ms,
                   grads_busy_share=dev_ms / wall_ms)
    return out


def _remat_runs(torch, args, built, plan, params, res, out,
                batch) -> dict:
    """REMAT_STEPS steps of the same weights and batches under global
    remat (the planner's default checkpointing), under the plan the
    searcher returns at SELECTIVE_GIB (selective: it keeps names that
    tag no product of the layer, so it must give global remat's losses
    bit for bit) and under a mixed plan (the attention products kept,
    the FFN recomputed), whose peak must lie between global remat's and
    remat off's and whose losses must match remat off's."""
    from repro_torch.configs import DeviceInfo, RunConfig, get_arch
    from repro_torch.core.api import osdp
    from repro_torch.core.cost_model import Decision
    from repro_torch.models.registry import build_model
    model, S = built.model, built.run.shape.seq_len
    tokens = built.run.shape.global_batch * S
    flops = out["model_flops_per_step"]
    runs = {}

    def report(name, r):
        r.update(tokens_per_s=tokens / (r["median_step_ms"] / 1e3),
                 mfu=flops / (PEAK_BF16 * r["median_step_ms"] / 1e3))
        print(f"train {TRAIN_ARCH} {name} (remat {r['remat'][:60]}): "
              f"{r['steps']} steps, median step {r['median_step_ms']:.1f} "
              f"ms, {r['tokens_per_s']:.0f} tok/s, MFU {r['mfu']:.3f}, "
              f"peak {r['peak_mem_gib']:.2f} GiB; losses "
              + " ".join(f"{x:.6f}" for x in r["losses"])
              + f"; launches {r['launches']}; a profiled forward + "
              f"backward: device {r['grads_device_ms']:.2f} ms of "
              f"{r['grads_wall_ms']:.2f} (busy {r['grads_busy_share']:.2f})")
        runs[name] = r

    remat = dataclasses.replace(built, model=dataclasses.replace(
        model, remat=True))
    report("remat_true", _train_run(torch, remat, REMAT_STEPS, params,
                                    args.seed, "with remat", S, batch))
    runs["remat_true"]["bit_identical_to_remat_off"] = (
        runs["remat_true"]["losses"] == res.losses[:REMAT_STEPS])
    torch.cuda.empty_cache()

    # planned at full depth (a depth cut fits in any limit), applied to
    # the model as built
    sel_plan = osdp(get_arch(TRAIN_ARCH), built.run.shape, built.run.mesh,
                    memory_limit_gib=SELECTIVE_GIB,
                    device=DeviceInfo.preset("h100-sxm"),
                    checkpointing="selective")
    sel = build_model(RunConfig(model=built.run.model, shape=built.run.shape,
                                mesh=built.run.mesh,
                                osdp=sel_plan.run.osdp), sel_plan)
    if not isinstance(sel.model.remat, tuple) or \
            sel.model._split_g("layers.ffn_w13") != TRAIN_SPLIT:
        _fail(f"train: the {SELECTIVE_GIB} GiB plan compiles to remat "
              f"{sel.model.remat} and split "
              f"{sel.model._split_g('layers.ffn_w13')}, not a selective "
              f"policy over a split in {TRAIN_SPLIT}")
    print(f"  {SELECTIVE_GIB} GiB plan: " + "; ".join(
        f"{op} {dec.modes[0]} x{dec.split} remat {dec.remat}"
        for op, dec in sel_plan.decisions.items())
        + f"; est. {sel_plan.cost.memory / 2**30:.2f} GiB")
    report("selective", _train_run(torch, sel, REMAT_STEPS, params,
                                   args.seed, "selective", S, batch))
    runs["selective"].update(plan_gib=SELECTIVE_GIB,
                             plan_est_mem_gib=sel_plan.cost.memory / 2**30)
    if runs["selective"]["losses"] != runs["remat_true"]["losses"]:
        _fail(f"train selective: losses {runs['selective']['losses']} differ "
              f"from global remat's {runs['remat_true']['losses']}")
    torch.cuda.empty_cache()

    layer_ops = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
                 "layers.ffn_w2")
    mixed_dec = {op: Decision(op, d.modes, (op not in layer_ops[:2],)
                              * d.split if op in layer_ops else d.remat)
                 for op, d in plan.decisions.items()}
    mixed = build_model(built.run, SimpleNamespace(decisions=mixed_dec))
    report("mixed", _train_run(torch, mixed, REMAT_STEPS, params,
                               args.seed, "mixed", S, batch))
    m = runs["mixed"]
    lo, hi = runs["remat_true"]["peak_mem_gib"], out["peak_mem_gib"]
    if not lo < m["peak_mem_gib"] < hi:
        _fail(f"train mixed: peak {m['peak_mem_gib']:.2f} GiB not between "
              f"global remat's {lo:.2f} and remat off's {hi:.2f}")
    off = res.losses[:REMAT_STEPS]
    worst = max(abs(a - b) / abs(b) for a, b in zip(m["losses"], off))
    if worst > 1e-3:
        _fail(f"train mixed: losses {m['losses']} off remat off's {off} by "
              f"{worst:.3g} relative (tol 1e-3)")
    m.update(loss_rel_err_vs_remat_off=worst,
             bit_identical_to_remat_off=m["losses"] == off,
             kept=sorted(t for t, n in m["products"].items()
                         if n == REMAT_STEPS * model.cfg.n_layers))
    print(f"  mixed plan: kept products {m['kept']} computed once a layer "
          f"({m['products']}); losses vs remat off: {worst:.3g} relative"
          f"{' (bit-identical)' if m['bit_identical_to_remat_off'] else ''}")
    return runs


def checkpoint_round_trip(torch, args, built, params) -> dict:
    """At full width and CKPT_LAYERS layers: CKPT_STEPS steps saving every
    step, then a fresh `train(resume=True)` to twice that, against an
    uninterrupted run: the losses equal bit for bit.  Saves and restores
    are timed and the bytes written counted; a corrupted leaf of the
    latest step must be refused.  The checkpoint directory is removed
    afterwards."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import train
    cfg = dataclasses.replace(built.run.model, n_layers=min(
        CKPT_LAYERS, built.run.model.n_layers))
    cut = build_model(dataclasses.replace(built.run, model=cfg),
                      SimpleNamespace(decisions=built.model.decisions))
    p = {k: (v[:cfg.n_layers] if k.startswith("layers/") else v)
         for k, v in params.items()}
    kw = dict(seed=args.seed, warmup=1, device="cuda", params=p,
              log_every=0, print_fn=lambda *a: None)
    full = train(cut, 2 * CKPT_STEPS, **kw)
    saves, restores = [], []
    save, restore = ckpt_io.save, ckpt_io.restore

    def timed(fn, into):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **k)
            into.append(time.perf_counter() - t)
            return r
        return inner
    ckpt_io.save, ckpt_io.restore = timed(save, saves), timed(restore,
                                                               restores)
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="ckpt-", dir=ROOT / "build")
    try:
        first = train(cut, CKPT_STEPS, ckpt_dir=d, ckpt_every=1,
                      keep_last=2, **kw)
        step_dir = Path(d) / f"step_{CKPT_STEPS:08d}"
        nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
        leaves = len(list(step_dir.glob("*.npy")))
        rest = train(cut, 2 * CKPT_STEPS, ckpt_dir=d, resume=True, **kw)
        if rest.start_step != CKPT_STEPS or \
                first.losses + rest.losses != full.losses:
            _fail(f"checkpoint: {first.losses} + resumed {rest.losses} "
                  f"(from step {rest.start_step}) differ from the "
                  f"uninterrupted run's {full.losses}")
        leaf = Path(d) / f"step_{2 * CKPT_STEPS:08d}" / "__0__embed__tok.npy"
        data = bytearray(leaf.read_bytes())
        data[-5] ^= 0x40
        leaf.write_bytes(bytes(data))
        try:
            train(cut, 2 * CKPT_STEPS + 1, ckpt_dir=d, resume=True, **kw)
            _fail("checkpoint: a corrupted leaf was restored")
        except ckpt_io.CheckpointCorruptError as e:
            refusal = str(e).splitlines()[0][:160]
    finally:
        ckpt_io.save, ckpt_io.restore = save, restore
        shutil.rmtree(d, ignore_errors=True)
    out = dict(n_layers=cfg.n_layers, steps=2 * CKPT_STEPS,
               losses=full.losses, resumed_from=rest.start_step,
               leaves=leaves, mb_written=nbytes / 1e6, save_s=saves,
               restore_s=restores, refusal=refusal)
    print(f"  checkpoint ({cfg.n_layers} layers, full width): {leaves} "
          f"leaves, {nbytes / 1e6:.1f} MB a step; save "
          + ", ".join(f"{t:.2f}" for t in saves) + " s; restore "
          + ", ".join(f"{t:.2f}" for t in restores) + " s; resumed at step "
          f"{rest.start_step}, losses bit-identical to the uninterrupted "
          f"run; corrupted leaf refused: {refusal}")
    return out


# --- phase 7: the OSDP plan sharded over a world-1 NCCL group --------------

def _segmented(params, pset) -> dict:
    """Full (single-segment) parameters cut into the segments `pset` lays
    out along each weight's ZDP axis."""
    out = {}
    for path, lay in pset.layouts.items():
        for seg in lay.segments:
            out[path + seg.key] = (params[path] if not lay.is_split else
                                   params[path].narrow(
                                       lay.spec.zdp_axis, seg.start,
                                       seg.size).contiguous())
    return out


def _want_collectives(built, steps) -> dict:
    """(kind, key) -> calls `steps` sharded steps imply: a use of every
    sharded leaf a step and microbatch (each layer its slice; the
    embedding one use for its lookup and head), each use 2 all-gathers
    (forward, backward) and 1 reduce-scatter, +1 all-gather in a
    recomputed layer; one all-reduce of the DP leaves a step (one per
    dtype) and one of the gradient norm, which carries the loss."""
    model = built.model
    n = steps * max(1, built.run.microbatch)
    want = {}
    for leaf in built.pset.sharded():
        layer = leaf.startswith("layers/")
        uses = n * (model.cfg.n_layers if layer else 1)
        want["all_gather", leaf] = uses * (3 if layer and model.remat else 2)
        want["reduce_scatter", leaf] = uses
    dp_dtypes = {spec.dtype for spec in built.specs
                 for leaf, _ in built.pset.segments(spec.path)
                 if built.pset.placements[leaf] is None}
    if dp_dtypes:
        want["all_reduce", "dp"] = steps * len(dp_dtypes)
    want["all_reduce", "grad_norm"] = steps
    return want


def _by_kind(calls: dict) -> dict:
    out = {}
    for (kind, _), n in calls.items():
        out[kind] = out.get(kind, 0) + n
    return out


def _gathered_bytes(built) -> int:
    """Bytes of the largest weight a use gathers: a layer's slice of a
    stacked leaf, or a whole leaf outside the layers."""
    best = 0
    for spec in built.specs:
        for leaf, seg in built.pset.segments(spec.path):
            if built.pset.placements[leaf] is None:
                continue
            shape = list(spec.shape)
            if spec.zdp_axis is not None:
                shape[spec.zdp_axis] = seg.size
            n = math.prod(shape[1:] if spec.stacked else shape)
            best = max(best, n * spec.dtype.itemsize)
    return best


def _run_steps(torch, built, params, steps, seed, keep=False) -> dict:
    """`steps` steps of `built` through `train()` from `params`, with the
    kernel launches and the mesh's collectives counted from zero, the
    peak memory, and (`keep`) the trained parameters on the host."""
    from repro_torch.kernels import ops
    from repro_torch.train.loop import train
    mesh = built.mesh
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    if mesh is not None:
        mesh.reset_counts()
    res = train(built, steps, seed=seed, warmup=1, device="cuda",
                params=params, log_every=0, print_fn=lambda *a: None)
    _check_persistent_roles(ops.split_matmul_variant_counts(),
                            "sharded train")
    steady = sorted(res.step_ms[1:]) or res.step_ms
    out = dict(losses=res.losses, grad_norms=res.grad_norms,
               step_ms=res.step_ms, median_step_ms=steady[len(steady) // 2],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=ops.launch_counts(),
               collectives=dict(mesh.calls) if mesh is not None else {})
    if keep:
        out["params"] = {k: v.detach().cpu() for k, v in res.params.items()}
    return out


def _profiled_collectives(torch, built, params, seed) -> dict:
    """One sharded step under the profiler: the NCCL collectives it
    issued by kind (the profiler's `nccl:` ranges on the host, one a
    call), their device time (`nccl:` ranges on the device; at world 1
    a gather or reduce-scatter is a device copy), the step's device and
    wall ms, and the mesh's own counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.plan import data_sharding
    from repro_torch.data.synthetic import Dataset
    from repro_torch.train.loop import restore_or_init
    mesh = built.mesh
    step_fn, p, st, _ = restore_or_init(built, None, seed=seed, warmup=1,
                                        device="cuda", params=params)
    rows = data_sharding(mesh)
    batch = {k: rows.local(torch.from_numpy(v)).cuda() for k, v in Dataset(
        built.run.model, built.run.shape, seed=seed).global_batch(0).items()}
    torch.cuda.synchronize()
    mesh.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn(p, st, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    calls, nccl_ms, device_ms = {}, 0.0, 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            if ev.key.startswith("nccl:"):
                kind = next((k for k in ("all_gather", "reduce_scatter",
                                         "all_reduce") if k in ev.key), None)
                if kind is None:
                    _fail(f"sharded: unknown NCCL call {ev.key}")
                calls[kind] = calls.get(kind, 0) + ev.count
        elif ev.key.startswith("nccl:"):
            nccl_ms += ev.device_time_total / 1e3
        elif ev.self_device_time_total > 0:
            device_ms += ev.self_device_time_total / 1e3
    out = dict(nccl_calls=calls, mesh_calls=_by_kind(mesh.calls),
               nccl_device_ms=nccl_ms, device_ms=device_ms, wall_ms=wall)
    del p, st
    torch.cuda.empty_cache()
    return out


def sharded_phase(torch, args, built6, params, phase6) -> dict:
    """Phase 7: a world-1 NCCL group (a `file://` store under build/);
    3 steps under the forced ZDP plan at remat off (on phase 6's
    weights) and 3 under the mixed DP/ZDP plan of
    tests/test_torch_train.py (`MIXED`) at remat on, each sharded and on
    one device without a group.  At world 1 every collective is a copy
    and AVG divides by 1: the ZDP plan's losses, grad norms and final
    parameters must equal the unsharded run's bit for bit, the mixed
    plan's losses within MIXED_LOSS_TOL.  Checked besides: the kernel
    launches (the plan's, as unsharded), the mesh's collectives (each
    sharded leaf 2 gathers and 1 reduce-scatter a use, +1 gather in a
    recomputed layer; one all-reduce of the DP leaves and one of the
    norm a step), the NCCL calls of a profiled step against them, and a
    peak within the unsharded run's (and phase 6's) plus twice the
    largest gathered weight."""
    import os
    import torch.distributed as dist
    from repro_torch.configs import DeviceInfo, RunConfig, get_arch
    from repro_torch.core.api import osdp
    from repro_torch.core.cost_model import Decision
    from repro_torch.launch.mesh import init_data_mesh
    from repro_torch.models.registry import build_model
    if not dist.is_nccl_available():
        _fail("sharded: this torch has no NCCL")
    run6 = built6.run
    S = run6.shape.seq_len
    store = ROOT / "build" / f"nccl-store-{os.getpid()}"
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    mesh = init_data_mesh("nccl", f"file://{store}", 1, 0)
    out = {"init_s": time.perf_counter() - t0, "backend": mesh.backend,
           "world": mesh.world}
    try:
        zplan = osdp(get_arch(TRAIN_ARCH), run6.shape, run6.mesh,
                     memory_limit_gib=64.0,
                     device=DeviceInfo.preset("h100-sxm"), force_mode="ZDP",
                     checkpointing=False)
        zrun = dataclasses.replace(run6, osdp=zplan.run.osdp)
        mixed_dec = {op: Decision(op, SHARD_MIXED) for op in SHARD_MIXED_OPS}
        mrun = dataclasses.replace(run6, osdp=dataclasses.replace(
            zplan.run.osdp, force_mode=None, checkpointing=True))
        cases = (("zdp", zrun, zplan, False),
                 ("mixed", mrun, SimpleNamespace(decisions=mixed_dec), True))
        for name, run, plan, remat in cases:
            plain = build_model(run, plan)
            sharded = build_model(run, plan, mesh)
            if plain.model.remat is not remat or not sharded.pset.sharded():
                _fail(f"sharded {name}: remat {plain.model.remat}, sharded "
                      f"leaves {sorted(sharded.pset.sharded())}")
            p = params if name == "zdp" else _segmented(params, plain.pset)
            exact = name == "zdp"
            u = _run_steps(torch, plain, p, SHARD_STEPS, args.seed, exact)
            r = _run_steps(torch, sharded, p, SHARD_STEPS, args.seed, exact)
            want_l, _ = _want_train_launches(sharded, SHARD_STEPS, S)
            want_c = _want_collectives(sharded, SHARD_STEPS)
            if r["launches"] != want_l or u["launches"] != want_l:
                _fail(f"sharded {name}: launches {r['launches']} (one "
                      f"device: {u['launches']}), the plan needs {want_l}")
            if r["collectives"] != want_c:
                _fail(f"sharded {name}: collectives {r['collectives']}, the "
                      f"plan needs {want_c}")
            if exact:
                same = (r["losses"] == u["losses"]
                        and r["grad_norms"] == u["grad_norms"]
                        and all(torch.equal(r["params"][k], u["params"][k])
                                for k in u["params"]))
                if not same:
                    bad = [k for k in u["params"]
                           if not torch.equal(r["params"][k], u["params"][k])]
                    _fail(f"sharded {name}: not bit-identical to one device: "
                          f"losses {r['losses']} vs {u['losses']}, norms "
                          f"{r['grad_norms']} vs {u['grad_norms']}, "
                          f"parameters {bad[:5]}")
                del r["params"], u["params"]
            worst = max(abs(a - b) / abs(b)
                        for a, b in zip(r["losses"], u["losses"]))
            if worst > MIXED_LOSS_TOL:
                _fail(f"sharded {name}: losses {r['losses']} off one "
                      f"device's {u['losses']} by {worst:.3g}")
            gathered = _gathered_bytes(sharded) / 2**30
            bound = u["peak_mem_gib"] + 2 * gathered
            if exact:
                bound = min(bound, phase6["peak_mem_gib"] + 2 * gathered)
            if not r["peak_mem_gib"] <= bound:
                _fail(f"sharded {name}: peak {r['peak_mem_gib']:.3f} GiB "
                      f"above {bound:.3f} (one device {u['peak_mem_gib']:.3f}"
                      f", phase 6 {phase6['peak_mem_gib']:.3f}, largest "
                      f"gathered weight {gathered:.3f})")
            prof = _profiled_collectives(torch, sharded, p, args.seed)
            want1 = _by_kind(_want_collectives(sharded, 1))
            if prof["nccl_calls"] != want1 or prof["mesh_calls"] != want1:
                _fail(f"sharded {name}: a profiled step issued NCCL calls "
                      f"{prof['nccl_calls']} (mesh counted "
                      f"{prof['mesh_calls']}), the plan needs {want1}")
            ops_calls = {}
            for (kind, leaf), n in r["collectives"].items():
                spec = next((sp for sp in sharded.specs
                             if sp.path == leaf.split("@")[0]), None)
                op = spec.op if spec is not None else leaf
                ops_calls.setdefault(op, {}).setdefault(kind, 0)
                ops_calls[op][kind] += n
            r["collectives"] = {f"{kind} {leaf}": n for (kind, leaf), n
                                in r["collectives"].items()}
            out[name] = dict(
                sharded=r, one_device=u, loss_rel_err=worst,
                bit_identical=(r["losses"] == u["losses"]
                               and r["grad_norms"] == u["grad_norms"]),
                n_sharded_leaves=len(sharded.pset.sharded()),
                guarded=list(sharded.pset.guarded),
                largest_gathered_gib=gathered, peak_bound_gib=bound,
                collectives_by_op=ops_calls, profiled_step=prof)
            print(f"train {TRAIN_ARCH} sharded {name} (world 1, NCCL; remat "
                  f"{remat}): {len(sharded.pset.sharded())} leaves sharded; "
                  f"median step {r['median_step_ms']:.1f} ms (one device "
                  f"{u['median_step_ms']:.1f}, phase 6 "
                  f"{phase6['median_step_ms']:.1f}); peak "
                  f"{r['peak_mem_gib']:.3f} GiB (one device "
                  f"{u['peak_mem_gib']:.3f}, phase 6 "
                  f"{phase6['peak_mem_gib']:.3f}, bound {bound:.3f}); "
                  f"losses " + " ".join(f"{x:.6f}" for x in r["losses"])
                  + (" bit-identical to one device (norms and parameters "
                     "too)" if exact else f", {worst:.3g} off one device")
                  + f"; collectives a step {want1} (profiled NCCL calls "
                  f"{prof['nccl_calls']}, {prof['nccl_device_ms']:.2f} ms of "
                  f"{prof['device_ms']:.2f} device ms); by op "
                  + "; ".join(f"{op} {c}" for op, c in ops_calls.items()))
            torch.cuda.empty_cache()
    finally:
        mesh.destroy()
        store.unlink(missing_ok=True)
    return out


# --- phase 8: calibration and the planner against the card -----------------

def _replan(profile, serves, trained) -> dict:
    """Phase 6's 64 GiB and SELECTIVE_GIB plans, phase 3's phi4 serve plan
    and phase 7's forced ZDP plan, planned with the preset (`profile`
    None) and with `profile`: the decisions that differ, the estimates
    under each, and what the card measured for the same plan."""
    from repro_torch.configs import (DeviceInfo, MeshConfig, ShapeConfig,
                                     get_arch, get_shape)
    from repro_torch.core.api import osdp, search_serve
    from repro_torch.core.cost_model import CostEnv, serving_plan_cost
    from repro_torch.core.descriptions import describe
    h100 = DeviceInfo.preset("h100-sxm")
    mesh = MeshConfig((1, 1), ("data", "model"))
    shape = dataclasses.replace(get_shape("train_4k"),
                                global_batch=TRAIN_BATCH)
    qw, phi = get_arch(TRAIN_ARCH), get_arch(ARCHS[0])
    tr, sv = trained, serves[ARCHS[0]]
    zdp = tr["sharded"]["zdp"]["sharded"]

    def train_plan(gib, **kw):
        return lambda p: osdp(qw, shape, mesh, memory_limit_gib=gib,
                              device=h100, profile=p, **kw)

    train_cases = (
        ("train 64 GiB selective", train_plan(64.0,
                                              checkpointing="selective"), tr),
        (f"train {SELECTIVE_GIB:g} GiB selective",
         train_plan(SELECTIVE_GIB, checkpointing="selective"),
         tr["selective"]),
        ("train forced ZDP, world 1", train_plan(
            64.0, force_mode="ZDP", checkpointing=False), zdp))
    out = {}
    for name, make, meas in train_cases:
        pre, fitted = make(None), make(profile)
        out[name] = dict(
            differ=_differ(pre, fitted),
            est_step_ms={"preset": pre.cost.time * 1e3,
                         "fitted": fitted.cost.time * 1e3},
            est_mem_gib={"preset": pre.cost.memory / 2**30,
                         "fitted": fitted.cost.memory / 2**30},
            measured_step_ms=meas["median_step_ms"],
            measured_peak_gib=meas["peak_mem_gib"])

    # serving: the estimates at the plan's own slots, and the decode step
    # and memory at the slots the card served with
    slots = sv["slots"]
    desc_pre = describe(phi, ShapeConfig("serve_prefill", 512, 1, "prefill"))
    desc_dec = describe(phi, ShapeConfig("serve_decode", 1, 1, "decode"))
    rows = {}
    for key, p in (("preset", None), ("fitted", profile)):
        plan = search_serve(phi, prompt_len=512, decode_len=32, n_devices=1,
                            memory_limit_gib=64.0, device=h100, profile=p)
        env = CostEnv(h100, mesh, checkpointing=False, train=False,
                      profile=p)
        at = serving_plan_cost(desc_pre, desc_dec, plan.decisions,
                               plan.workload, env, slots)
        rows[key] = (plan, at)
    (pre, pre_at), (fit_, fit_at) = rows["preset"], rows["fitted"]
    out["serve phi4 (64 GiB)"] = dict(
        differ=_differ(pre, fit_),
        plan_slots={"preset": pre.slots_per_device,
                    "fitted": fit_.slots_per_device},
        est_ttft_ms={"preset": pre.cost.ttft * 1e3,
                     "fitted": fit_.cost.ttft * 1e3},
        est_decode_step_ms_plan_slots={
            "preset": pre.cost.decode_step_time * 1e3,
            "fitted": fit_.cost.decode_step_time * 1e3},
        slots=slots,
        est_decode_step_ms={"preset": pre_at.decode_step_time * 1e3,
                            "fitted": fit_at.decode_step_time * 1e3},
        est_mem_gib={"preset": pre_at.memory / 2**30,
                     "fitted": fit_at.memory / 2**30},
        measured_prefill512_ms=sv["prefill512_ms"],
        measured_decode_step_ms=sv["decode_step_ms"],
        measured_peak_gib=sv["peak_mem_gib"])
    return out


def _differ(a, b) -> dict:
    """The operators whose (modes, remat) differ between two plans."""
    return {op: [list(d.modes), d.remat, list(b.decisions[op].modes),
                 b.decisions[op].remat]
            for op, d in a.decisions.items()
            if (d.modes, d.remat) != (b.decisions[op].modes,
                                      b.decisions[op].remat)}


def calibrate_phase(torch, args, serves, trained) -> dict:
    """Phase 8: the three sweeps of `python -m repro_torch calibrate` on
    the card at the committed profile's ladder and remat chain, with the
    launch counts zeroed just before and read just after (the ladder and
    the chain through `split_matmul`, its dgrad and wgrad); the fits; no
    raw rate above PEAK_BF16; each ladder product and the chain's
    products against their plain versions; the checkpointed chain's
    gradients equal to the plain chain's bit for bit; the fitted profile
    round-trips JSON and the committed one loads through
    `store.load_and_register`; then the plans replanned with the preset
    and with the committed profile, beside what phases 3, 6 and 7
    measured (an estimate's error is reported, not a gate)."""
    from repro_torch.calibrate import bench, fit, store
    from repro_torch.calibrate.profile import CalibrationProfile
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    depth, width, batch = CALIBRATE_REMAT
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    mm = bench.matmul_sweep(CALIBRATE_LADDER, repeats=CALIBRATE_REPEATS,
                            device="cuda")
    t_plain, t_remat = bench.remat_sweep(depth, width, batch,
                                         CALIBRATE_REPEATS, "cuda")
    counts = ops.launch_counts()
    _check_persistent_roles(ops.split_matmul_variant_counts(), "calibrate")
    sweep_s = time.perf_counter() - t0
    calls = 1 + CALIBRATE_REPEATS          # a warm-up, then the repeats
    want = dict.fromkeys(counts, 0)
    want.update(split_matmul=calls * (len(CALIBRATE_LADDER) + 3 * depth),
                split_matmul_dgrad=2 * calls * (depth - 1),
                split_matmul_wgrad=2 * calls * depth)
    if counts != want:
        _fail(f"calibrate: the sweeps launched {counts}, the ladder and "
              f"the remat chain need {want}")
    # one card: the data axis spans 1, so no bytes move and no link fits
    sweeps = bench.collective_sweep(make_host_mesh(), bench.DEFAULT_BW_MIB,
                                    CALIBRATE_REPEATS)
    links = fit.fit_link_calibrations(sweeps)
    if any(sweeps.values()) or links:
        _fail(f"calibrate: a world-1 mesh moved bytes: {sweeps}")
    rates = [f / s for f, s in mm]
    if max(rates) > PEAK_BF16:
        _fail(f"calibrate: an achieved rate of {max(rates):.4g} FLOP/s is "
              f"above the card's peak {PEAK_BF16:.4g}")
    curve = fit.fit_efficiency_curve(mm, peak_flops=PEAK_BF16)
    remat = fit.fit_remat_factor(t_plain, t_remat)
    fitted = CalibrationProfile(
        device="h100-sxm", efficiency=curve, links=links,
        remat_factor=remat, peak_flops=PEAK_BF16,
        source=f"chip_smoke.py phase 8 ({_card()})")
    if CalibrationProfile.from_json(fitted.to_json()) != fitted:
        _fail("calibrate: the fitted profile does not round-trip JSON")

    ws, x = bench.remat_chain(depth, width, batch, "cuda")
    g_plain = bench.chain_grads(ws, x, remat=False)
    g_remat = bench.chain_grads(ws, x, remat=True)
    if not all(torch.equal(a, b) for a, b in zip(g_plain, g_remat)):
        _fail("calibrate: the checkpointed chain's gradients differ from "
              "the plain chain's")
    del ws, x, g_plain, g_remat
    torch.cuda.empty_cache()
    ladder = [check_split_matmul(torch, n, n, n, gen)
              for n in CALIBRATE_LADDER]
    chain = {"split_matmul": check_split_matmul(torch, batch, width, width,
                                                gen),
             "split_matmul_dgrad": check_matmul_grad(torch, "dgrad", batch,
                                                     width, width, gen),
             "split_matmul_wgrad": check_matmul_grad(torch, "wgrad", batch,
                                                     width, width, gen)}
    torch.cuda.empty_cache()

    store.clear()
    try:
        committed = store.load_and_register(ROOT / CALIBRATE_PROFILE)
        if store.resolve("h100-sxm") != committed:
            _fail("calibrate: the store does not resolve h100-sxm to the "
                  "committed profile")
    finally:
        store.clear()
    knots = [math.log10(2.0 * n ** 3) for n in CALIBRATE_LADDER]
    if not (committed.peak_flops == PEAK_BF16 and not committed.links
            and all(abs(a - b) < 1e-9 for a, b in
                    zip(committed.efficiency.log10_flops, knots))
            and len(committed.efficiency.log10_flops) == len(knots)):
        _fail(f"calibrate: the committed profile ({committed.source}) was "
              f"not fitted at peak {PEAK_BF16:g} over the ladder "
              f"{CALIBRATE_LADDER} on one card")
    plans = _replan(committed, serves, trained)
    model_ratio = (trained["remat_true"]["median_step_ms"]
                   / trained["median_step_ms"])
    out = dict(seconds=time.perf_counter() - t0, sweep_s=sweep_s,
               launches=counts, fitted=fitted.to_dict(),
               committed=committed.to_dict(),
               matmul=[dict(n=n, flops=f, seconds=s, rate=f / s,
                            fraction=f / s / PEAK_BF16)
                       for n, (f, s) in zip(CALIBRATE_LADDER, mm)],
               remat_plain_s=t_plain, remat_remat_s=t_remat,
               remat_factor=remat, model_remat_ratio=model_ratio,
               ladder=ladder, chain=chain, plans=plans)
    print(f"calibrate: sweeps {sweep_s:.1f} s; launches {counts}; ladder "
          "(n: ms a call, fraction of peak, fitted): " + "; ".join(
              f"{n}: {1e3 * s:.4f}, {f / s / PEAK_BF16:.4g}, {c:.4g}"
              for n, (f, s), c in zip(CALIBRATE_LADDER, mm, curve.fraction)))
    print(f"  ladder products against the plain version: " + "; ".join(
        f"{r['shape'][0]} err {r['max_abs_err']:.3g} kernel {r['ms']:.4f} "
        f"ms (graph) bound {r['bound_ms']:.4f}" for r in ladder)
        + f" (tol {KERNEL_TOL}); no rate above {PEAK_BF16:g}")
    print(f"  remat chain depth {depth} width {width} batch {batch}: plain "
          f"{1e3 * t_plain:.3f} ms, checkpointed {1e3 * t_remat:.3f} ms: "
          f"factor {remat:.4f} (committed {committed.remat_factor:.4f}; "
          f"{TRAIN_ARCH}'s global remat step over remat off's: "
          f"{model_ratio:.4f}); gradients bit-identical; products "
          + ", ".join(f"{k} {r['shape']} err {r['max_abs_err']:.3g}"
                      for k, r in chain.items()))
    cut = " (measured at a depth cut)" if args.layers else ""
    for name, r in plans.items():
        est = ", ".join(f"{k} {r[k]['preset']:.2f} -> {r[k]['fitted']:.2f}"
                        for k in r if isinstance(r[k], dict)
                        and "preset" in r[k])
        meas = ", ".join(f"{k} {v:.2f}" for k, v in r.items()
                         if k.startswith("measured"))
        print(f"  replan {name} (preset -> committed profile): decisions "
              f"that differ {r['differ'] or 'none'}; {est}; card{cut}: "
              f"{meas}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut each model's depth to this many layers "
                         "(0 = full)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the JSON report goes (relative to the "
                         "repository root)")
    args = ap.parse_args(argv)
    torch = _setup()
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _lib
    from repro_torch.kernels import split_matmul as sm

    report: dict = {"card": _card(),
                    "device": torch.cuda.get_device_name(0)}
    out_path = ROOT / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    # 1. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    _lib.lib()
    report["build_s"] = time.perf_counter() - t0
    ptxas = _ptxas(_lib.build_log)
    print(f"build: {report['build_s']:.1f} s (nvcc sm_90a, "
          f"{len(list((ROOT / 'src/repro_torch/csrc').glob('*.cu')))} "
          f"sources)")
    for ln in ptxas:
        print("  ptxas:", ln)
    report["ptxas"] = ptxas

    # 2. kernels at the paths' shapes -----------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phi = get_arch(ARCHS[0])
    d, ff, Vp = phi.d_model, phi.d_ff, phi.padded_vocab
    qf = phi.n_heads * phi.resolved_head_dim
    kvf = phi.n_kv_heads * phi.resolved_head_dim
    prompt_rows, slot_rows = 333, 8        # a ragged prompt; 8 decode slots
    mm = []
    for M in (prompt_rows, slot_rows):
        for K, N in ((d, qf), (d, kvf), (d, 2 * ff), (ff, d)):
            mm.append(check_split_matmul(torch, M, K, N, gen))
    for M in (1, slot_rows):               # head: last prompt row; decode
        mm.append(check_split_matmul(torch, M, d, Vp, gen))
    fl = [check_flash(torch, S, gen) for S in (prompt_rows, 512)]
    mam = get_arch(ARCHS[1])
    dm, di = mam.d_model, mam.ssm_d_inner
    mm_mam = []                            # w_zx, w_bcdt, wo; then the head
    for M in (prompt_rows, slot_rows):
        for K, N in ((dm, 2 * di), (dm, 2 * mam.ssm_state + mam.ssm_n_heads),
                     (di, dm)):
            mm_mam.append(check_split_matmul(torch, M, K, N, gen))
    for M in (1, slot_rows):
        mm_mam.append(check_split_matmul(torch, M, dm, mam.padded_vocab,
                                         gen))
    ssd = [check_ssd(torch, B, S, gen, nh=mam.ssm_n_heads,
                     hd=mam.ssm_head_dim, ns=mam.ssm_state,
                     chunk=mam.ssm_chunk)
           for B, S in ((1, prompt_rows), (1, 512), (slot_rows, 512))]
    for name, rows, tol in (("split_matmul", mm + mm_mam, KERNEL_TOL),
                            ("flash_attention", fl, KERNEL_TOL),
                            ("ssd_scan", ssd, SSD_TOL)):
        for r in rows:
            lib = ("none (no single PyTorch call computes it)"
                   if r["library_ms"] is None
                   else f"{r['library_ms']:.4f} ms")
            err = (f"{r['max_abs_err']:.3g}" if "max_scaled_err" not in r
                   else f"{r['max_abs_err']:.3g}, of 1 + |ref| "
                   f"{r['max_scaled_err']:.3g}")
            design = (f" [{r['variant']} bn {r['bn']} x {r['splits']} "
                      f"splits, {r['blocks']} blocks]" if "variant" in r
                      else f" [head group {r['head_group']}, blocks "
                      f"{'/'.join(map(str, r['blocks']))}, workspace "
                      f"{r['workspace_bytes'] / 1e6:.2f} MB]"
                      if "head_group" in r else "")
            path = (f", through ops {r['path_eager_ms']:.4f}"
                    if "path_eager_ms" in r else "")
            print(f"  {name:15s} {str(r['shape']):26s}{design} err {err} "
                  f"(tol {tol}) kernel {r['ms']:.4f} ms (eager "
                  f"{r['eager_ms']:.4f}{path}), plain {r['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    report["split_matmul"] = {ARCHS[0]: mm, ARCHS[1]: mm_mam}
    report["flash_attention"] = fl
    report["ssd_scan"] = ssd
    ssd_design = check_ssd_design(torch, gen, mam)
    report["ssd_scan_design"] = ssd_design
    print(f"  ssd_scan: no spills; a repeated call bit-identical; passes "
          f"at (1, 512): " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in ssd_design["pass_ms"].items()))
    n_opt = check_options(torch, gen)
    print(f"  options: {n_opt} cases off the serve paths (f32, ragged, "
          f"each matmul design at M 1..65, K slices and splits, N against "
          f"a 128 tile, the accumulating form in every design and the "
          f"split-K reduce ({len(ACC_CASES)} cases), hd 64, G 1 and 4, "
          f"windows, offsets, non-causal, "
          f"scan init states, hymba's scan shapes, {len(SSD_CASES)} scan "
          f"cases: " + "; ".join(c[-1] for c in SSD_CASES) + ") agree with "
          f"the plain versions")
    torch.cuda.empty_cache()

    # 5. the kernels at the training step's shapes ----------------------------
    qw = get_arch(TRAIN_ARCH)
    rows, head_rows = TRAIN_BATCH * 4096, TRAIN_BATCH * 512
    dq, ffq = qw.d_model, qw.d_ff
    kv_heads, group = qw.n_kv_heads, qw.n_heads // qw.n_kv_heads
    bwd = {"split_matmul_dgrad": [], "split_matmul_wgrad": []}
    mm_train, fl_train = [], [check_flash(torch, 4096, gen, kv_heads, group,
                                          qw.resolved_head_dim, TRAIN_BATCH)]
    for K, N in ((dq, qw.n_heads * qw.resolved_head_dim), (dq, 2 * ffq),
                 (ffq, dq)):
        mm_train.append(check_split_matmul(torch, rows, K, N, gen))
        for role in ("dgrad", "wgrad"):
            bwd[f"split_matmul_{role}"].append(
                check_matmul_grad(torch, role, rows, K, N, gen))
    # the chunked FFN of the plan's uniform split: the w13 chunk (d x 2c),
    # the w2 chunk (c x d) added into the fp32 sum, their dgrad / wgrad
    c = ffq // TRAIN_SPLIT
    mm_train.append(check_split_matmul(torch, rows, dq, 2 * c, gen))
    acc_train = [check_split_matmul_acc(torch, rows, c, dq, gen)]
    for K, N in ((dq, 2 * c), (c, dq)):
        for role in ("dgrad", "wgrad"):
            bwd[f"split_matmul_{role}"].append(
                check_matmul_grad(torch, role, rows, K, N, gen))
    for role in ("dgrad", "wgrad"):            # the tied head, a CE chunk
        bwd[f"split_matmul_{role}"].append(check_matmul_grad(
            torch, role, head_rows, dq, qw.padded_vocab, gen,
            transpose_w=True))
    head_fwd = check_matmul_grad(torch, "forward", head_rows, dq,
                                 qw.padded_vocab, gen, transpose_w=True)
    bwd["flash_attention_bwd"] = [check_flash_bwd(
        torch, gen, TRAIN_BATCH, 4096, kv_heads, group, qw.resolved_head_dim)]
    fwd = {"split_matmul": mm_train, "split_matmul_acc": acc_train,
           "flash_attention": fl_train}
    for name, rows_ in list(fwd.items()) + list(bwd.items()):
        for r in rows_ + ([head_fwd] if name == "split_matmul_wgrad" else []):
            lib = f"{r['library_ms']:.4f} ms" + (
                f" ({r['library']})" if "library" in r else "")
            design = _plan_text(r) if "variant" in r else ""
            label = (name if r is not head_fwd
                     else "split_matmul (tied head, nt)")
            if r.get("acc"):
                design += f" (bf16 out {r['bf16_out_ms']:.4f} ms)"
            print(f"  {label:19s} {str(r['shape']):22s}{design} err "
                  f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms (eager "
                  f"{r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    persistent_ptx = check_persistent_spills()
    print("  split_matmul persistent kernels: no spills ("
          + "; ".join(persistent_ptx) + ")")
    report["split_matmul_persistent_ptxas"] = persistent_ptx
    bwd_design = check_flash_bwd_design(
        torch, gen, TRAIN_BATCH, 4096, kv_heads, group, qw.resolved_head_dim)
    print(f"  flash_attention_bwd: no spills ("
          + "; ".join(bwd_design["ptxas"]) + f"); {bwd_design['blocks']} "
          f"blocks of {bwd_design['tiles'][1]} keys, {bwd_design['tiles'][0]}"
          f" query rows a step, {bwd_design['tile_pairs']} tile pairs of "
          f"which {bwd_design['edge_pairs']} masked, {bwd_design['smem']} B "
          f"shared, {bwd_design['scratch_mib']:.1f} MiB scratch; kernels "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in
                      bwd_design["kernel_ms"].items()))
    report.update(bwd)
    report["flash_attention_bwd_design"] = bwd_design
    report["train_forward"] = fwd
    report["split_matmul_head_nt"] = head_fwd
    n_bwd = check_backward_options(torch, gen)
    print(f"  backward options: {n_bwd} cases off the training path ("
          + "; ".join(c[-1] for c in FLASH_BWD_CASES) + "; matmul "
          + "; ".join(c[-1] for c in MATMUL_GRAD_CASES) + ", bf16 and f32)"
          " agree with the plain versions; every repeated backward "
          "bit-identical")
    ran = check_persistent_widths(torch, gen)
    print(f"  persistent kernel: {2 * len(ran)} calls (bn "
          f"{', '.join(map(str, sm.PERSISTENT_BNS))}; nt, nn and tn; one "
          f"split and 2 through fp32 partials) at {PERSISTENT_SWEEP}, one "
          f"k-step a tile a split, agree with the fp32 product and repeat "
          f"bit-identically")
    torch.cuda.empty_cache()

    # 5b. the SSM family's step (mamba2-2.7b at batch 8 x 4096): the scan
    # forward and its backward, and split_matmul's roles at its products
    ssm_plan_, ssm_built = ssm_plan(args)
    nh, hd, ns, chunk = (mam.ssm_n_heads, mam.ssm_head_dim, mam.ssm_state,
                         mam.ssm_chunk)
    ssd_train = check_ssd(torch, TRAIN_BATCH, 4096, gen, nh, hd, ns, chunk)
    torch.cuda.empty_cache()
    ssd_bwd = [check_ssd_bwd(torch, gen, TRAIN_BATCH, 4096, nh, hd, ns,
                             chunk)]
    torch.cuda.empty_cache()
    ssd_bwd += [check_ssd_bwd(torch, gen, 1, prompt_rows, nh, hd, ns, chunk,
                              autograd=True),
                check_ssd_bwd(torch, gen, 1, 512, nh, hd, ns, chunk,
                              dfin=True)]
    for B_, S_, dt_, dfin_, init_, _ in SSD_BWD_CASES:
        check_ssd_bwd(torch, gen, B_, S_, nh, hd, ns, chunk,
                      dtype=getattr(torch, dt_), dfin=dfin_, init=init_,
                      timed=False)
    bwd_ssd_design = check_ssd_bwd_design(torch, gen, TRAIN_BATCH, 4096, nh,
                                          hd, ns, chunk)
    torch.cuda.empty_cache()
    r = ssd_train
    print(f"  ssd_scan        {str(r['shape']):26s} err {r['max_abs_err']:.3g}"
          f", of 1 + |ref| {r['max_scaled_err']:.3g} (tol {SSD_TOL}) kernel "
          f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f}), plain "
          f"{r['plain_ms']:.4f} ms, library none, bound {r['bound_ms']:.4f} "
          f"ms ({r['bound_by']}); workspace {r['workspace_bytes'] / 1e6:.1f}"
          f" MB")
    for r in ssd_bwd:
        print(f"  ssd_scan_bwd    {str(r['shape']):26s} dfin {r['dfin']}: "
              + ", ".join(f"{n} {r['rel_errs'][n]:.3g} (floor "
                          f"{r['floors'][n]:.2g}, tol {r['tols'][n]:.2g})"
                          for n in SSD_BWD_NAMES)
              + (", autograd of the plain scan " + ", ".join(
                  f"{n} {v:.3g}" for n, v in r["autograd_errs"].items())
                 if r["autograd_errs"] else "")
              + f"; kernel {r['ms']:.4f} ms (eager {r['eager_ms']:.4f}), "
              f"plain {r['plain_ms']:.4f} ms, library none, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); workspace "
              f"{r['workspace_bytes'] / 1e6:.1f} MB")
    print(f"  ssd_scan_bwd: no spills ("
          + "; ".join(bwd_ssd_design["ptxas"]) + "); repeated calls "
          f"bit-identical; {len(SSD_BWD_CASES)} off-path cases ("
          + "; ".join(c[-1] for c in SSD_BWD_CASES) + f") agree; plan at "
          f"{ssd_bwd[0]['shape'][:2]}: {bwd_ssd_design['plan']}; kernels "
          f"there: " + ", ".join(
              f"{k} {v:.4f} ms" for k, v in
              bwd_ssd_design["kernel_ms"].items()))
    mm_ssm = []
    bwd_ssm = {"split_matmul_dgrad": [], "split_matmul_wgrad": []}
    for path, M, K, N in ssm_products(ssm_built):
        mm_ssm.append(dict(check_split_matmul(torch, M, K, N, gen),
                           path=path))
        for role in ("dgrad", "wgrad"):
            bwd_ssm[f"split_matmul_{role}"].append(dict(
                check_matmul_grad(torch, role, M, K, N, gen), path=path))
    for name, rows_ in [("split_matmul", mm_ssm)] + list(bwd_ssm.items()):
        for r in rows_:
            print(f"  {name:19s} {r['path']:18s} {str(r['shape']):22s}"
                  f"{_plan_text(r)} err {r['max_abs_err']:.3g} kernel "
                  f"{r['ms']:.4f} ms (eager {r['eager_ms']:.4f}), plain "
                  f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
                  f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    report["ssd_scan_train"] = ssd_train
    report["ssd_scan_bwd"] = ssd_bwd
    report["ssd_scan_bwd_design"] = bwd_ssd_design
    report["ssm_train_forward"] = mm_ssm
    report["ssm_train_backward"] = bwd_ssm
    torch.cuda.empty_cache()

    # 3-4. serve each model, then its whole-model logits ----------------------
    serves = {}
    for arch in ARCHS:
        serves[arch] = serve_phase(torch, np, arch, args)
        torch.cuda.empty_cache()
    report["serve"] = serves

    # 6. train qwen1.5-0.5b ---------------------------------------------------
    trained = train_phase(torch, args)
    report["train"] = trained
    torch.cuda.empty_cache()
    shard = trained["sharded"]

    # 6b. train mamba2-2.7b ---------------------------------------------------
    ssm_trained = ssm_train_phase(torch, args, ssm_plan_, ssm_built)
    report["train_ssm"] = ssm_trained
    torch.cuda.empty_cache()

    # 8. calibration and the planner against the card ---------------------
    calib = calibrate_phase(torch, args, serves, trained)
    report["calibrate"] = calib
    torch.cuda.empty_cache()
    paths = dict(serves, train=trained, train_ssm=ssm_trained,
                 **{f"train_sharded_{n}": shard[n]["sharded"]
                    for n in ("zdp", "mixed")}, calibrate=calib)

    # 5. report ---------------------------------------------------------------
    def launches(name):
        return sum(s["launches"][name] for s in paths.values())

    # every path shape each kernel was checked and timed at
    checked = {"split_matmul": mm + mm_mam + mm_train + [head_fwd] + mm_ssm,
               "split_matmul_acc": acc_train,
               "flash_attention": fl + fl_train,
               "ssd_scan": ssd + [ssd_train], "ssd_scan_bwd": ssd_bwd,
               **{k: v + bwd_ssm.get(k, []) for k, v in bwd.items()}}
    checked["split_matmul"] = checked["split_matmul"] + calib["ladder"]
    for name, r in calib["chain"].items():
        checked[name] = checked[name] + [r]

    def entry(name, r):
        src, replaces = SOURCES[name]
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches(name),
                    launches_by_path={a: s["launches"][name]
                                      for a, s in paths.items()},
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    shape=r["shape"], eager_ms=r["eager_ms"],
                    **{k: r[k] for k in ("variant", "bn", "splits",
                                         "path_eager_ms") if k in r},
                    shapes=[{k: c[k] for k in (
                        "shape", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}
                        for c in checked[name]])

    # representative shapes: the decode head product, the full prompt
    kernels = [entry("split_matmul", mm[-1]),
               # the chunked FFN's w2 chunk added into the fp32 sum
               entry("split_matmul_acc", acc_train[0]),
               entry("flash_attention", fl[-1]),
               dict(entry("ssd_scan", ssd[1]),
                    kernels_per_call=ssd_design["kernels_per_call"],
                    pass_ms=ssd_design["pass_ms"],
                    head_group=ssd[1]["head_group"],
                    workspace_bytes=ssd[1]["workspace_bytes"]),
               # the largest layer products: w13's dgrad and wgrad
               entry("split_matmul_dgrad", bwd["split_matmul_dgrad"][1]),
               entry("split_matmul_wgrad", bwd["split_matmul_wgrad"][1]),
               dict(entry("flash_attention_bwd",
                          bwd["flash_attention_bwd"][0]),
                    kernel_ms=bwd_design["kernel_ms"],
                    blocks=bwd_design["blocks"]),
               # the training step's shape, (8, 4096, 80, 64)
               dict(entry("ssd_scan_bwd", ssd_bwd[0]),
                    kernels_per_call=bwd_ssd_design["kernels_per_call"],
                    kernel_ms=bwd_ssd_design["kernel_ms"],
                    rel_errs=ssd_bwd[0]["rel_errs"],
                    workspace_bytes=ssd_bwd[0]["workspace_bytes"])]
    report["seconds"] = time.perf_counter() - t_start
    out_path.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    for arch, sv in serves.items():
        print(f"serve metrics {arch} ({report['card']}): "
              f"{sv['tokens_per_s']:.1f} tok/s, ttft p50 "
              f"{sv['ttft_p50_ms']:.1f} ms max {sv['ttft_max_ms']:.1f} ms"
              f", prefill(512) {sv['prefill512_ms']:.1f} ms, decode step "
              f"({sv['slots']} slots) {sv['decode_step_ms']:.2f} ms, peak "
              f"{sv['peak_mem_gib']:.2f} GiB")
    tr = trained
    print(f"train metrics {TRAIN_ARCH} ({report['card']}): median step "
          f"{tr['median_step_ms']:.1f} ms, {tr['tokens_per_s']:.0f} tok/s, "
          f"MFU {tr['mfu']:.4f}, peak {tr['peak_mem_gib']:.2f} GiB, losses "
          + " ".join(f"{x:.4f}" for x in tr["losses"]))
    st = ssm_trained
    print(f"train metrics {SSM_TRAIN_ARCH} ({st['n_layers']} layers, "
          f"{report['card']}): median step {st['median_step_ms']:.1f} ms, "
          f"{st['tokens_per_s']:.0f} tok/s, MFU {st['mfu']:.4f}, peak "
          f"{st['peak_mem_gib']:.2f} GiB, losses "
          + " ".join(f"{x:.4f}" for x in st["losses"]))
    for name in ("remat_true", "selective", "mixed"):
        r = tr[name]
        print(f"train metrics {TRAIN_ARCH} {name} ({report['card']}): "
              f"median step {r['median_step_ms']:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tok/s, MFU {r['mfu']:.4f}, peak "
              f"{r['peak_mem_gib']:.2f} GiB, losses "
              + " ".join(f"{x:.4f}" for x in r["losses"]))
    for name in ("zdp", "mixed"):
        r, u = shard[name]["sharded"], shard[name]["one_device"]
        print(f"train metrics {TRAIN_ARCH} sharded {name} (world 1, NCCL, "
              f"{report['card']}): median step {r['median_step_ms']:.1f} ms "
              f"(one device {u['median_step_ms']:.1f}, phase 6 "
              f"{tr['median_step_ms']:.1f}), peak {r['peak_mem_gib']:.3f} "
              f"GiB (one device {u['peak_mem_gib']:.3f}, phase 6 "
              f"{tr['peak_mem_gib']:.3f}), losses "
              + " ".join(f"{x:.4f}" for x in r["losses"]))
    print(f"calibrate metrics ({report['card']}): measured fraction of "
          f"{PEAK_BF16:g} by square size " + ", ".join(
              f"{n} {r['fraction']:.4g}" for n, r in
              zip(CALIBRATE_LADDER, calib["matmul"]))
          + f"; remat factor {calib['remat_factor']:.4f} (model "
          f"{calib['model_remat_ratio']:.4f})")
    ck = tr["checkpoint"]
    print(f"checkpoint metrics {TRAIN_ARCH} ({ck['n_layers']} layers, "
          f"{report['card']}): {ck['mb_written']:.1f} MB a step, save "
          f"{min(ck['save_s']):.2f}-{max(ck['save_s']):.2f} s, restore "
          f"{min(ck['restore_s']):.2f}-{max(ck['restore_s']):.2f} s, resume "
          f"bit-identical")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
