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
   cost); then the kernels' other options (f32, ragged shapes, each
   matmul design at its edge cases, windows, an initial state, hymba-1.5b's
   SSD shapes...);
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
5. print a {"kernels": [...]} line, the card's name and power limit, the
   serve metrics, and last {"ok": true, "device": {...}}.

Tolerances: 2e-2 absolute + relative for `split_matmul` and
`flash_attention` in bf16 (one bf16 ulp of an O(1) output; the two sides
accumulate in fp32 in different orders).  `ssd_scan` returns fp32 from
bf16 inputs and both sides compute in fp32, so they differ only by fp32
summation order (measured at most 1.1e-4 of 1 + |y| at the path's
shapes): 1e-3 absolute + relative, 1e-4 with f32 inputs.  For the full
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

ROOT = Path(__file__).resolve().parent
ARCHS = ("phi4-mini-3.8b", "mamba2-2.7b")
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BW = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
KERNEL_TOL = 2e-2
SSD_TOL = 1e-3              # fp32 outputs of bf16 inputs (see above)
SSD_TOL_F32 = 1e-4
SSD_CHUNK_FLOOR = 64        # the plain scan's other chunk (noise floor)
SHALLOW = 4                 # layers of the second, shallow logit check
LOGIT_TOL = 2e-2            # of the largest logit, the least tolerance
LOGIT_FLOOR_FACTOR = 4      # x the plain version's own reordering noise
SOURCES = {
    "split_matmul": ("src/repro_torch/csrc/split_matmul.cu",
                     "src/repro/kernels/split_matmul.py:39"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:80"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
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
    from repro_torch.kernels import ref
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
    plain_ms = _time_ms(torch, ref.split_matmul_ref, args, iters=5)
    lib_ms = _graph_ms(torch, torch.matmul, args)
    flops = 2.0 * M * N * K
    nbytes = 2.0 * (M * K + K * N + M * N)
    return dict(shape=[M, K, N], max_abs_err=err.max().item(), ms=ms,
                eager_ms=eager_ms, variant=plan.variant, bn=plan.bn,
                splits=plan.splits, blocks=plan.blocks,
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

    ms = _graph_ms(torch, kern, [(q, k, v)])
    eager_ms = _time_ms(torch, kern, [(q, k, v)])
    plain_ms = _time_ms(torch, plain, [(q, k, v)], iters=5)
    lib_ms = _graph_ms(torch, sdpa, [(qh, kh, vh)])
    H = KV * G
    flops = 4.0 * hd * H * S * (S + 1) / 2      # causal: s+1 keys per row
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    return dict(shape=[1, S, KV, G, hd], max_abs_err=err.max().item(),
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
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
    plain_ms = _time_ms(torch, plain, [args], iters=5)
    # the least work of this call: c.b once per (batch, chunk), the rest
    # per head; the masked half of each chunk's square is not counted
    Q = min(chunk, S)
    tri = sum(n * (n + 1) / 2 for n in
              [Q] * (S // Q) + ([S % Q] if S % Q else []))
    flops = 2.0 * B * (tri * ns + nh * (tri * hd + 2 * S * hd * ns))
    nbytes = (2.0 * (B * S * nh * hd + 2 * B * S * ns)     # bf16 x, b, c
              + 4.0 * (B * S * nh + nh)                     # fp32 dt, a_log
              + 4.0 * (B * S * nh * hd + B * nh * hd * ns))  # fp32 y, state
    return dict(shape=[B, S, nh, hd, ns, chunk], max_abs_err=err,
                max_scaled_err=scaled, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, library_ms=None,
                bound_ms=1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BW),
                bound_by="operations" if flops / PEAK_BF16
                > nbytes / PEAK_BW else "bytes",
                flops=flops, bytes=nbytes)


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
    # B = 2, and hymba-1.5b's heads (64 of 50, state 16)
    from repro_torch.kernels import ssd_scan as sk
    for B, S, nh, hd, ns, chunk, dtype, init in (
            (2, 77, 8, 32, 16, 32, torch.float32, True),
            (1, 20, 8, 32, 16, 32, torch.float32, False),
            (2, 300, 80, 64, 128, 256, torch.bfloat16, True),
            (1, 100, 80, 64, 128, 256, torch.bfloat16, False),
            (1, 333, 64, 50, 16, 256, torch.bfloat16, False),
            (2, 512, 64, 50, 16, 256, torch.float32, True)):
        args, s0 = _ssd_inputs(torch, gen, B, S, nh, hd, ns, dtype, init)
        got = sk.ssd_scan(*args, chunk=chunk, init_state=s0)
        want = ref.ssd_scan_ref(*args, chunk=chunk, init_state=s0)
        _ssd_err(torch, got, want,
                 SSD_TOL_F32 if dtype == torch.float32 else SSD_TOL,
                 f"{(B, S, nh, hd, ns, chunk)} {dtype} init={init}")
        n += 1
    return n


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
    return len(MATMUL_DESIGN_CASES)


@contextlib.contextmanager
def plain_versions(bk=512, ssd_chunk=None):
    """Route the model's kernel calls to the plain versions on the card
    (for the full-model comparison only; the port itself never does).
    `bk` sets the plain matmul's K slice (None: one fp32 product),
    `ssd_chunk` the plain scan's chunk (None: the model's)."""
    from repro_torch.kernels import ops, ref
    saved = ops.split_matmul, ops.flash_attention, ops.ssd_scan
    ops.split_matmul = lambda x, w, **_: ref.split_matmul_ref(x, w, bk=bk)
    ops.flash_attention = lambda q, k, v, **kw: ref.flash_attention_ref(
        q, k, v, **kw)
    ops.ssd_scan = lambda *a, chunk, init_state=None: ref.ssd_scan_ref(
        *a, chunk=ssd_chunk or chunk, init_state=init_state)
    try:
        yield
    finally:
        ops.split_matmul, ops.flash_attention, ops.ssd_scan = saved


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
    want = {"split_matmul": per_pass * passes,
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
                      else "")
            print(f"  {name:15s} {str(r['shape']):26s}{design} err {err} "
                  f"(tol {tol}) kernel {r['ms']:.4f} ms (eager "
                  f"{r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
    report["split_matmul"] = {ARCHS[0]: mm, ARCHS[1]: mm_mam}
    report["flash_attention"] = fl
    report["ssd_scan"] = ssd
    n_opt = check_options(torch, gen)
    print(f"  options: {n_opt} cases off the serve paths (f32, ragged, "
          f"each matmul design at M 1..65, K slices and splits, N against "
          f"a 128 tile, hd 64, G 1 and 4, windows, offsets, non-causal, "
          f"scan init states, hymba's scan shapes) agree with the plain "
          f"versions")
    torch.cuda.empty_cache()

    # 3-4. serve each model, then its whole-model logits ----------------------
    serves = {}
    for arch in ARCHS:
        serves[arch] = serve_phase(torch, np, arch, args)
        torch.cuda.empty_cache()
    report["serve"] = serves

    # 5. report ---------------------------------------------------------------
    def launches(name):
        return sum(s["launches"][name] for s in serves.values())

    def entry(name, r):
        src, replaces = SOURCES[name]
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches(name),
                    launches_by_path={a: s["launches"][name]
                                      for a, s in serves.items()},
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    shape=r["shape"], eager_ms=r["eager_ms"],
                    **{k: r[k] for k in ("variant", "bn", "splits")
                       if k in r})

    # representative shapes: the decode head product, the full prompt
    kernels = [entry("split_matmul", mm[-1]),
               entry("flash_attention", fl[-1]),
               entry("ssd_scan", ssd[1])]
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
