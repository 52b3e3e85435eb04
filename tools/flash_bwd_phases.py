#!/usr/bin/env python3
"""Where the `flash_attention` backward spends its time, on one GPU.

    python3 tools/flash_bwd_phases.py [--source FILE] [--shape B S KV G HD]

There is no `ncu` where the card runs, so this splits the backward's
time by variant builds.  It compiles `--source` (by default
`src/repro_torch/csrc/flash_attention.cu`) several times into libraries
of its own under `build/flash_bwd_phases/`, each with a few macros that
turn one part of the backward into nothing, and times one causal bf16
backward call of each at `--shape` (default qwen1.5-0.5b's training
shape, (8, 4096, 16, 1, 64)) by CUDA-graph replay (20 calls, median of
5 replays):

  full          the kernel as it is;
  no_products   every tensor-core product issued as nothing (its
                accumulators fenced, so the code around it stays);
  no_exp_mask   exp2 the identity and every per-element mask true;
  no_copies     no tile copied from device memory (the shared-memory
                tiles hold whatever they held);
  no_dq_order   (the key-major design) no wait for the preceding key
                tile before the ordered dq add, so the adds race;
  no_dq_add     (the key-major design) no dq add at all.

For the key-major design it also builds the three orders the kernel
does not take, by macros that replace its ticket decode (`bwd_item`)
and its dq rank (`dq_rank`), and times each beside `full` (dq order
decreasing in the key tile, tickets by head), causal and not, the
outputs of each against `full`'s:

  by_key_tile             tickets by key tile: the highest key tile of
                          every head first;
  increasing              dq order increasing in the key tile, a head's
                          key tiles together, the lowest first;
  increasing_by_key_tile  both.

A variant's time subtracted from `full` is what that part costs where
the others cannot hide it; the parts overlap, so the differences do not
add up to the whole.  The outputs of a variant are garbage and are not
read.  The per-kernel device time of `full` comes from the profiler.

The macros go where the source says variants are built: after
`#include "hopper.cuh"` in the three-kernel backward that the key-major
design replaced (its source is the parent commit's, e.g. from `git
show 2d1078f:src/repro_torch/csrc/flash_attention.cu`), at the marker
line before the kernel in the key-major design.
"""
import argparse
import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _lib                    # noqa: E402
from repro_torch.kernels import flash_attention as fa   # noqa: E402

MARKER = "// flash_bwd_phases: variant macros go here"
VARIANTS = {
    "three_kernels": {
        "full": [],
        "no_products": ['#define mma_bf16(d, ...) asm volatile("" : "+f"(d[0]), '
                        '"+f"(d[1]), "+f"(d[2]), "+f"(d[3]))'],
        "no_exp_mask": ["#define exp2f(x) (x)",
                        "#define always_visible(...) true"],
        "no_copies": ["#define cp_async16(...) ((void)0)"],
    },
    "key_major": {
        "full": [],
        "no_products": ["#define mma_s(d, ...) fence_regs(d)",
                        "#define mma_rs(d, ...) fence_regs(d)",
                        "#define mma_dq(d, ...) fence_regs(d)"],
        "no_exp_mask": ["#define ex2(x) (x)",
                        "#define bwd_visible(...) true"],
        "no_copies": ["#define tma_load_4d(...) ((void)0)",
                      "#define tma_load_5d(...) ((void)0)",
                      "#define bulk_load(...) ((void)0)",
                      "#define mbar_arrive_expect_tx(b, n) mbar_arrive(b)"],
        "no_dq_order": ["#define dq_wait(...) ((void)0)"],
        "no_dq_add": ["#define dq_wait(...) ((void)0)",
                      "#define dq_add(...) ((void)0)"],
    },
}
INCREASING = "#define dq_rank(kt, lo, hi) ((kt) - (lo))"
ORDERS = {       # the key-major design's orders, against `full`
    "by_key_tile": ["#define bwd_item(t, n_kt, BH) "
                    "make_int2((t) % (BH), (n_kt) - 1 - (t) / (BH))"],
    "increasing": ["#define bwd_item(t, n_kt, BH) "
                   "make_int2((t) / (n_kt), (t) % (n_kt))", INCREASING],
    "increasing_by_key_tile": ["#define bwd_item(t, n_kt, BH) "
                               "make_int2((t) % (BH), (t) / (BH))",
                               INCREASING],
}


def design_of(text: str) -> str:
    return "three_kernels" if "flash_bwd_dkdv_kernel" in text \
        else "key_major"


def variant_source(text: str, design: str, macros: list) -> str:
    lines = "\n".join(macros) + "\n"
    for m in macros:     # a qualified call would not meet the macro
        name = m.split()[1].split("(")[0]
        text = text.replace(f"hopper::{name}(", f"{name}(")
    if design == "three_kernels":
        if any("always_visible" in m for m in macros):
            # the per-element mask's call sites, not its definition
            text = re.sub(r"(?<!bool )\bvisible\(", "always_visible(",
                          text)
        anchor = '#include "hopper.cuh"\n'
        if anchor not in text:
            raise SystemExit("no hopper.cuh include to put macros after")
        return text.replace(anchor, anchor + lines, 1)
    if MARKER not in text:
        raise SystemExit(f"no line '{MARKER}' in the source")
    return text.replace(MARKER, MARKER + "\n" + lines, 1)


def build_all(src: Path, design: str) -> dict:
    """Compile every variant of `design` (and the key-major design's
    orders) in parallel; name -> CDLL."""
    text = src.read_text()
    out = ROOT / "build" / "flash_bwd_phases"
    procs = {}
    variants = dict(VARIANTS[design], **(ORDERS if design == "key_major"
                                         else {}))
    for name, macros in variants.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        cu = d / "flash_attention.cu"
        cu.write_text(variant_source(text, design, macros))
        so = d / "libflash_bwd.so"
        procs[name] = (so, subprocess.Popen(
            [_lib._nvcc(), *_lib.FLAGS, "-shared", "-I",
             str(ROOT / "src/repro_torch/csrc"), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        if name == "full":
            print("\n".join(ln for ln in log.splitlines()
                            if "bwd" in ln or "spill" in ln
                            or "registers" in ln))
        libs[name] = ctypes.CDLL(str(so))
    return libs


def caller(lib, design: str, causal: bool = True):
    """fn(q, k, v, o, lse, do) -> (dq, dk, dv) through `lib`."""
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if design == "three_kernels":
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 9 + [
            ctypes.c_float, p]
        lib.flash_attention_bwd.restype = i

        def run(q, k, v, o, lse, do):
            B, S, KV, G, hd = q.shape
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            dsum = torch.empty(B, S, KV, G, device="cuda")
            rc = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), dsum.data_ptr(), B, S, k.shape[1], KV, G, hd,
                int(causal), 0, 0, 1.0 / math.sqrt(hd), stream())
            if rc:
                raise SystemExit(f"CUDA error {rc}")
            return dq, dk, dv
        return run
    lib.flash_attention_bwd.argtypes = [p] * 12 + [i] * 9 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), p]
    lib.flash_attention_bwd.restype = i

    def run(q, k, v, o, lse, do):
        # as the wrapper `fa.flash_attention_bwd` launches it
        B, S, KV, G, hd = q.shape
        T = k.shape[1]
        plan = fa.plan_launch(B, S, T, KV, G, hd, causal)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        rowv = torch.empty(plan.row_floats, device="cuda")
        acc = torch.empty(plan.acc_floats, device="cuda")
        counters = torch.zeros(plan.counter_ints, dtype=torch.int32,
                               device="cuda")
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), rowv.data_ptr(), acc.data_ptr(),
            counters.data_ptr(), B, S, T, KV, G, hd, int(causal), 0, 0,
            1.0 / math.sqrt(hd), plan.c_plan, stream())
        if rc:
            raise SystemExit(f"CUDA error {rc}")
        return dq, dk, dv
    return run


def forward(lib, q, k, v, causal=True):
    """(o, lse) of the bf16 forward, through `lib`'s entry."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 9 + [
        ctypes.c_float, i, p]
    lib.flash_attention_fwd.restype = i
    B, S, KV, G, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, S, KV, G, device="cuda")
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, S, k.shape[1], KV, G, hd, int(causal), 0, 0,
        1.0 / math.sqrt(hd), 1, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f"forward: CUDA error {rc}")
    return o, lse


def graph_ms(fn, calls=20, reps=5) -> float:
    """Device ms of one `fn()` by CUDA-graph replay, median of reps."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        graph.replay()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / calls)
    return float(np.median(times))


def kernel_split(fn, calls=10) -> dict:
    """Device ms a call of each kernel `fn` launches (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and "flash" in ev.key:
            name = re.sub(r"^.*?(flash_\w+).*$", r"\1", ev.key)
            out[name] = out.get(name, 0.0) + \
                ev.self_device_time_total / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "src/repro_torch/csrc/flash_attention.cu")
    ap.add_argument("--shape", type=int, nargs=5,
                    default=[8, 4096, 16, 1, 64],
                    metavar=("B", "S", "KV", "G", "HD"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    design = design_of(args.source.read_text())
    print(f"{card}; {design} backward from {args.source}")
    libs = build_all(args.source, design)
    B, S, KV, G, hd = args.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").bfloat16()
    q, do = r(B, S, KV, G, hd), r(B, S, KV, G, hd)
    k, v = r(B, S, KV, hd), r(B, S, KV, hd)
    o, lse = forward(libs["full"], q, k, v)
    args_ = (q, k, v, o, lse, do)
    runs = {name: caller(libs[name], design) for name in VARIANTS[design]}
    full = runs["full"]
    got = full(*args_)
    torch.cuda.synchronize()
    if not all(torch.isfinite(t.float()).all() for t in got):
        raise SystemExit("full: non-finite gradients")
    split = kernel_split(lambda: full(*args_))
    print(f"shape {tuple(args.shape)} causal; full, by kernel (profiler): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
    base = None
    for name, fn in runs.items():
        ms = graph_ms(lambda: fn(*args_))
        base = ms if base is None else base
        print(f"  {name:12s} {ms:.4f} ms  (full - this {base - ms:+.4f} "
              f"ms, {100 * (base - ms) / base:+.1f}%)")
    if design == "key_major":
        o_nc, lse_nc = forward(libs["full"], q, k, v, causal=False)
        for causal, a in ((True, args_), (False, (q, k, v, o_nc, lse_nc,
                                                  do))):
            want = caller(libs["full"], design, causal)(*a)
            for name in ("full", *ORDERS):
                fn = caller(libs[name], design, causal)
                diff = max((x.float() - y.float()).abs().max().item()
                           for x, y in zip(fn(*a), want))
                print(f"  {'causal' if causal else 'non-causal'}: order "
                      f"{name:22s} {graph_ms(lambda: fn(*a)):.4f} ms (max "
                      f"difference from full's outputs {diff:.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
