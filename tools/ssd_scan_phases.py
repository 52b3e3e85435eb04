#!/usr/bin/env python3
"""Where a block of the `ssd_scan` kernels spends its time, on one GPU,
and the chunk scan's head group swept.

    python3 tools/ssd_scan_phases.py [--backward] [--source FILE]

`--backward` traces only the backward's chunk-term kernels; `--source`
builds another copy of `ssd_scan.cu` (with `hopper.cuh` beside it).

There is no `ncu` where the card runs, so this builds
`src/repro_torch/csrc/ssd_scan.cu` with -DSSD_TRACE into a library of its
own: thread 0 of every block of the states pass (pass 1) and the
chunk-scan pass (pass 3) then writes `%globaltimer` at the boundaries of
its phases into a device array.  It runs one bf16 call at mamba2-2.7b's
heads (64 wide, state 128, chunk 256) at (1, 512, 80), (1, 512, 8) and
(8, 512, 80), and prints, per pass, the kernel's span, the spread of
block start times, the median and largest time between each pair of
stamps, and the block durations.  Then it times the untraced kernels
with the chunk scan's head group at 1 and 2 (CUDA-graph replay of 20
calls, median of 5) at (1, 333), (1, 512) and (8, 512).

Stamps of pass 1: 0 start, 1 dt gathered, 2 csum and w written, then
for each 64-row tile t: 3 + 2t its copies waited for, 4 + 2t x w cut
into bf16 terms (the products of tile t follow), 20 before the store.
Stamps of pass 3: 0 start, 1 prologue copies in, 2 carried term done,
then for each column tile J: 3 + 2J its copies waited for, 4 + 2J the
next tile's copies issued (G and the products of tile J follow), 30
before the store.  The traced library lives in build/ssd_scan_phases/.

The backward's chunk-term kernels (`ssd_scan_bwd` at mamba2-2.7b's
training shape (8, 4096, 80) and at (1, 333, 80), bf16) instead add up,
for each block, thread 0's time between laps into categories: waiting
for tiles, products (with their element-wise work), stores; and count
its work items (heads or items).  For each kernel this prints the span,
the spread of block start and end times, and the median and largest of
each category's block sum, then the call's time by CUDA-graph replay.
"""
import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _lib                    # noqa: E402
from repro_torch.kernels import ssd_scan as sk          # noqa: E402

HD, NS, CHUNK = 64, 128, 256


def build(source: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "ssd_scan_phases"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libssd_scan_phases.so"
    r = subprocess.run([_lib._nvcc(), "-O3", "-std=c++17", _lib.ARCH,
                        "-DSSD_TRACE", "-Xcompiler", "-fPIC", "-shared",
                        "-I", str(source.parent), "-o", str(so),
                        str(source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bf16.argtypes = [p] * 8 + [i] * 6 + [ll] * 6 + [
        ctypes.POINTER(ll), p, ll, p]
    lib.ssd_scan_bwd_bf16.argtypes = [p] * 13 + [i] * 6 + [ll] * 6 + [
        ctypes.POINTER(ll), p, ll, p]
    lib.ssd_trace_read.argtypes = [p, i]
    lib.ssd_btrace_read.argtypes = [p, i]
    return lib


def inputs(gen, B, S, nh):
    """bf16 x, b, c as slices of one conv row, as the model passes them."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    conv = (r(B, S, nh * HD + 2 * NS) * 0.5).bfloat16()
    x = conv[..., :nh * HD].reshape(B, S, nh, HD)
    b, c = conv[..., nh * HD:nh * HD + NS], conv[..., nh * HD + NS:]
    dt = torch.nn.functional.softplus(r(B, S, nh) - 1.0)
    a_log = torch.rand(nh, generator=gen, device="cuda") * math.log(16.0)
    return x, dt, a_log, b, c


def call(lib, plan, x, dt, a_log, b, c):
    """One `ssd_scan` call through the C entry with `plan`."""
    B, S, nh, hd = x.shape
    y = torch.empty(B, S, nh, hd, device="cuda")
    fin = torch.empty(B, nh, hd, NS, device="cuda")
    ws = torch.empty(sum(plan.workspace), device="cuda")
    rc = lib.ssd_scan_bf16(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), None, y.data_ptr(), fin.data_ptr(), B, S, nh, hd, NS,
        CHUNK, x.stride(0), x.stride(1), b.stride(0), b.stride(1),
        c.stride(0), c.stride(1), plan.c_plan, ws.data_ptr(),
        plan.workspace_bytes, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"ssd_scan: CUDA error {rc}")
    return y, fin


def phases(lib, gen, B, S, nh):
    args = inputs(gen, B, S, nh)
    plan = sk.plan_launch(B, S, nh, HD, NS, CHUNK)
    for _ in range(3):                  # the last call is the one read
        lib.ssd_trace_clear()
        call(lib, plan, *args)
        torch.cuda.synchronize()
    for k, name, grid in ((0, "states", plan.grids[0]),
                          (1, "chunk", plan.grids[2])):
        buf = np.zeros(1 << 18, dtype=np.uint64)
        lib.ssd_trace_read(buf.ctypes.data, k)
        nb = grid[0] * grid[1] * grid[2]
        t = buf[:nb * 32].reshape(nb, 32).astype(np.int64)
        t = t[t[:, 0] > 0]
        t0 = t[:, 0].min()
        print(f"== {name} {(B, S, nh)}: {len(t)} of {nb} blocks stamped; "
              f"kernel span {(t.max() - t0) / 1e3:.2f} us")
        starts = (t[:, 0] - t0) / 1e3
        print(f"   block start: median {np.median(starts):.2f} max "
              f"{starts.max():.2f} us")
        cols = [j for j in range(32) if (t[:, j] > 0).any()]
        for a, b_ in zip(cols, cols[1:]):
            m = (t[:, a] > 0) & (t[:, b_] > 0)
            d = (t[m, b_] - t[m, a]) / 1e3
            if len(d):
                print(f"   {a:2d} -> {b_:2d}: {len(d):5d} blocks, median "
                      f"{np.median(d):6.2f} max {d.max():6.2f} us")
        dur = [(row[row > 0].max() - row[row > 0].min()) / 1e3 for row in t]
        print(f"   block duration: median {np.median(dur):.2f} max "
              f"{max(dur):.2f} us")


def call_bwd(lib, plan, x, dt, a_log, b, c, dy):
    """One `ssd_scan_bwd` call through the C entry with `plan`."""
    B, S, nh, hd = x.shape
    outs = (torch.empty_like(x), torch.empty(B, S, nh, device="cuda"),
            torch.empty(nh, device="cuda"), torch.empty_like(b),
            torch.empty_like(c))
    ws = torch.empty(plan.workspace_bytes // 4, device="cuda")
    rc = lib.ssd_scan_bwd_bf16(
        x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
        c.data_ptr(), None, dy.data_ptr(), None,
        *(t.data_ptr() for t in outs), B, S, nh, hd, NS, CHUNK,
        x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0),
        c.stride(1), plan.c_plan, ws.data_ptr(), plan.workspace_bytes,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"ssd_scan_bwd: CUDA error {rc}")
    return outs


def bwd_phases(lib, gen, B, S, nh=80):
    """The block sums of the backward's chunk-term kernels at (B, S)."""
    args = inputs(gen, B, S, nh)
    dy = torch.randn(B, S, nh, HD, generator=gen, device="cuda")
    plan = sk.plan_bwd(B, S, nh, HD, NS, CHUNK)
    for _ in range(2):                  # the last call is the one read
        lib.ssd_trace_clear()
        call_bwd(lib, plan, *args, dy)
        torch.cuda.synchronize()
    for k in range(3):
        buf = np.zeros(8192 * 8, dtype=np.uint64)
        lib.ssd_btrace_read(buf.ctypes.data, k)
        t = buf.reshape(8192, 8).astype(np.int64)
        t = t[t[:, 0] > 0]
        if not len(t):
            continue
        t0, t1 = t[:, 0].min(), t[:, 1].max()
        starts, ends = (t[:, 0] - t0) / 1e3, (t[:, 1] - t0) / 1e3
        busy = (t[:, 1] - t[:, 0]) / 1e3
        print(f"== bwd chunk-term kernel {k} {(B, S, nh)}: {len(t)} blocks; "
              f"span {(t1 - t0) / 1e3:.1f} us; block start median "
              f"{np.median(starts):.1f} max {starts.max():.1f} us; block end "
              f"min {ends.min():.1f} median {np.median(ends):.1f} max "
              f"{ends.max():.1f} us")
        for s_, name in ((2, "waits for tiles"), (3, "products"),
                         (4, "stores")):
            v = t[:, s_] / 1e3
            print(f"   {name:16s} a block: median {np.median(v):9.1f} max "
                  f"{v.max():9.1f} us; {v.sum() / busy.sum():.3f} of block "
                  f"time")
        print(f"   block time: median {np.median(busy):.1f} max "
              f"{busy.max():.1f} us; items a block: median "
              f"{np.median(t[:, 5]):.0f} max {t[:, 5].max()}")
    ms = graph_ms(lambda: call_bwd(lib, plan, *args, dy), calls=3, reps=3)
    print(f"== ssd_scan_bwd {(B, S, nh)} traced build: {ms:.4f} ms a call")


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


def sweep(lib, gen):
    for B, S in ((1, 333), (1, 512), (8, 512)):
        args = inputs(gen, B, S, 80)
        ys = []
        row = []
        for hg in (1, 2):
            plan = sk._plan(B, S, 80, HD, NS, CHUNK, "bfloat16", hg)
            ys.append(call(lib, plan, *args))
            row.append(f"hg {hg} "
                       f"{graph_ms(lambda: call(lib, plan, *args)):.4f} ms")
        same = all(torch.equal(u, v) for u, v in zip(*ys))
        print(f"== head group {(B, S, 80)}: " + ", ".join(row)
              + f"; outputs {'equal' if same else 'DIFFER'}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backward", action="store_true",
                    help="trace only the backward's chunk-term kernels")
    ap.add_argument("--source", type=Path,
                    default=ROOT / "src/repro_torch/csrc/ssd_scan.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    traced = build(args.source)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S in ((8, 4096), (1, 333)):
        bwd_phases(traced, gen, B, S)
    if args.backward:
        return 0
    for B, S, nh in ((1, 512, 80), (1, 512, 8), (8, 512, 80)):
        phases(traced, gen, B, S, nh)
    sweep(_lib.lib(), gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
