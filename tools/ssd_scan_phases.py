#!/usr/bin/env python3
"""Where a block of the `ssd_scan` kernels spends its time, on one GPU,
and the chunk scan's head group swept.

    python3 tools/ssd_scan_phases.py

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
"""
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


def build() -> ctypes.CDLL:
    out = ROOT / "build" / "ssd_scan_phases"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libssd_scan_phases.so"
    csrc = ROOT / "src/repro_torch/csrc"
    r = subprocess.run([_lib._nvcc(), "-O3", "-std=c++17", _lib.ARCH,
                        "-DSSD_TRACE", "-Xcompiler", "-fPIC", "-shared",
                        "-I", str(csrc), "-o", str(so),
                        str(csrc / "ssd_scan.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_bf16.argtypes = [p] * 8 + [i] * 6 + [ll] * 6 + [
        ctypes.POINTER(ll), p, ll, p]
    lib.ssd_trace_read.argtypes = [p, i]
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
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    traced = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, nh in ((1, 512, 80), (1, 512, 8), (8, 512, 80)):
        phases(traced, gen, B, S, nh)
    sweep(_lib.lib(), gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
