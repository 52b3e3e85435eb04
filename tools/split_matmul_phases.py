#!/usr/bin/env python3
"""Where `split_matmul`'s wgmma kernel spends its time, on one GPU.

    python3 tools/split_matmul_phases.py [--source FILE] [--shapes NAME ...]

`ncu` may not run where the card is (the script tries it on one call
of the grid kernel at two shapes and prints what it read), so this
splits the time of the grid kernel (`split_matmul_wgmma_kernel`, C
entry `split_matmul_wgmma_bf16`) by variant builds.  It copies `--source` (by default
`src/repro_torch/csrc/split_matmul.cu`) into libraries of its own under
`build/split_matmul_phases/`, each with a few lines of the copy
replaced, and times one call of each at qwen1.5-0.5b's training shapes
of the accumulating form, of dgrad and of wgrad (and the calibration
chain's) by CUDA-graph replay (20 calls, median of 5 replays), at the
launch plan the grid design takes there:

  full          the kernel as it is (row tiles the grid's fastest axis);
  col_fastest   the grid's axes swapped: the column tiles of a row tile
                are neighbours, so its row operand is read from memory
                about once;
  no_epilogue   no output written (and, for the accumulating form, no
                `acc` read): the consumers return after their last
                k-step;
  products      no epilogue and no tile loaded: the producer arrives on
                each stage's barrier without a copy, so only the wgmma
                products and the ring's handshakes remain.

The grid kernel's accumulating epilogue went once the persistent design
took every accumulating call at these rows, and its "tn" layout once
the persistent design took every wgrad, so the old variants of those
shapes need `--source` to be a copy of the file from before
(`git show e33a49c:src/repro_torch/csrc/split_matmul.cu` for the
accumulating form, `git show 80a3e61:...` for wgrad); with a source
whose grid kernel lacks them they are left out at those shapes.

`full - col_fastest` is what streaming the row operand once per column
tile costs, `full - no_epilogue` what the epilogue costs where nothing
hides it, `no_epilogue - products` what the loads cost.  The parts
overlap, so the differences need not add up.  A variant's outputs are
garbage and are not read.  The source copies and their libraries stay
under `build/`; nothing in the repository's kernels has a switch for
them.

Beside the variants, in the same process and on the same inputs: the
persistent design at each tile width (from the `full` copy; its output
compared with the grid kernel's bit for bit, and a repeat with itself),
and with its producer edited not to load the weight tiles (`p_no_b`) or
any ring tile (`p_no_loads`); the design the wrapper's plan takes now
for each role (`plan_launch` with `role="acc"`, `"dgrad"` or
`"wgrad"`, through the repository's own library); for wgrad, where the
source's persistent kernel takes "tn", every (bn, split-K) candidate
of the persistent design (`--sweep`); and the library calls
(`torch.matmul`, for "tn" `torch.matmul(a.t(), b)`; for
the accumulating form also `torch.addmm(acc, x, w,
out_dtype=torch.float32)` where this torch takes it, and `acc * 2`, the
fp32 read and write of acc's own bytes).
"""
import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _lib                    # noqa: E402
from repro_torch.kernels import split_matmul as sm      # noqa: E402

# (role, M, N, K, layout) of out(M, N) = A(M, K) . B(K, N); d = 1024,
# ff = 2816 split in 4 chunks of 704, 32,768 rows, a CE chunk 4096 rows;
# the calibration's remat chain (64 rows, width 16,384)
SHAPES = {
    "acc_w2_chunk": ("acc", 32768, 1024, 704, "nn"),
    "dgrad_attention": ("dgrad", 32768, 1024, 1024, "nt"),
    "dgrad_w13_chunk": ("dgrad", 32768, 1024, 1408, "nt"),
    "dgrad_w2_chunk": ("dgrad", 32768, 704, 1024, "nt"),
    "dgrad_w13": ("dgrad", 32768, 1024, 5632, "nt"),
    "dgrad_w2": ("dgrad", 32768, 2816, 1024, "nt"),
    "dgrad_head": ("dgrad", 4096, 1024, 152064, "nn"),
    "dgrad_chain": ("dgrad", 64, 16384, 16384, "nt"),
    # wgrad dw = x^T dy, "tn": A is x stored (K, M), contracted over the
    # step's rows; the head's is dy^T x over a CE chunk of 4096 rows
    "wgrad_head": ("wgrad", 152064, 1024, 4096, "tn"),
    "wgrad_chain": ("wgrad", 16384, 16384, 64, "tn"),
    "wgrad_attention": ("wgrad", 1024, 1024, 32768, "tn"),
    "wgrad_w13_chunk": ("wgrad", 1024, 1408, 32768, "tn"),
    "wgrad_w2_chunk": ("wgrad", 704, 1024, 32768, "tn"),
}
ROW_TILES = ("  const int m0 = blockIdx.x * WG_BM;   // row tiles fastest: "
             "the blocks\n  const int n0 = blockIdx.y * BN;      // that "
             "share a weight tile run\n")
GRID = ("  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + BN - 1) / BN, "
        "splits);\n  split_matmul_wgmma_kernel")
EPILOGUE = ("  // accumulator layout: warp w4 of the group holds rows 16 w4 "
            "+ (lane/4)\n")
INCLUDE = '#include "hopper.cuh"\n'
# the grid kernel's C entry as it was while it took the accumulating form
GRID_ACC = re.compile(r"split_matmul_wgmma_bf16\(const void\* x, const void\* w,"
                      r"\s+void\* y,\s+void\* ws, const void\* acc")
# the grid kernel's C entry as it was while it took "tn"
GRID_TN = "launch_wgmma_bn<TN>"
# the persistent kernel's C entry taking "tn"
PERSISTENT_TN = "launch_persistent_bn<TN, "
P_EXPECT = "          mbar_arrive_expect_tx(&full[stage], P::STAGE_BYTES);\n"
# the producer's A load: one line before the persistent design took
# "tn", a helper after
P_A_LOAD = ("          tma_load_2d(a, &tx, &full[stage], k0, m0);\n",
            "          load_a<L>(a, &tx, &full[stage], k0, m0);\n")
P_B_LOOP = "          for (int j = 0; j < BN / 64; ++j) {\n"
VARIANTS = {
    "full": [],
    "col_fastest": [(ROW_TILES, "  const int m0 = blockIdx.y * WG_BM;\n"
                                "  const int n0 = blockIdx.x * BN;\n"),
                    (GRID, "  const dim3 grid((N + BN - 1) / BN, (M + WG_BM"
                           " - 1) / WG_BM, splits);\n  split_matmul_wgmma_"
                           "kernel")],
    "no_epilogue": [(EPILOGUE, "  if (M > 0) return;\n" + EPILOGUE)],
    "products": [(EPILOGUE, "  if (M > 0) return;\n" + EPILOGUE),
                 (INCLUDE, INCLUDE + "#define tma_load_2d(...) ((void)0)\n"
                  "#define mbar_arrive_expect_tx(b, n) mbar_arrive(b)\n")],
    # the persistent design's producer without its B (weight) tiles, and
    # without any ring load (the acc tile still loads)
    "p_no_b": [(P_EXPECT, P_EXPECT.replace("P::STAGE_BYTES", "A_BYTES")),
               (P_B_LOOP, P_B_LOOP.replace("BN / 64", "0"))],
    "p_no_loads": [(tuple(P_EXPECT + a for a in P_A_LOAD),
                    P_EXPECT.replace("P::STAGE_BYTES", "0")),
                   (P_B_LOOP, P_B_LOOP.replace("BN / 64", "0"))],
}
OLD_VARIANTS = ("full", "col_fastest", "no_epilogue", "products")


def variant_source(text: str, edits: list) -> str:
    """`text` with each edit's old lines replaced; an edit's old lines
    may be a tuple of alternatives, of which exactly one is present."""
    for old, new in edits:
        alts = old if isinstance(old, tuple) else (old,)
        found = [a for a in alts if text.count(a)]
        if len(found) != 1 or text.count(found[0]) != 1:
            copies = [text.count(a) for a in alts]
            raise SystemExit(f"the source holds {copies} copies of the "
                             f"lines to replace:\n{alts}")
        text = text.replace(found[0], new)
    return text


def load(so: Path, text: str) -> ctypes.CDLL:
    """The library at `so`, built from the source `text`, its entries
    typed and marked with the roles its kernels take: `grid_acc`, the
    grid entry takes an `acc` pointer (a source from before the
    persistent design took the accumulating form); `grid_tn`, the grid
    kernel takes "tn"; `persistent_tn`, the persistent kernel does."""
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.grid_acc = bool(GRID_ACC.search(text))
    lib.grid_tn = GRID_TN in text
    lib.persistent_tn = PERSISTENT_TN in text
    lib.split_matmul_wgmma_bf16.argtypes = ([p] * (5 if lib.grid_acc else 4)
                                            + [i] * 8 + [p])
    lib.split_matmul_wgmma_bf16.restype = i
    if hasattr(lib, "split_matmul_persistent_bf16"):
        lib.split_matmul_persistent_bf16.argtypes = [p] * 5 + [i] * 10 + [p]
        lib.split_matmul_persistent_bf16.restype = i
    return lib


def build_all(src: Path, persistent_variants: bool) -> dict:
    """Compile every variant in parallel; name -> CDLL.  The persistent
    producer's variants only with `persistent_variants`."""
    text = src.read_text()
    out = ROOT / "build" / "split_matmul_phases"
    persistent = "split_matmul_persistent_kernel" in text
    sources = {name: variant_source(text, edits)     # all edits first
               for name, edits in VARIANTS.items()
               if name in OLD_VARIANTS or (persistent and
                                           persistent_variants)}
    procs = {}
    for name, source in sources.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(src.parent / "hopper.cuh", d / "hopper.cuh")
        cu = d / "split_matmul.cu"
        cu.write_text(source)
        so = d / "libsplit_matmul.so"
        procs[name] = (so, subprocess.Popen(
            [_lib._nvcc(), *_lib.FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = load(so, text)
    return libs


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


def has_grid(lib, role) -> bool:
    """The grid kernel of `lib` takes this role."""
    return {"acc": lib.grid_acc, "wgrad": lib.grid_tn}.get(role, True)


def old_caller(lib, layout, M, N, K, a, b, acc):
    """fn() launching the grid kernel of `lib` as its plan does.  The
    grid's cost model reads the layout only through its K slice, which
    is the same in "nn" at these shapes (512, or all of a K of 64), so
    the "tn" plan the grid took is the "nn" forward's."""
    plan = sm.plan_launch(M, N, K, 512 if acc is not None else sm.BWD_KSLICE,
                          layout="nn" if layout == "tn" else layout)
    y = torch.empty(M, N, device="cuda",
                    dtype=torch.float32 if acc is not None else a.dtype)
    ws = (torch.empty(plan.workspace, device="cuda")
          if plan.workspace else None)

    ptrs = [a.data_ptr(), b.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None]
    if lib.grid_acc:
        ptrs.append(acc.data_ptr() if acc is not None else None)

    def run():
        rc = lib.split_matmul_wgmma_bf16(
            *ptrs, sm.LAYOUTS[layout], M, N, K, plan.kslice, plan.bn,
            plan.splits,
            plan.slices_per_split, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"CUDA error {rc}")
        return y
    return run, plan


def persistent_caller(lib, layout, M, N, K, a, b, acc, bn, n_sm, want=1):
    """fn() launching the persistent design of `lib` at tile width `bn`
    and about `want` splits of whole K slices (`sm._splits`), its blocks
    and group as `plan_launch` sets them; returns (fn, (blocks, group,
    splits))."""
    kslice = 512 if acc is not None else sm.BWD_KSLICE
    kslice = (min(kslice, K) if layout == "nn"
              else 64 * math.ceil(min(kslice, K) / 64))
    splits, sps = sm._splits(math.ceil(K / kslice), want)
    tiles_m, tiles_n = math.ceil(M / sm.WGMMA_BM), math.ceil(N / bn)
    blocks = min(n_sm, tiles_m * tiles_n * splits)
    group = max(1, min(tiles_m, blocks // tiles_n))
    y = torch.empty(M, N, device="cuda",
                    dtype=torch.float32 if acc is not None else a.dtype)
    ws = (torch.empty(splits, M, N, device="cuda") if splits > 1 else None)

    def run():
        rc = lib.split_matmul_persistent_bf16(
            a.data_ptr(), b.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            acc.data_ptr() if acc is not None else None, sm.LAYOUTS[layout],
            M, N, K, kslice, bn, splits, sps, blocks, group,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"CUDA error {rc}")
        return y
    return run, (blocks, group, splits)


def operands(role, M, N, K, layout, gen):
    """The inputs of a shape: A as stored ((K, M) for "tn"), B as stored
    ((N, K) for "nt"), scaled so the output is about 1, and acc."""
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda")
                               * scale).bfloat16()
    a = r(*((K, M) if layout == "tn" else (M, K)))
    b = r(*((N, K) if layout == "nt" else (K, N)), scale=K ** -0.5)
    acc = (torch.randn(M, N, generator=gen, device="cuda")
           if role == "acc" else None)
    return a, b, acc


def ncu_exe():
    exe = shutil.which("ncu")
    cand = Path("/usr/local/cuda/bin/ncu")
    return exe or (str(cand) if cand.is_file() else None)


def ncu_bytes(exe: str, shape: str, src: Path) -> str:
    """DRAM bytes of one old-design call at `shape`, read by `ncu` from a
    child process (`--child`) that loads the `full` variant's library."""
    cmd = [exe, "--metrics", "dram__bytes_read.sum,dram__bytes_write.sum",
           "-k", "regex:split_matmul_wgmma_kernel", "--launch-count", "1",
           sys.executable, str(Path(__file__).resolve()), "--source",
           str(src), "--child", shape]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except subprocess.TimeoutExpired:
        return "ncu: timed out after 300 s"
    lines = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
             if "dram__bytes" in ln or "ERR" in ln or "rror" in ln]
    return "; ".join(lines[:6]) or f"ncu: rc {out.returncode}, no metric"


def child(shape: str, src: Path) -> int:
    lib = load(ROOT / "build/split_matmul_phases/full/libsplit_matmul.so",
               src.read_text())
    role, M, N, K, layout = SHAPES[shape]
    if not has_grid(lib, role):
        return 0
    a, b, acc = operands(role, M, N, K, layout,
                         torch.Generator(device="cuda").manual_seed(0))
    old_caller(lib, layout, M, N, K, a, b, acc)[0]()
    torch.cuda.synchronize()
    return 0


def library_call(layout, a, b):
    """fn() of the library's product for the shape, bf16 out."""
    if layout == "tn":
        return lambda: torch.matmul(a.t(), b)
    bt = b.t() if layout == "nt" else b
    return lambda: torch.matmul(a, bt)


def versus_text(y, old) -> str:
    if old is None:
        return "no grid result to compare"
    if torch.equal(y, old):
        return "bit-identical to full"
    return f"max diff {(y.float() - old.float()).abs().max().item():.3g} " \
           f"from full"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path,
                    default=ROOT / "src/repro_torch/csrc/split_matmul.cu")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--sweep", action="store_true",
                    help="wgrad: time every (bn, split-K) candidate of the "
                         "persistent design")
    ap.add_argument("--child", choices=list(SHAPES), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.source)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; variants of {args.source}")
    text = args.source.read_text()
    libs = build_all(args.source, any(
        SHAPES[n][0] != "wgrad" or PERSISTENT_TN in text
        for n in args.shapes))
    exe = ncu_exe()
    if not exe:
        print("ncu: not on this machine; DRAM bytes not measured")
    else:
        for shape in args.shapes[:2]:
            print(f"ncu {shape}: {ncu_bytes(exe, shape, args.source)}",
                  flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    full = libs["full"]
    for name in args.shapes:
        role, M, N, K, layout = SHAPES[name]
        a, b, acc = operands(role, M, N, K, layout, gen)
        grid = has_grid(full, role)
        lib_ms = graph_ms(library_call(layout, a, b))
        line = f"{name} {role} {layout} (M {M}, N {N}, K {K}) "
        if grid:
            times = {}
            for vname in OLD_VARIANTS:
                fn, plan = old_caller(libs[vname], layout, M, N, K, a, b,
                                      acc)
                times[vname] = graph_ms(fn)
            line += (f"old plan bn {plan.bn} x {plan.splits} splits, "
                     f"{plan.blocks} blocks: "
                     + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
                     + f" ms; full - col_fastest "
                     f"{times['full'] - times['col_fastest']:+.4f}, full - "
                     f"no_epilogue "
                     f"{times['full'] - times['no_epilogue']:+.4f}, "
                     f"no_epilogue - products "
                     f"{times['no_epilogue'] - times['products']:+.4f}")
        else:
            line += f"old variants left out (no grid {role} in the source)"
        line += f"; torch.matmul (bf16 out) {lib_ms:.4f}"
        if acc is not None:
            twice = torch.empty_like(acc)
            line += (f"; acc * 2 (fp32 read + write, the acc's own bytes) "
                     f"{graph_ms(lambda: torch.mul(acc, 2.0, out=twice)):.4f}")
            try:
                addmm = lambda: torch.addmm(acc, a, b,
                                            out_dtype=torch.float32)
                addmm()
                line += f"; torch.addmm fp32 out {graph_ms(addmm):.4f}"
            except (TypeError, RuntimeError) as e:
                line += f"; torch.addmm fp32 out refused ({e})"
        persistent = hasattr(full, "split_matmul_persistent_bf16") and (
            layout != "tn" or full.persistent_tn)
        if persistent:
            old = None
            if grid:
                old = old_caller(full, layout, M, N, K, a, b, acc)[0]()
                torch.cuda.synchronize()
                old = old.clone()
            for bn in (128,) if acc is not None else sm.PERSISTENT_BNS:
                fn, (blocks, group, _) = persistent_caller(
                    full, layout, M, N, K, a, b, acc, bn, n_sm)
                y = fn()
                torch.cuda.synchronize()
                again = torch.equal(y.clone(), fn())
                line += (f"; persistent bn {bn} ({blocks} blocks, group "
                         f"{group}) {graph_ms(fn):.4f} ms "
                         f"({versus_text(y, old)}"
                         f"{'' if again else ', A REPEAT DIFFERS'}; without "
                         + ", ".join(
                             f"{v[2:]} " + f"{graph_ms(persistent_caller(libs[v], layout, M, N, K, a, b, acc, bn, n_sm)[0]):.4f}"
                             for v in ("p_no_b", "p_no_loads")) + ")")
            if role == "wgrad" and args.sweep:
                line += "; sweep (bn x splits: ms)"
                n_slices = math.ceil(K / (64 * math.ceil(
                    min(sm.BWD_KSLICE, K) / 64)))
                for bn in sm.PERSISTENT_BNS:
                    seen = set()
                    for want in range(1, min(n_slices, 16) + 1):
                        fn, (_, _, splits) = persistent_caller(
                            full, layout, M, N, K, a, b, acc, bn, n_sm,
                            want)
                        if splits in seen:
                            continue
                        seen.add(splits)
                        line += f" {bn}x{splits} {graph_ms(fn):.4f}"
        plan = sm.plan_launch(M, N, K, 512 if acc is not None
                              else sm.BWD_KSLICE, layout=layout, role=role)
        if role == "acc":
            now = lambda: sm.split_matmul(a, b, acc=acc)
        else:
            now = lambda: sm._launch(a, b, layout, sm.BWD_KSLICE, role)
        if plan.variant != "wgmma" or layout != "tn":
            line += (f"; now {plan.variant} bn {plan.bn} x {plan.splits} "
                     f"splits, {plan.blocks} blocks, group {plan.group}: "
                     f"{graph_ms(now):.4f}")
        print(line, flush=True)
        del a, b, acc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
