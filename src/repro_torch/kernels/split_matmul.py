"""split_matmul — OSDP operator splitting (paper §3.3) as a CUDA kernel.

The wrapper of `csrc/split_matmul.cu`, which replaces the TPU kernel
`src/repro/kernels/split_matmul.py::split_matmul`.  It takes CUDA
tensors only (the plain version in `ref.py` serves the CPU; `ops`
dispatches) and counts its launches in `launches`: one per call, which
with split-K is the main kernel and its in-order sum of the splits.

`plan_launch`, pure Python, chooses the design for a shape:

- ``"stream"`` (M <= 64, decode rows): split-K weight streaming on
  mma.sync, N tiles of 128/64/32/16 columns times K ranges of whole `bk`
  slices, enough blocks for 2 a SM where the slices allow it;
- ``"wgmma"`` (M > 64, prefill rows): TMA + wgmma, 128-row tiles of
  256/192/128/64 columns and split-K, whichever a cost model fitted on
  the card puts fastest;
- ``"general"``: the first version, only for what the other two cannot
  take (float32; K or N not a multiple of 8; a base pointer not 16-byte
  aligned), with the reason in the plan.

The backward takes the same kernel in two more operand layouts
(`LAYOUTS`), chosen by role:

- `split_matmul_dgrad` (dx = dy w^T; counted in `dgrad_launches`) reads
  w as stored, transposed in the load ("nt"); for a weight the forward
  used transposed (the tied head, y = x emb^T) it is the plain "nn";
- `split_matmul_wgrad` (dw = x^T dy; counted in `wgrad_launches`)
  contracts over the rows ("tn");
- `split_matmul(..., transpose_w=True)` is the tied head's forward in
  "nt", with no transposed copy of the embedding.

The accumulating form `split_matmul(x, w, acc=y)` returns the fp32
`y + x @ w` (counted in `acc_launches`): the forward layout's designs
with an epilogue that adds the product's fp32 sum into the fp32 tile of
`acc` instead of casting it, so a chunked product (`core/operator_split`)
sums its chunks in fp32 as the TPU kernel's K-slice accumulator does.

"nt" and "tn" take the wgmma design at every row count, with K cut at
multiples of 64 (`BWD_KSLICE`, so only the tensor's end is ragged) and
split-K where the tiles leave SMs idle; what it cannot take (float32,
a dimension not a multiple of 8, a misaligned pointer) goes to a
strided CUDA-core kernel (variant "general").
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import _lib

TILE = 64              # the bm/bn the TPU signature passes; checked
STREAM_MAX_M = 64      # decode rows: x^T fills at most 8 mma n-tiles
STREAM_BNS = (128, 64, 32, 16)
WGMMA_BM = 128         # two consumer warpgroups of 64 rows
WGMMA_BNS = (256, 192, 128, 64)
N_SM = 132             # H100 SXM
# rates of plan_launch's cost model for the wgmma design, fitted to a
# sweep of tiles and splits on an H100 (NVIDIA H100 80GB HBM3, 700 W):
# one SM's bf16 rate, the rate at which one SM takes in its x and w
# tiles, device memory for the split-K workspace, and one more launch
SM_FLOPS = 4.6e12      # FLOP/s
SM_TILE_BYTES = 5.5e10  # bytes/s
WS_BYTES = 3e12        # bytes/s
LAUNCH_S = 2e-6        # seconds
LAYOUTS = {"nn": 0, "nt": 1, "tn": 2}   # the C entry's layout codes
BWD_KSLICE = 512       # K unit of the "nt"/"tn" plans, a multiple of 64
launches = 0           # forward launches since the last reset
dgrad_launches = 0     # dx launches
wgrad_launches = 0     # dw launches
acc_launches = 0       # accumulating forward launches (fp32 acc + x @ w)
layout_launches = dict.fromkeys(LAYOUTS, 0)   # every role's, by layout


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one product is launched.  K is cut into `splits` ranges of
    `slices_per_split` whole slices of `kslice`; with splits > 1 the
    fp32 partials go to a `workspace` of that shape and are summed in
    split order."""
    variant: str            # "stream" | "wgmma" | "general"
    bm: int                 # output rows a block
    bn: int                 # output columns a block
    kslice: int             # bk, at most K
    splits: int
    slices_per_split: int
    blocks: int             # blocks of the main kernel
    workspace: Tuple[int, ...]
    reason: str

    def k_ranges(self, K: int) -> List[Tuple[int, int]]:
        span = self.slices_per_split * self.kslice
        return [(s * span, min(K, (s + 1) * span))
                for s in range(self.splits)]


def _splits(n_slices: int, want: int) -> Tuple[int, int]:
    """(splits, slices a split) for about `want` splits, none empty."""
    sps = math.ceil(n_slices / max(1, min(want, n_slices)))
    return math.ceil(n_slices / sps), sps


@functools.lru_cache(maxsize=4096)
def plan_launch(M: int, N: int, K: int, bk: int, *, n_sm: int = N_SM,
                dtype: str = "bfloat16", aligned: bool = True,
                layout: str = "nn") -> LaunchPlan:
    """The design, tile and K split for out(M, N) = A(M, K) . B(K, N)
    with K slices of `bk`, on a card of `n_sm` SMs; `layout` says how A
    and B are stored (`LAYOUTS`)."""
    if layout == "nn":
        kslice = max(1, min(bk, K))
    else:
        kslice = 64 * math.ceil(min(bk, K) / 64)
    n_slices = math.ceil(K / kslice)

    def plan(variant, bm, bn, splits, sps, reason):
        blocks = math.ceil(M / bm) * math.ceil(N / bn) * splits
        ws = (splits, M, N) if splits > 1 else ()
        return LaunchPlan(variant, bm, bn, kslice, splits, sps, blocks, ws,
                          reason)

    general = None
    if dtype != "bfloat16":
        general = f"{dtype} inputs: the fp32 CUDA-core kernel"
    elif K % 8 or N % 8 or (layout != "nn" and M % 8):
        dims_ = f"K={K}, N={N}" + (f", M={M}" if layout != "nn" else "")
        general = (f"{dims_}: not all a multiple of 8; TMA and 16-byte "
                   f"copies need 16-byte row strides")
    elif not aligned:
        general = "a base pointer not 16-byte aligned"
    if general:
        return plan("general", TILE, TILE, 1, n_slices, general)

    if M <= STREAM_MAX_M and layout == "nn":
        bm = 8 * (1 << max(0, math.ceil(math.log2(math.ceil(M / 8)))))
        target = 2 * n_sm
        for bn in STREAM_BNS:
            tiles = math.ceil(N / bn)
            for want in range(1, n_slices + 1):
                splits, sps = _splits(n_slices, want)
                if tiles * splits >= target:
                    return plan("stream", bm, bn, splits, sps,
                                f"{M} rows <= {STREAM_MAX_M}: weight "
                                f"streaming, {tiles * splits} blocks")
        # the whole-slice grid cannot give 2 blocks a SM: take its finest
        bn = STREAM_BNS[-1]
        return plan("stream", bm, bn, n_slices, 1,
                    f"{M} rows <= {STREAM_MAX_M}: weight streaming; "
                    f"{math.ceil(N / bn) * n_slices} blocks, the most "
                    f"{n_slices} slices of {kslice} allow")

    # prefill rows: the least estimated time: waves x one block's steps,
    # each step bound by its products or by taking in its x and w tiles;
    # with split-K, plus the fp32 partials written and read back and the
    # second launch
    best, best_cost = None, math.inf
    tiles_m = math.ceil(M / WGMMA_BM)
    for bn in WGMMA_BNS:
        tiles = tiles_m * math.ceil(N / bn)
        step = max(2.0 * WGMMA_BM * bn * 64 / SM_FLOPS,
                   2.0 * (WGMMA_BM + bn) * 64 / SM_TILE_BYTES)
        for want in range(1, min(n_slices, 16) + 1):
            splits, sps = _splits(n_slices, want)
            steps = math.ceil(min(K, sps * kslice) / 64)
            cost = math.ceil(tiles * splits / n_sm) * steps * step
            if splits > 1:
                cost += 8.0 * splits * M * N / WS_BYTES + LAUNCH_S
            if cost < best_cost:
                best, best_cost = (bn, splits, sps), cost
    bn, splits, sps = best
    return plan("wgmma", WGMMA_BM, bn, splits, sps,
                f"{M} rows > {STREAM_MAX_M}: TMA + wgmma" if layout == "nn"
                else f"layout {layout}: TMA + wgmma")


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dims(a: torch.Tensor, b: torch.Tensor, layout: str) -> Tuple[int, int,
                                                                 int]:
    """(M, N, K) of out(M, N) = A . B with A, B stored as `layout` says:
    "nn" a (M, K), b (K, N); "nt" a (M, K), b (N, K); "tn" a (K, M),
    b (K, N)."""
    if layout == "nn":
        return a.shape[0], b.shape[1], a.shape[1]
    if layout == "nt":
        return a.shape[0], b.shape[0], a.shape[1]
    return a.shape[1], b.shape[1], a.shape[0]


def plan_for(x: torch.Tensor, w: torch.Tensor, bk: int,
             layout: str = "nn") -> LaunchPlan:
    """`plan_launch` for these tensors on their card."""
    M, N, K = dims(x, w, layout)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return plan_launch(M, N, K, bk, n_sm=_n_sm(x.device.index or 0),
                       dtype=str(x.dtype).removeprefix("torch."),
                       aligned=aligned, layout=layout)


def _check(a: torch.Tensor, b: torch.Tensor, layout: str, what: str):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{what} needs CUDA tensors on one device, got "
                         f"{a.device} and {b.device}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} takes bf16 or f32 pairs, got {a.dtype} and "
                        f"{b.dtype}")
    contracted = {"nn": (1, 0), "nt": (1, 1), "tn": (0, 0)}[layout]
    if a.ndim != 2 or b.ndim != 2 or \
            a.shape[contracted[0]] != b.shape[contracted[1]]:
        raise ValueError(f"{what}: bad shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} for layout {layout}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} needs contiguous row-major inputs")


def _launch(a: torch.Tensor, b: torch.Tensor, layout: str, bk: int,
            role: str, acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out(M, N) = A . B (see `dims`) in a's dtype through the plan's
    design, or with `acc` (layout "nn") the fp32 acc + A . B; a launch
    adds one to the count of `role` ("fwd", "dgrad", "wgrad" or "acc")
    and of its layout."""
    global launches, dgrad_launches, wgrad_launches, acc_launches
    M, N, K = dims(a, b, layout)
    y = torch.empty((M, N), dtype=a.dtype if acc is None else torch.float32,
                    device=a.device)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_() if acc is None else y.copy_(acc)
    acc_ptr = acc.data_ptr() if acc is not None else None
    lib = _lib.lib()
    plan = plan_for(a, b, bk, layout)
    stream = _lib.stream_of(a)
    if plan.variant == "general" and layout == "nn":
        fn = (lib.split_matmul_bf16 if a.dtype == torch.bfloat16
              else lib.split_matmul_f32)
        rc = fn(a.data_ptr(), b.data_ptr(), y.data_ptr(), acc_ptr, M, N, K,
                bk, stream)
    elif plan.variant == "general":
        # A(r, k) = a[r sar + k sak], B(k, c) = b[k sbk + c sbc]
        sar, sak = (K, 1) if layout == "nt" else (1, M)
        sbk, sbc = (1, K) if layout == "nt" else (N, 1)
        rc = lib.split_matmul_strided(
            a.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K, sar, sak,
            sbk, sbc, 1 if a.dtype == torch.bfloat16 else 0, stream)
    else:
        ws = (torch.empty(plan.workspace, dtype=torch.float32,
                          device=a.device) if plan.workspace else None)
        args = (a.data_ptr(), b.data_ptr(), y.data_ptr(),
                ws.data_ptr() if ws is not None else None, acc_ptr)
        if plan.variant == "stream":
            rc = lib.split_matmul_stream_bf16(
                *args, M, N, K, plan.kslice, plan.bn, plan.splits,
                plan.slices_per_split, stream)
        else:
            rc = lib.split_matmul_wgmma_bf16(
                *args, LAYOUTS[layout], M, N, K, plan.kslice, plan.bn,
                plan.splits, plan.slices_per_split, stream)
    _lib.check(rc, f"split_matmul ({layout}, {plan.variant})")
    layout_launches[layout] += 1
    if role == "dgrad":
        dgrad_launches += 1
    elif role == "wgrad":
        wgrad_launches += 1
    elif role == "acc":
        acc_launches += 1
    else:
        launches += 1
    return y


def split_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = TILE,
                 bn: int = TILE, bk: int = 512, transpose_w: bool = False,
                 acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) in x.dtype with an fp32 accumulator;
    K runs in slices of `bk` (operator-splitting granularity K/bk).
    Ragged M, N, K are fine.  The tile is the plan's (`plan_launch`), so
    `bm`/`bn` must be 64; they are kept for the TPU kernel's
    signature.  `transpose_w`: w is stored (N, K) and x @ w^T is taken
    ("nt", the tied head), with no copy of w.  `acc`: an fp32 (M, N)
    tensor; the result is then the fp32 acc + x @ w (a new tensor)."""
    layout = "nt" if transpose_w else "nn"
    _check(x, w, layout, "split_matmul")
    if (bm, bn) != (TILE, TILE) or bk < 1:
        raise ValueError(f"blocks (bm={bm}, bn={bn}, bk={bk}): the kernel "
                         f"chooses its own tiles, bm and bn must be {TILE} "
                         f"and bk >= 1")
    if acc is None:
        return _launch(x, w, layout, bk, "fwd")
    M, N, _ = dims(x, w, layout)
    if transpose_w:
        raise ValueError("split_matmul: the accumulating form takes the "
                         "forward layout only (transpose_w=False)")
    if acc.device != x.device or acc.dtype != torch.float32 or \
            tuple(acc.shape) != (M, N) or not acc.is_contiguous() or \
            acc.data_ptr() % 16:
        raise ValueError(f"split_matmul: acc must be a contiguous, 16-byte "
                         f"aligned float32 ({M}, {N}) tensor on {x.device}, "
                         f"got {acc.dtype} {tuple(acc.shape)} on "
                         f"{acc.device}")
    return _launch(x, w, layout, bk, "acc", acc)


def split_matmul_dgrad(dy: torch.Tensor, w: torch.Tensor, *,
                       transpose_w: bool = False,
                       bk: int = BWD_KSLICE) -> torch.Tensor:
    """dx = dy:(M,N) @ w^T for the forward x @ w with w (K, N) -> (M, K)
    in dy.dtype ("nt"); with `transpose_w` the forward was x @ w^T, w
    (N, K), and dx = dy @ w ("nn")."""
    layout = "nn" if transpose_w else "nt"
    _check(dy, w, layout, "split_matmul_dgrad")
    return _launch(dy, w, layout, bk, "dgrad")


def split_matmul_wgrad(x: torch.Tensor, dy: torch.Tensor, *,
                       transpose_w: bool = False,
                       bk: int = BWD_KSLICE) -> torch.Tensor:
    """dw = x:(M,K)^T @ dy:(M,N) -> (K, N) ("tn"), contracted over the M
    rows; with `transpose_w` (forward x @ w^T) dw = dy^T @ x -> (N, K)."""
    a, b = (dy, x) if transpose_w else (x, dy)
    _check(a, b, "tn", "split_matmul_wgrad")
    return _launch(a, b, "tn", bk, "wgrad")
