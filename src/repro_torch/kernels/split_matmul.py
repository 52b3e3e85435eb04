"""split_matmul — OSDP operator splitting (paper §3.3) as a CUDA kernel.

The wrapper of `csrc/split_matmul.cu`, which replaces the TPU kernel
`src/repro/kernels/split_matmul.py::split_matmul`.  It takes CUDA
tensors only (the plain version in `ref.py` serves the CPU; `ops`
dispatches) and counts its launches in `counts`, by role, layout and
design: one per call, which with split-K is the main kernel and its
in-order sum of the splits.

`plan_launch`, pure Python, chooses the design for a shape:

- ``"stream"`` (M <= 64, decode rows): split-K weight streaming on
  mma.sync, N tiles of 128/64/32/16 columns times K ranges of whole `bk`
  slices, enough blocks for 2 a SM where the slices allow it;
- ``"wgmma"`` (M > 64, prefill rows): TMA + wgmma, 128-row tiles of
  256/192/128/64 columns and split-K, whichever a cost model fitted on
  the card puts fastest;
- ``"persistent"`` (the accumulating form at M > 64, dgrad and wgrad):
  the wgmma design's roles and tiles in one block a SM that walks the output
  tiles in a grouped raster (`tile_order`), so a row tile's column tiles
  run together and its row operand is read from memory about once, with
  the epilogue staged through shared memory and TMA stores that drain
  while the next tile's products run (the accumulating form TMA-loads
  its acc tile during the mainloop and stores y from registers); bn and
  split-K by a cost model that counts the operands' memory bytes under
  that order (`operand_bytes`);
- ``"general"``: the first version, only for what the others cannot
  take (float32; K or N not a multiple of 8; a base pointer not 16-byte
  aligned), with the reason in the plan.

The role (`ROLES`) picks between the two prefill designs: the forward
and the tied head's forward keep "wgmma"; the accumulating form, dgrad
and wgrad take "persistent", whose K slices are whole 64-wide k-steps
or one slice of all of K (a `bk` that is not a multiple of 64 is planned
as one slice of all of K: the same fp32 sum over K, in 64-wide steps).

The backward takes the same kernel in two more operand layouts
(`LAYOUTS`), chosen by role:

- `split_matmul_dgrad` (dx = dy w^T; role "dgrad") reads
  w as stored, transposed in the load ("nt"); for a weight the forward
  used transposed (the tied head, y = x emb^T) it is the plain "nn";
- `split_matmul_wgrad` (dw = x^T dy; role "wgrad")
  contracts over the rows ("tn");
- `split_matmul(..., transpose_w=True)` is the tied head's forward in
  "nt", with no transposed copy of the embedding.

The accumulating form `split_matmul(x, w, acc=y)` returns the fp32
`y + x @ w` (role "acc"): the "stream", "persistent" and "general"
designs in the forward layout with an epilogue that adds the product's
fp32 sum into the fp32 tile of `acc` instead of casting it, so a
chunked product (`core/operator_split`) sums its chunks in fp32 as the
TPU kernel's K-slice accumulator does.

"nt" and "tn" take the TMA designs at every row count ("tn", which only
wgrad uses, the persistent one), with K cut at multiples of 64
(`BWD_KSLICE`, so only the tensor's end is ragged) and split-K where the
tiles leave SMs idle; what they cannot take (float32, a dimension not a
multiple of 8, a misaligned pointer) goes to a strided CUDA-core kernel
(variant "general").
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
ROLES = ("fwd", "acc", "dgrad", "wgrad")
PERSISTENT_BNS = (256, 192, 128)
HBM_BYTES = 3.35e12    # H100 SXM device memory, bytes/s (data sheet)
SMEM_LIMIT = 232448    # dynamic shared memory a block may use
MIN_STAGES = 4         # the persistent ring: with 3 its loads showed on the
                       # card (acc at bn 192: 0.168 ms; bn 128, 5 stages:
                       # 0.153)
ITEM_S = 4e-6          # a persistent item's ring fill and drain and its
                       # epilogue, beside its k-steps: fitted to a sweep of
                       # wgrad's bn and splits on an H100 (3-8 us pick the
                       # same plans)
BWD_KSLICE = 512       # K unit of the "nt"/"tn" plans, a multiple of 64
counts = {}            # (role, layout, variant) -> launches since the
                       # last reset (`ops.reset_launch_counts`)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one product is launched.  K is cut into `splits` ranges of
    `slices_per_split` whole slices of `kslice`; with splits > 1 the
    fp32 partials go to a `workspace` of that shape and are summed in
    split order."""
    variant: str            # "stream" | "wgmma" | "persistent" | "general"
    bm: int                 # output rows a block (a tile)
    bn: int                 # output columns a block (a tile)
    kslice: int             # bk, at most K
    splits: int
    slices_per_split: int
    blocks: int             # blocks of the main kernel
    workspace: Tuple[int, ...]
    reason: str
    # "persistent" only: row tiles a group of the walk (`tile_order`),
    # ring stages, shared memory a block, and the modelled bytes of the
    # row operand (A) and of the column operand (B) read from memory
    group: int = 0
    stages: int = 0
    smem: int = 0
    row_bytes: int = 0
    col_bytes: int = 0

    def k_ranges(self, K: int) -> List[Tuple[int, int]]:
        span = self.slices_per_split * self.kslice
        return [(s * span, min(K, (s + 1) * span))
                for s in range(self.splits)]


def persistent_smem(bn: int, out_bytes: int,
                    acc: bool = False) -> Tuple[int, int]:
    """(ring stages, shared memory bytes) of a persistent block whose
    output is staged in two buffers of 128 rows by 128 bytes (64 bf16 or
    32 fp32 columns; with `acc`, the accumulating form: its 128 x bn
    fp32 acc tile, `out_bytes` an element), as the kernel's `Ps` computes
    them."""
    stage = WGMMA_BM * 64 * 2 + bn // 64 * 64 * 64 * 2
    tile = WGMMA_BM * (bn * out_bytes if acc else 2 * 128)
    stages = min(8, (SMEM_LIMIT - 1024 - tile - 256) // stage)
    return stages, 1024 + stages * stage + tile + 256


def tile_order(M: int, N: int, bn: int, splits: int,
               group: int) -> List[Tuple[int, int, int]]:
    """(row tile, column tile, split) of each item of the persistent
    walk, in order, as the kernel's `TileOrder`: splits outermost; within
    a split, groups of `group` row tiles, each group's items with the row
    tile fastest.  Block b takes items b, b + blocks, b + 2 blocks, ..."""
    tiles_m, tiles_n = math.ceil(M / WGMMA_BM), math.ceil(N / bn)
    tiles, span = tiles_m * tiles_n, group * tiles_n
    out = []
    for t in range(tiles * splits):
        split, r = divmod(t, tiles)
        g, rr = divmod(r, span)
        first = g * group
        gm = min(group, tiles_m - first)
        out.append((first + rr % gm, rr // gm, split))
    return out


def operand_bytes(M: int, N: int, K: int, bn: int, splits: int, span: int,
                  blocks: int, group: int) -> Tuple[int, int]:
    """Modelled bytes of the row operand (A, M x K) and the column operand
    (B, K x N) that the persistent walk reads from device memory: the
    `blocks` blocks run about `blocks` consecutive items at a time, so an
    item's A tile (its row tile over its split's K range) comes from L2
    when one of the `blocks` items before it read the same tile, and from
    memory otherwise; the same for its B tile."""
    order = tile_order(M, N, bn, splits, group)
    last_a, last_b = {}, {}
    a_bytes = b_bytes = 0
    for t, (mt, nt, split) in enumerate(order):
        k_len = min(K, (split + 1) * span) - min(K, split * span)
        if t - last_a.get((mt, split), -blocks - 1) > blocks:
            a_bytes += min(WGMMA_BM, M - mt * WGMMA_BM) * k_len * 2
        if t - last_b.get((nt, split), -blocks - 1) > blocks:
            b_bytes += min(bn, N - nt * bn) * k_len * 2
        last_a[(mt, split)] = last_b[(nt, split)] = t
    return a_bytes, b_bytes


def _splits(n_slices: int, want: int) -> Tuple[int, int]:
    """(splits, slices a split) for about `want` splits, none empty."""
    sps = math.ceil(n_slices / max(1, min(want, n_slices)))
    return math.ceil(n_slices / sps), sps


@functools.lru_cache(maxsize=4096)
def plan_launch(M: int, N: int, K: int, bk: int, *, n_sm: int = N_SM,
                dtype: str = "bfloat16", aligned: bool = True,
                layout: str = "nn", role: str = "fwd") -> LaunchPlan:
    """The design, tile and K split for out(M, N) = A(M, K) . B(K, N)
    with K slices of `bk`, on a card of `n_sm` SMs; `layout` says how A
    and B are stored (`LAYOUTS`), `role` which product it is (`ROLES`):
    "acc" writes the fp32 acc + A . B."""
    if role not in ROLES or (role == "acc" and layout != "nn"):
        raise ValueError(f"plan_launch: role {role!r} in layout {layout!r}")
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

    if role != "fwd" or layout == "tn":
        if kslice % 64:     # whole k-steps, or one slice of all of K
            kslice, n_slices = K, 1
        return _plan_persistent(M, N, K, kslice, n_slices, n_sm, role,
                                layout, plan)

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


def _plan_persistent(M, N, K, kslice, n_slices, n_sm, role, layout,
                     plan) -> LaunchPlan:
    """The persistent design's bn and split-K: the least estimated time,
    the larger of the busiest block's items (each its k-steps, bound by
    their products or by taking in their tiles as for "wgmma", and
    ITEM_S) and the device memory the walk moves (`operand_bytes`, the
    output or the split-K partials, `acc`), plus with split-K the
    reduce: the partials read back, the output written, a launch.  A
    ragged last row or column tile costs a whole tile's steps.  A tile
    of fp32 outputs leaves room for fewer stages: bn with fewer than
    MIN_STAGES is not taken."""
    out_bytes = 4 if role == "acc" else 2
    tiles_m = math.ceil(M / WGMMA_BM)
    best, best_cost = None, math.inf
    for bn in PERSISTENT_BNS:
        tiles_n = math.ceil(N / bn)
        step = max(2.0 * WGMMA_BM * bn * 64 / SM_FLOPS,
                   2.0 * (WGMMA_BM + bn) * 64 / SM_TILE_BYTES)
        for want in range(1, min(n_slices, 16) + 1):
            splits, sps = _splits(n_slices, want)
            stages, smem = persistent_smem(
                bn, 4 if splits > 1 else out_bytes,
                acc=role == "acc" and splits == 1)
            if stages < MIN_STAGES and bn != PERSISTENT_BNS[-1]:
                continue
            items = tiles_m * tiles_n * splits
            blocks = min(n_sm, items)
            group = max(1, min(tiles_m, blocks // tiles_n))
            span = sps * kslice
            steps = math.ceil(min(K, span) / 64)
            a_b, b_b = operand_bytes(M, N, K, bn, splits, span, blocks,
                                     group)
            acc_bytes = 4.0 * M * N if role == "acc" else 0.0
            out = M * N * (4.0 * splits if splits > 1 else out_bytes)
            cost = max(math.ceil(items / blocks) * (steps * step + ITEM_S),
                       (a_b + b_b + out + acc_bytes) / HBM_BYTES)
            if splits > 1:          # the reduce reads the partials back
                cost += LAUNCH_S + (out + M * N * out_bytes
                                    + acc_bytes) / HBM_BYTES
            if cost < best_cost:
                best_cost = cost
                best = (bn, splits, sps, blocks, group, stages, smem, a_b,
                        b_b)
    bn, splits, sps, blocks, group, stages, smem, a_b, b_b = best
    p = plan("persistent", WGMMA_BM, bn, splits, sps,
             f"{role} in layout {layout}: persistent TMA + wgmma, "
             f"{blocks} blocks")
    return dataclasses.replace(p, blocks=blocks, group=group, stages=stages,
                               smem=smem, row_bytes=a_b, col_bytes=b_b)


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
             layout: str = "nn", role: str = "fwd") -> LaunchPlan:
    """`plan_launch` for these tensors on their card (its SM count read
    from the device)."""
    M, N, K = dims(x, w, layout)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return plan_launch(M, N, K, bk, n_sm=_n_sm(x.device.index or 0),
                       dtype=str(x.dtype).removeprefix("torch."),
                       aligned=aligned, layout=layout, role=role)


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
    adds one to `counts` under (role, layout, design)."""
    M, N, K = dims(a, b, layout)
    y = torch.empty((M, N), dtype=a.dtype if acc is None else torch.float32,
                    device=a.device)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_() if acc is None else y.copy_(acc)
    acc_ptr = acc.data_ptr() if acc is not None else None
    lib = _lib.lib()
    plan = plan_for(a, b, bk, layout, role)
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
                ws.data_ptr() if ws is not None else None)
        if plan.variant == "stream":
            rc = lib.split_matmul_stream_bf16(
                *args, acc_ptr, M, N, K, plan.kslice, plan.bn, plan.splits,
                plan.slices_per_split, stream)
        elif plan.variant == "persistent":
            rc = lib.split_matmul_persistent_bf16(
                *args, acc_ptr, LAYOUTS[layout], M, N, K, plan.kslice,
                plan.bn, plan.splits, plan.slices_per_split, plan.blocks,
                plan.group, stream)
        else:               # the plan sends no accumulating call here
            rc = lib.split_matmul_wgmma_bf16(
                *args, LAYOUTS[layout], M, N, K, plan.kslice, plan.bn,
                plan.splits, plan.slices_per_split, stream)
    _lib.check(rc, f"split_matmul ({layout}, {plan.variant})")
    key = (role, layout, plan.variant)
    counts[key] = counts.get(key, 0) + 1
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
