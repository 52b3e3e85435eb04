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
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

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
launches = 0           # kernel launches since the last reset


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
                dtype: str = "bfloat16", aligned: bool = True) -> LaunchPlan:
    """The design, tile and K split for x(M, K) @ w(K, N) with K slices
    of `bk`, on a card of `n_sm` SMs."""
    kslice = max(1, min(bk, K))
    n_slices = math.ceil(K / kslice)

    def plan(variant, bm, bn, splits, sps, reason):
        blocks = math.ceil(M / bm) * math.ceil(N / bn) * splits
        ws = (splits, M, N) if splits > 1 else ()
        return LaunchPlan(variant, bm, bn, kslice, splits, sps, blocks, ws,
                          reason)

    general = None
    if dtype != "bfloat16":
        general = f"{dtype} inputs: the fp32 CUDA-core kernel"
    elif K % 8 or N % 8:
        general = (f"K={K} or N={N} not a multiple of 8: TMA and 16-byte "
                   f"copies need 16-byte row strides")
    elif not aligned:
        general = "a base pointer not 16-byte aligned"
    if general:
        return plan("general", TILE, TILE, 1, n_slices, general)

    if M <= STREAM_MAX_M:
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
                f"{M} rows > {STREAM_MAX_M}: TMA + wgmma")


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x: torch.Tensor, w: torch.Tensor, bk: int) -> LaunchPlan:
    """`plan_launch` for these tensors on their card."""
    M, K = x.shape
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return plan_launch(M, w.shape[1], K, bk, n_sm=_n_sm(x.device.index or 0),
                       dtype=str(x.dtype).removeprefix("torch."),
                       aligned=aligned)


def split_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = TILE,
                 bn: int = TILE, bk: int = 512) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) in x.dtype with an fp32 accumulator;
    K runs in slices of `bk` (operator-splitting granularity K/bk).
    Ragged M, N, K are fine.  The tile is the plan's (`plan_launch`), so
    `bm`/`bn` must be 64; they are kept for the TPU kernel's
    signature."""
    global launches
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"split_matmul needs CUDA tensors on one device, "
                         f"got {x.device} and {w.device}")
    if x.dtype != w.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"split_matmul takes bf16 or f32 pairs, got "
                        f"{x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("split_matmul needs contiguous row-major inputs")
    if (bm, bn) != (TILE, TILE) or bk < 1:
        raise ValueError(f"blocks (bm={bm}, bn={bn}, bk={bk}): the kernel "
                         f"chooses its own tiles, bm and bn must be {TILE} "
                         f"and bk >= 1")
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_()
    lib = _lib.lib()
    plan = plan_for(x, w, bk)
    stream = _lib.stream_of(x)
    if plan.variant == "general":
        fn = (lib.split_matmul_bf16 if x.dtype == torch.bfloat16
              else lib.split_matmul_f32)
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, bk,
                stream)
    else:
        ws = (torch.empty(plan.workspace, dtype=torch.float32,
                          device=x.device) if plan.workspace else None)
        fn = (lib.split_matmul_stream_bf16 if plan.variant == "stream"
              else lib.split_matmul_wgmma_bf16)
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                ws.data_ptr() if ws is not None else None, M, N, K,
                plan.kslice, plan.bn, plan.splits, plan.slices_per_split,
                stream)
    _lib.check(rc, f"split_matmul ({plan.variant})")
    launches += 1
    return y
