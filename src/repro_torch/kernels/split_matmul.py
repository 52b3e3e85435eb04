"""split_matmul — OSDP operator splitting (paper §3.3) as a CUDA kernel.

The wrapper of `csrc/split_matmul.cu`, which replaces the TPU kernel
`src/repro/kernels/split_matmul.py::split_matmul`.  It takes CUDA
tensors only (the plain version in `ref.py` serves the CPU; `ops`
dispatches) and counts its launches in `launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

TILE = 64              # the kernel's output tile, (TILE, TILE)
launches = 0           # kernel launches since the last reset


def split_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = TILE,
                 bn: int = TILE, bk: int = 512) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) in x.dtype with an fp32 accumulator;
    K runs in slices of `bk` (operator-splitting granularity K/bk).
    Ragged M, N, K are fine.  The kernel is compiled for a 64x64 output
    tile, so `bm`/`bn` must be 64; they are kept for the TPU kernel's
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
                         f"tiles the output {TILE}x{TILE} and needs bk >= 1")
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y
    if K == 0:
        return y.zero_()
    lib = _lib.lib()
    fn = (lib.split_matmul_bf16 if x.dtype == torch.bfloat16
          else lib.split_matmul_f32)
    rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, N, K, bk,
            _lib.stream_of(x))
    _lib.check(rc, "split_matmul")
    launches += 1
    return y
