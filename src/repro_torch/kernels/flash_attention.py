"""flash_attention — online-softmax GQA attention as a CUDA kernel.

The wrapper of `csrc/flash_attention.cu`, which replaces the TPU kernel
`src/repro/kernels/flash_attention.py::flash_attention`, in the model
layout (no transposes): bf16 on the tensor cores (mma.sync, cp.async
double-buffered K/V tiles), float32 on CUDA cores.  CUDA tensors only
(the plain version in `ref.py` serves the CPU; `ops` dispatches);
counts its launches in `launches`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for
launches = 0           # kernel launches since the last reset


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> (B,S,KV,G,hd) in q.dtype.
    Query s sits at position q_offset + s, key t at t; ragged S, T."""
    global launches
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention needs CUDA tensors on one device")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bf16 or f32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 5 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != hd:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: kernel built for {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous inputs")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention in bf16 copies 16-byte rows: "
                         "base pointers must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _lib.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, KV, G, hd, int(causal), int(window), int(q_offset),
        1.0 / math.sqrt(hd), 1 if q.dtype == torch.bfloat16 else 0,
        _lib.stream_of(q))
    _lib.check(rc, "flash_attention")
    launches += 1
    return out
