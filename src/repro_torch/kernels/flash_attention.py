"""flash_attention — online-softmax GQA attention as a CUDA kernel.

The wrapper of `csrc/flash_attention.cu`, which replaces the TPU kernel
`src/repro/kernels/flash_attention.py::flash_attention`, in the model
layout (no transposes): bf16 on the tensor cores (mma.sync, cp.async
double-buffered K/V tiles), float32 on CUDA cores.  CUDA tensors only
(the plain version in `ref.py` serves the CPU; `ops` dispatches);
counts its launches in `launches`.

For training the forward also writes each row's logsumexp (fp32,
(B, S, KV, G)), and `flash_attention_bwd` computes dq, dk, dv from it
(three kernels: D = rowsum(dO o), dq over key tiles, dk/dv over query
tiles; no atomics; bf16 only, as training on the card is bf16), counted
in `bwd_launches`.  The TPU kernel has no
backward: the JAX package trains through its jnp twin.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for
launches = 0           # forward launches since the last reset
bwd_launches = 0       # backward launches


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *more: torch.Tensor) -> None:
    ts = (q, k, v) + more
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("flash_attention needs CUDA tensors on one device")
    if any(t.dtype != q.dtype for t in ts) \
            or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bf16 or f32, got "
                        f"{[t.dtype for t in ts]}")
    if q.ndim != 5 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, S, KV, G, hd = q.shape
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != hd:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if any(t.shape != q.shape for t in more):
        raise ValueError("o and dout must be shaped like q")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: kernel built for {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention needs contiguous inputs")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention in bf16 copies 16-byte rows: "
                         "base pointers must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, q_offset: int = 0,
                    return_lse: bool = False):
    """q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> (B,S,KV,G,hd) in q.dtype, and
    with `return_lse` also each row's logsumexp (fp32, (B,S,KV,G)).
    Query s sits at position q_offset + s, key t at t; ragged S, T."""
    global launches
    _check(q, k, v)
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((B, S, KV, G), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    rc = _lib.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, S, T, KV, G, hd, int(causal), int(window), int(q_offset),
        1.0 / math.sqrt(hd), 1 if q.dtype == torch.bfloat16 else 0,
        _lib.stream_of(q))
    _lib.check(rc, "flash_attention")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool, window: int = 0,
                        q_offset: int = 0) -> tuple:
    """(dq, dk, dv) of `flash_attention` at (q, k, v) for the output
    gradient `dout`, from its output `o` and logsumexp `lse`; dk and dv
    summed over the G query heads of each kv head.  bf16 only."""
    global bwd_launches
    _check(q, k, v, o, dout)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd takes bf16, got {q.dtype}")
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    if lse.shape != (B, S, KV, G) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous fp32 {(B, S, KV, G)} on "
                         f"{q.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = torch.empty((B, S, KV, G), dtype=torch.float32, device=q.device)
    rc = _lib.lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dsum.data_ptr(), B, S, T, KV, G, hd, int(causal),
        int(window), int(q_offset), 1.0 / math.sqrt(hd), _lib.stream_of(q))
    _lib.check(rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
