"""Operator splitting (§3.3) as sequential chunked computation.

The JAX package's `core/operator_split.py` on the port's kernels:

  * `chunked_matmul` — y = x @ w as a sum over `granularity` slices of
    the contraction dim, each slice's product added into one fp32
    accumulator by `split_matmul`'s accumulating form
    (`kernels.ops.matmul_acc`), cast to x's dtype once at the end;
  * `chunked_ffn` — a whole SwiGLU/GeLU FFN with the d_ff dimension in g
    chunks: chunk j of the gate half and the same chunk of the up half
    of `w13`, its activation, and h_j @ w2_j added into the fp32
    accumulator, so the (tokens, d_ff) hidden never exists whole.

The JAX package's `lax.scan` over slices becomes a Python loop.  Each
chunk's weight is a contiguous tensor: `w13` is regrouped once into
(g, d, two * c) (one copy of the weight a call, whose backward is one
copy of its gradient) and unbound, so the kernel reads every chunk as
stored; `w2`'s chunks are row blocks, contiguous already.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def chunked_matmul(x: torch.Tensor, w: torch.Tensor,
                   granularity: int) -> torch.Tensor:
    """y = x @ w computed as a sum over `granularity` contraction slices,
    in fp32.

    x: (..., K), w: (K, N) -> (..., N).  K must be divisible by g (the
    caller pads or lowers g otherwise); otherwise, and at g = 1, one
    product."""
    k = x.shape[-1]
    g = max(1, granularity)
    x2 = x.reshape(-1, k)
    if g == 1 or k % g != 0:
        y = ops.matmul(x2.contiguous(), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    c = k // g
    xs = x2.reshape(-1, g, c).transpose(0, 1).contiguous().unbind(0)
    ws = w.reshape(g, c, w.shape[-1]).unbind(0)
    acc = torch.zeros((x2.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for xg, wg in zip(xs, ws):
        acc = ops.matmul_acc(xg, wg, acc)
    return acc.to(x.dtype).reshape(*x.shape[:-1], w.shape[-1])


def chunked_ffn(x: torch.Tensor, w13: torch.Tensor, w2: torch.Tensor,
                granularity: int, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU/GeLU FFN with the d_ff dimension processed in g chunks.

    x:(..., d) w13:(d, 2*ff | ff) w2:(ff, d).  Peak hidden activation is
    ff/g wide; outputs accumulate in fp32.  At g = 1, or when g does not
    divide ff, the plain FFN."""
    ff = w2.shape[0]
    d = x.shape[-1]
    g = max(1, granularity)
    x2 = x.reshape(-1, d).contiguous()
    if g == 1 or ff % g != 0:
        h = _act(ops.matmul(x2, w13), act)
        y = ops.matmul(h, w2)
        return y.to(x.dtype).reshape(*x.shape[:-1], w2.shape[-1])
    c = ff // g
    two = 2 if act == "swiglu" else 1
    # (d, two, g, c) -> (g, d, two * c): chunk j's gate and up columns
    w13s = w13.reshape(d, two, g, c).permute(2, 0, 1, 3).reshape(
        g, d, two * c).unbind(0)
    w2s = w2.reshape(g, c, w2.shape[-1]).unbind(0)
    acc = torch.zeros((x2.shape[0], w2.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for w13g, w2g in zip(w13s, w2s):
        hg = _act(ops.matmul(x2, w13g), act, chunk=c)
        acc = ops.matmul_acc(hg, w2g, acc)
    return acc.to(x.dtype).reshape(*x.shape[:-1], w2.shape[-1])


def _act(h: torch.Tensor, act: str, chunk: Optional[int] = None
         ) -> torch.Tensor:
    if act == "swiglu":
        c = chunk if chunk is not None else h.shape[-1] // 2
        g1, g3 = h[..., :c], h[..., c:]
        return F.silu(g1.float()).to(h.dtype) * g3
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)
