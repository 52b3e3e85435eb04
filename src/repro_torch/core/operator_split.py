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

On a data mesh `w13` and `w2` may be ZDP weights (`Gathered`, cut by
`w13_chunks` / `w2_chunks`): each is gathered once for its g chunks in
the forward and once in the backward.  Gathering each chunk apart (the
cost model's M_extra / g) is not ported (ROADMAP section 1 item 5).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding.collectives import Gathered


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


def w13_chunks(w13: torch.Tensor, g: int, two: int) -> tuple:
    """(d, two * ff) -> g contiguous (d, two * ff / g) chunks: chunk j's
    gate and up columns side by side."""
    d = w13.shape[0]
    c = w13.shape[1] // (two * g)
    # (d, two, g, c) -> (g, d, two * c)
    return w13.reshape(d, two, g, c).permute(2, 0, 1, 3).reshape(
        g, d, two * c).unbind(0)


def w2_chunks(w2: torch.Tensor, g: int) -> tuple:
    """(ff, d) -> g row blocks."""
    return w2.reshape(g, w2.shape[0] // g, w2.shape[-1]).unbind(0)


def _chunks(w, cut):
    """(chunks, their pieces, a context holding the gathered weight) of a
    tensor or a `Gathered` already cut the same way."""
    if isinstance(w, Gathered):
        return w.views, [w.piece(j) for j in range(len(w.views))], w.hold()
    ws = cut(w)
    return ws, [None] * len(ws), contextlib.nullcontext()


def chunked_ffn(x: torch.Tensor, w13, w2, granularity: int,
                act: str = "swiglu") -> torch.Tensor:
    """SwiGLU/GeLU FFN with the d_ff dimension processed in g chunks.

    x:(..., d) w13:(d, 2*ff | ff) w2:(ff, d), each a tensor or a
    `Gathered` cut by `w13_chunks` / `w2_chunks` at this g (whole at
    g = 1).  Peak hidden activation is ff/g wide; outputs accumulate in
    fp32.  At g = 1, or when g does not divide ff, the plain FFN."""
    ff = w2.shape[0]
    d = x.shape[-1]
    g = max(1, granularity)
    x2 = x.reshape(-1, d).contiguous()
    if g == 1 or ff % g != 0:
        (w13s,), p13, hold13 = _chunks(w13, lambda w: [w])
        (w2s,), p2, hold2 = _chunks(w2, lambda w: [w])
        with hold13, hold2:
            h = _act(ops.matmul(x2, w13s, pieces=p13 if p13[0] else None),
                     act)
            y = ops.matmul(h, w2s, pieces=p2 if p2[0] else None)
        return y.to(x.dtype).reshape(*x.shape[:-1], w2.shape[-1])
    c = ff // g
    two = 2 if act == "swiglu" else 1
    w13s, p13, hold13 = _chunks(w13, lambda w: w13_chunks(w, g, two))
    w2s, p2, hold2 = _chunks(w2, lambda w: w2_chunks(w, g))
    acc = torch.zeros((x2.shape[0], w2.shape[-1]), dtype=torch.float32,
                      device=x.device)
    with hold13, hold2:
        for w13g, q13, w2g, q2 in zip(w13s, p13, w2s, p2):
            hg = _act(ops.matmul(x2, w13g, pieces=q13 and [q13]), act,
                      chunk=c)
            acc = ops.matmul_acc(hg, w2g, acc, q2)
    return acc.to(x.dtype).reshape(*x.shape[:-1], w2.shape[-1])


def _act(h: torch.Tensor, act: str, chunk: Optional[int] = None
         ) -> torch.Tensor:
    if act == "swiglu":
        c = chunk if chunk is not None else h.shape[-1] // 2
        g1, g3 = h[..., :c], h[..., c:]
        return F.silu(g1.float()).to(h.dtype) * g3
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)
