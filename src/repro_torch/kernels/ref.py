"""Plain PyTorch versions of the kernels (same contracts).

`ops` takes these for CPU tensors; `chip_smoke.py` holds each CUDA
kernel against them on the card.  Layouts are the model path's.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def split_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     bk: Optional[int] = None) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) in fp32, cast to x.dtype.  With `bk`, K runs in
    slices of bk summed into one fp32 accumulator: the operator-splitting
    schedule of the kernel (granularity K/bk)."""
    K = x.shape[-1]
    xf, wf = x.float(), w.float()
    if not bk or bk >= K:
        return (xf @ wf).to(x.dtype)
    acc = None
    for s in range(0, K, bk):
        part = xf[:, s:s + bk] @ wf[s:s + bk]
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        q_offset: int = 0, bq: int = 512,
                        bk: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention, a line-by-line port of the JAX
    model path's `models/attention.py::flash_attention`.

    q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> (B,S,KV,G,hd)."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    bq, bk = min(bq, S), min(bk, T)
    dev = q.device
    out = torch.empty(B, S, KV, G, hd, dtype=torch.float32, device=dev)
    for q0 in range(0, S, bq):
        qb = q[:, q0:q0 + bq]
        n = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(n, device=dev)
        m = torch.full((B, KV, G, n), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, n), device=dev)
        acc = torch.zeros((B, KV, G, n, hd), device=dev)
        for k0 in range(0, T, bk):
            kb, vb = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
            k_pos = k0 + torch.arange(kb.shape[1], device=dev)
            s = torch.einsum("bqkgh,btkh->bkgqt", qb.float(),
                             kb.float()) * scale
            msk = torch.ones(n, kb.shape[1], dtype=torch.bool, device=dev)
            if causal:
                msk &= k_pos[None, :] <= q_pos[:, None]
            if window:
                msk &= (q_pos[:, None] - k_pos[None, :]) < window
            s = torch.where(msk, s, torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p, vb.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + n] = o.permute(0, 3, 1, 2, 4)
    return out.to(q.dtype)
