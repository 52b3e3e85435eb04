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


def split_matmul_splitk_ref(x: torch.Tensor, w: torch.Tensor, bk: int,
                            ranges) -> torch.Tensor:
    """The summation order of the CUDA kernel's split-K plans: K is cut
    into `ranges` [(k0, k1), ...] of whole slices of `bk`; within a
    range the slices add into one fp32 accumulator, then the ranges'
    fp32 partials are summed in range order and cast to x.dtype."""
    xf, wf = x.float(), w.float()
    total = None
    for k0, k1 in ranges:
        acc = None
        for s in range(k0, k1, bk):
            e = min(s + bk, k1)
            part = xf[:, s:e] @ wf[s:e]
            acc = part if acc is None else acc + part
        total = acc if total is None else total + acc
    return total.to(x.dtype)


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


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *, chunk: int,
                 init_state: Optional[torch.Tensor] = None) -> tuple:
    """Mamba2 SSD chunk scan, a line-by-line port of the JAX model path's
    `models/ssm.py::ssd_chunk_scan` (ragged S padded to a multiple of
    the chunk, mask before exp, inter-chunk state carried in fp32).

    x:(B,S,nh,hd) dt:(B,S,nh) a_log:(nh,) [log(-A)] b,c:(B,S,ns)
    -> (y fp32 (B,S,nh,hd), final_state fp32 (B,nh,hd,ns))."""
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // Q

    a = -torch.exp(a_log.float())                        # (nh,) A < 0
    dt = dt.float()
    dA = dt * a                                          # (B,Sp,nh)
    xd = x.float() * dt[..., None]                       # dt-weighted input

    dAc = dA.reshape(B, nc, Q, nh)
    xc = xd.reshape(B, nc, Q, nh, hd)
    bc = b.reshape(B, nc, Q, ns).float()
    cc = c.reshape(B, nc, Q, ns).float()

    csum = torch.cumsum(dAc, dim=2)                      # (B,nc,Q,nh)
    diff = csum[:, :, :, None, :] - csum[:, :, None, :, :]  # (B,nc,Q,Q,nh)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    # mask BEFORE exp: masked (i<j) entries have diff > 0
    att = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                     float("-inf")))
    cb = torch.einsum("bnis,bnjs->bnij", cc, bc)         # (B,nc,Q,Q)
    y_intra = torch.einsum("bnij,bnijh,bnjhd->bnihd", cb, att, xc)

    decay_to_end = torch.exp(csum[:, :, -1:, :] - csum)  # (B,nc,Q,nh)
    states = torch.einsum("bnjs,bnjh,bnjhd->bnhds", bc, decay_to_end, xc)

    chunk_decay = torch.exp(csum[:, :, -1, :])           # (B,nc,nh)
    s = (init_state.float() if init_state is not None
         else torch.zeros(B, nh, hd, ns, device=x.device))
    prev = []
    for n in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,nh,hd,ns)

    y_inter = torch.einsum("bnis,bnih,bnhds->bnihd", cc, torch.exp(csum),
                           prev_states)
    y = (y_intra + y_inter).reshape(B, Sp, nh, hd)[:, :S]
    return y, s


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor,
                       a_log: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor,
                       init_state: Optional[torch.Tensor] = None) -> tuple:
    """The naive per-step recurrence, a port of the JAX `models/ssm.py::
    ssd_ref` oracle.  Same contract as `ssd_scan_ref`."""
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    a = -torch.exp(a_log.float())
    s = (init_state.float() if init_state is not None
         else torch.zeros(B, nh, hd, ns, device=x.device))
    dt = dt.float()
    ys = []
    for t in range(S):
        dec = torch.exp(dt[:, t] * a)                    # (B,nh)
        upd = torch.einsum("bs,bnh->bnhs", b[:, t].float(),
                           x[:, t].float() * dt[:, t][..., None])
        s = s * dec[:, :, None, None] + upd
        ys.append(torch.einsum("bs,bnhs->bnh", c[:, t].float(), s))
    return torch.stack(ys, dim=1), s
