"""GQA attention: the flash kernel on the training/prefill path + cached
decode.

Layouts (see common.AttnGeom), as in the JAX package:
  q: (B, S, KV, Gp, hd)   — grouped by kv head; Gp includes padding
  k/v: (B, T, KV, hd)

Full-sequence attention (`attn_forward`: training and prefill) is the
`flash_attention` kernel in its differentiable form (`ops.attention`):
the CUDA kernel for CUDA tensors, the blockwise plain version on the
CPU; in training its backward is the `flash_attention` backward
kernel.
Decode is plain torch: one query row per sequence against the cache,
which the JAX package also leaves to the compiler (no kernel to port).

The KV cache tags every slot with its absolute position (`pos`, -1 =
empty), so full and rolling sliding-window caches are uniform: validity
and window masking are position arithmetic.  Unlike the JAX package,
`attn_decode` writes the new k/v into the cache in place (no copy of
the cache per token); the caller owns the cache tensors.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import AttnGeom, rotate
from repro_torch.sharding.specs import ParamSet, seg_matmul

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> (B,S,KV,G,hd), via the kernel
    (differentiable)."""
    return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, window=window, q_offset=q_offset)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive oracle — same contract as flash_attention."""
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    dev = q.device
    s = torch.einsum("bqkgh,btkh->bkgqt", q.float(),
                     k.float()) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(S, device=dev)
    k_pos = torch.arange(T, device=dev)
    msk = torch.ones(S, T, dtype=torch.bool, device=dev)
    if causal:
        msk &= k_pos[None, :] <= q_pos[:, None]
    if window:
        msk &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(msk, s, torch.tensor(NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", p, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _proj_qkv(cfg: ModelConfig, geom: AttnGeom, pset: ParamSet,
              lp: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = seg_matmul(x, lp, pset, "layers/attn/wq", 0)
    k = seg_matmul(x, lp, pset, "layers/attn/wk", 0)
    v = seg_matmul(x, lp, pset, "layers/attn/wv", 0)
    if cfg.qkv_bias:
        q = q + lp["layers/attn/bq"]
        k = k + lp["layers/attn/bk"]
        v = v + lp["layers/attn/bv"]
    q = q.reshape(B, S, geom.n_kv, geom.group_padded, geom.head_dim)
    k = k.reshape(B, S, geom.n_kv, geom.head_dim)
    v = v.reshape(B, S, geom.n_kv, geom.head_dim)
    return q, k, v


def _group_mask(geom: AttnGeom, dtype, device=None) -> torch.Tensor:
    """(1, Gp) 1/0 mask zeroing padded q heads."""
    return (torch.arange(geom.group_padded, device=device)
            < geom.group).to(dtype)[None, :]


def _out_proj(geom: AttnGeom, pset: ParamSet, lp: Dict[str, torch.Tensor],
              o: torch.Tensor) -> torch.Tensor:
    """o: (B,S,KV,Gp,hd) -> (B,S,d); masks padded heads to exact zero."""
    B, S = o.shape[:2]
    if geom.group_padded != geom.group:
        o = o * _group_mask(geom, o.dtype, o.device)[None, None, :, :, None]
    o = o.reshape(B, S, geom.q_flat)
    return seg_matmul(o, lp, pset, "layers/attn/wo", 0)


def _rotate_qk(cfg: ModelConfig, geom: AttnGeom, q: torch.Tensor,
               k: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    q = rotate(cfg, q.reshape(*q.shape[:2], -1, geom.head_dim), positions
               ).reshape(q.shape)
    return q, rotate(cfg, k, positions)


# ---------------------------------------------------------------------------
# block entry points
# ---------------------------------------------------------------------------

def attn_forward(cfg: ModelConfig, geom: AttnGeom, pset: ParamSet,
                 lp: Dict[str, torch.Tensor], x: torch.Tensor,
                 positions: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Full-sequence attention (training, no cache; and prefill)."""
    q, k, v = _proj_qkv(cfg, geom, pset, lp, x)
    q, k = _rotate_qk(cfg, geom, q, k, positions)
    win = window or cfg.sliding_window
    o = flash_attention(q, k, v, causal=cfg.causal, window=win)
    return _out_proj(geom, pset, lp, o)


def init_kv_cache(cfg: ModelConfig, geom: AttnGeom, batch: int,
                  cache_len: int, dtype=torch.bfloat16,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Per-layer stacked cache (leading L axis)."""
    L = cfg.n_layers
    shp = (L, batch, cache_len, geom.n_kv, geom.head_dim)
    return {
        "k": torch.zeros(shp, dtype=dtype, device=device),
        "v": torch.zeros(shp, dtype=dtype, device=device),
        "pos": torch.full((L, batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def attn_decode(cfg: ModelConfig, geom: AttnGeom, pset: ParamSet,
                lp: Dict[str, torch.Tensor], x: torch.Tensor,
                t, cache: Dict[str, torch.Tensor], *,
                window: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B,1,d); t: a scalar position (whole batch
    in lockstep) or a (B,) vector (continuous batching); cache holds
    this layer's views {k:(B,Sc,KV,hd), v:..., pos:(B,Sc)}, updated in
    place and returned."""
    B = x.shape[0]
    Sc = cache["k"].shape[1]
    q, k, v = _proj_qkv(cfg, geom, pset, lp, x)
    t_vec = torch.as_tensor(t, dtype=torch.int32,
                            device=x.device).expand(B).contiguous()
    if cfg.rope != "none":
        q, k = _rotate_qk(cfg, geom, q, k, t_vec[:, None])
    # per-sequence ring-buffer slot, written in place
    slot = (t_vec % Sc).long() if Sc > 0 else torch.zeros_like(t_vec).long()
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = t_vec

    # single-row softmax over the cache (scores are (B,KV,Gp,1,Sc))
    s = torch.einsum("bqkgh,btkh->bkgqt", q.float(), cache["k"].float())
    s = s / math.sqrt(geom.head_dim)
    pos = cache["pos"]
    valid = pos >= 0
    if window:
        valid &= (t_vec[:, None] - pos) < window
    valid &= pos <= t_vec[:, None]
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.tensor(NEG_INF, device=x.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkh->bqkgh", p, cache["v"].float()).to(x.dtype)
    return _out_proj(geom, pset, lp, o), cache
