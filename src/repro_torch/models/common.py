"""Shared model building blocks: norms, RoPE, GQA geometry.

GQA geometry (as in the JAX package): q/k/v/o projections use flat
(n_heads*head_dim) layouts; with a TP axis, q heads may be padded per
kv group so the flat dim divides it, and padded heads are masked to
exact zero before the out-projection.  On one device (tp_size 1) no
padding happens.  Multimodal RoPE comes with the VLM slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig

PAD_LIMIT = 1.5


@dataclass(frozen=True)
class AttnGeom:
    """Resolved GQA geometry for a given model-axis size."""

    n_heads: int          # true q heads
    n_kv: int
    head_dim: int
    group: int            # true q heads per kv head
    group_padded: int     # padded group size (>= group)
    tp: bool              # whether attention projections are TP-sharded

    @property
    def padded_heads(self) -> int:
        return self.n_kv * self.group_padded

    @property
    def q_flat(self) -> int:
        return self.padded_heads * self.head_dim

    @property
    def kv_flat(self) -> int:
        return self.n_kv * self.head_dim


def attn_geometry(cfg: ModelConfig, tp_size: int) -> AttnGeom:
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    gp = g
    if tp_size > 1:
        while (kv * gp) % tp_size != 0:
            gp += 1
    if gp * kv > PAD_LIMIT * h:
        return AttnGeom(h, kv, hd, g, g, tp=False)
    return AttnGeom(h, kv, hd, g, gp, tp=(tp_size > 1))


# --- norms -------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def norm(cfg: ModelConfig, x: torch.Tensor, scale: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.norm == "layernorm":
        assert bias is not None
        return layernorm(x, scale, bias)
    return rmsnorm(x, scale)


# --- rotary embeddings -------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) * 2 / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def positions_for(cfg: ModelConfig, batch: dict, seq: int) -> torch.Tensor:
    """Token positions (B,S) for rope."""
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE comes with the VLM slice")
    if "positions" in batch:
        return batch["positions"]
    ref = batch["tokens"]
    return torch.arange(seq, dtype=torch.int32,
                        device=ref.device).expand(ref.shape[0], seq)


def rotate(cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE comes with the VLM slice")
    return apply_rope(x, positions, cfg.rope_theta)
