"""Mamba2 / SSD (state-space duality) block. [arXiv:2405.21060]

Block: in_proj -> [z | x | B | C | dt] -> causal depthwise conv on
(x,B,C) -> SSD chunk scan -> gated RMSNorm(z) -> out_proj.

The chunk scan (`ssd_chunk_scan`) is `ops.ssd`: the `ssd_scan` kernel
on the card and its plain version on the CPU (`kernels.ops`), whose
backward, when gradients are taken, is the `ssd_scan_bwd` kernel (the
JAX package differentiates its jnp scan instead).  The decode step's
single-token recurrence is plain torch, as it is plain jnp in the JAX
package.  Every dtype round trip of the JAX module is kept: dt is a
softplus in fp32, the conv output a SiLU in fp32 cast back to the
activation type, the conv state an fp32 cache leaf cast to the
activation type on use, `y + x*D` formed in fp32 and cast before the
gate, `silu(z)` in fp32 cast before the product.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rmsnorm
from repro_torch.sharding.specs import ParamSet, seg_matmul

CONV_K = 4  # depthwise conv kernel width (Mamba2 default)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over a sequence.

    x: (B,S,nh,hd)  dt: (B,S,nh)  a_log: (nh,) [stores log(-A) > 0]
    b, c: (B,S,ns)  (single group, shared across heads)
    returns (y fp32 (B,S,nh,hd), final_state fp32 (B,nh,hd,ns))
    """
    return ops.ssd(x, dt, a_log, b, c, chunk=chunk, init_state=init_state)


def ssd_decode_step(x, dt, a_log, b, c, state):
    """One token: x:(B,nh,hd) dt:(B,nh) b,c:(B,ns) state:(B,nh,hd,ns)."""
    a = -torch.exp(a_log.float())
    dec = torch.exp(dt.float() * a)                      # (B,nh)
    upd = torch.einsum("bs,bnh->bnhs", b.float(),
                       x.float() * dt.float()[..., None])
    s = state.float() * dec[:, :, None, None] + upd
    y = torch.einsum("bs,bnhs->bnh", c.float(), s)
    return y, s


# ---------------------------------------------------------------------------
# conv + block assembly
# ---------------------------------------------------------------------------

def causal_conv(u: torch.Tensor, w: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u:(B,S,C) w:(K,C). Returns (out, new_state)
    where state is the trailing K-1 inputs (for decode)."""
    K = w.shape[0]
    if state is None:
        ctx = F.pad(u, (0, 0, K - 1, 0))
    else:
        ctx = torch.cat([state.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = ctx[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + ctx[:, i:i + S] * w[i]
    new_state = ctx[:, -(K - 1):] if K > 1 else ctx[:, :0]
    return F.silu(out.float()).to(u.dtype), new_state


def _split_proj(cfg: ModelConfig, pset: ParamSet,
                lp: Dict[str, torch.Tensor], x: torch.Tensor):
    di, ns = cfg.ssm_d_inner, cfg.ssm_state
    zx = seg_matmul(x, lp, pset, "layers/ssm/w_zx", 0)     # (B,S,2di)
    bcdt = seg_matmul(x, lp, pset, "layers/ssm/w_bcdt", 0)  # (B,S,2ns+nh)
    z, xin = zx[..., :di], zx[..., di:]
    b, c, dt_raw = (bcdt[..., :ns], bcdt[..., ns:2 * ns], bcdt[..., 2 * ns:])
    dt = F.softplus(dt_raw.float() + lp["layers/ssm/dt_bias"].float())
    return z, xin, b, c, dt


def _gate_out(cfg: ModelConfig, pset: ParamSet, lp, y: torch.Tensor,
              xh: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """y (fp32, heads last-but-one) + x*D, gated RMSNorm, out_proj."""
    y = y + xh.float() * lp["layers/ssm/D"].float()[:, None]
    y = y.reshape(*z.shape[:-1], cfg.ssm_d_inner).to(dtype)
    y = rmsnorm(y * F.silu(z.float()).to(dtype), lp["layers/ssm/gate_norm"])
    return seg_matmul(y, lp, pset, "layers/ssm/wo", 0)


def ssm_block(cfg: ModelConfig, pset: ParamSet,
              lp: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD block over a sequence. x: (B,S,d) -> ((B,S,d), the final
    SSD state (B,nh,hd,ns) fp32, the last K-1 conv inputs (B,K-1,C))."""
    B, S, _ = x.shape
    di, ns, nh, hd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                      cfg.ssm_head_dim)
    z, xin, b, c, dt = _split_proj(cfg, pset, lp, x)
    conv_in = torch.cat([xin, b, c], dim=-1)
    conv_out, conv_state = causal_conv(conv_in, lp["layers/ssm/conv_w"])
    xin, b, c = (conv_out[..., :di], conv_out[..., di:di + ns],
                 conv_out[..., di + ns:])
    xh = xin.reshape(B, S, nh, hd)
    y, state = ssd_chunk_scan(xh, dt, lp["layers/ssm/A_log"], b, c,
                              cfg.ssm_chunk)
    return _gate_out(cfg, pset, lp, y, xh, z, x.dtype), state, conv_state


def ssm_forward(cfg: ModelConfig, pset: ParamSet,
                lp: Dict[str, torch.Tensor], x: torch.Tensor
                ) -> torch.Tensor:
    """Training / prefill SSD block. x: (B,S,d) -> (B,S,d)."""
    return ssm_block(cfg, pset, lp, x)[0]


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device="cuda") -> Dict[str, torch.Tensor]:
    L, di, ns, nh, hd = (cfg.n_layers, cfg.ssm_d_inner, cfg.ssm_state,
                         cfg.ssm_n_heads, cfg.ssm_head_dim)
    return {
        "state": torch.zeros((L, batch, nh, hd, ns), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((L, batch, CONV_K - 1, di + 2 * ns),
                            dtype=torch.float32, device=device),
    }


def ssm_decode(cfg: ModelConfig, pset: ParamSet,
               lp: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x:(B,1,d); cache: this layer's {state, conv}
    views, updated in place and returned."""
    B = x.shape[0]
    di, ns, nh, hd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                      cfg.ssm_head_dim)
    z, xin, b, c, dt = _split_proj(cfg, pset, lp, x)
    conv_in = torch.cat([xin, b, c], dim=-1)               # (B,1,di+2ns)
    conv_out, conv_state = causal_conv(conv_in, lp["layers/ssm/conv_w"],
                                       state=cache["conv"])
    xin, b, c = (conv_out[..., :di], conv_out[..., di:di + ns],
                 conv_out[..., di + ns:])
    xh = xin[:, 0].reshape(B, nh, hd)
    y, state = ssd_decode_step(xh, dt[:, 0], lp["layers/ssm/A_log"],
                               b[:, 0], c[:, 0], cache["state"])
    out = _gate_out(cfg, pset, lp, y, xh, z, x.dtype)
    cache["state"].copy_(state)
    cache["conv"].copy_(conv_state)
    return out, cache
