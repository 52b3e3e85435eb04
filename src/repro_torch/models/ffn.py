"""Dense FFN (SwiGLU / GeLU) with OSDP operator-splitting hooks."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.specs import ParamSet, _contract, seg_matmul


def ffn_forward(cfg: ModelConfig, pset: ParamSet,
                lp: Dict[str, torch.Tensor], x: torch.Tensor,
                prefix: str = "layers/ffn",
                granularity: int = 1) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d).

    A plan that split the op into mixed-mode segments runs seg_matmul
    (paper §3.3 per-slice modes); otherwise two plain products.  Both
    go through the `split_matmul` kernel.  Chunked operator splitting
    (granularity > 1, `core/operator_split.py`) is not ported yet."""
    if granularity > 1:
        raise NotImplementedError("chunked FFN splitting (granularity > 1, "
                                  "core/operator_split.py) is not ported "
                                  "yet")
    w13_path, w2_path = f"{prefix}/w13", f"{prefix}/w2"
    mixed = pset.layouts[w13_path].is_split or pset.layouts[w2_path].is_split
    if mixed:
        h = seg_matmul(x, lp, pset, w13_path, 0)
        h = _act(cfg, h)
        return seg_matmul(h, lp, pset, w2_path, 0)
    h = _act(cfg, _contract(x, lp[w13_path]))
    return _contract(h, lp[w2_path])


def _act(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        ff = h.shape[-1] // 2
        return F.silu(h[..., :ff].float()).to(h.dtype) * h[..., ff:]
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)
