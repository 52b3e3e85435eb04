"""Dense FFN (SwiGLU / GeLU) with OSDP operator-splitting hooks."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.operator_split import _act, chunked_ffn
from repro_torch.sharding.specs import ParamSet, _contract, seg_matmul


def ffn_forward(cfg: ModelConfig, pset: ParamSet,
                lp: Dict[str, torch.Tensor], x: torch.Tensor,
                prefix: str = "layers/ffn",
                granularity: int = 1) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d).

    Three execution paths, as in the JAX package:
      * plan split the op into mixed-mode segments -> seg_matmul
        (paper §3.3 per-slice modes);
      * uniform mode but splitting requested -> chunked_ffn (sequential
        slice processing caps the live hidden);
      * otherwise two plain products.
    Every product goes through the `split_matmul` kernel.  Only the
    seg_matmul path's products carry checkpoint tags, as there."""
    w13_path, w2_path = f"{prefix}/w13", f"{prefix}/w2"
    mixed = pset.layouts[w13_path].is_split or pset.layouts[w2_path].is_split
    if mixed:
        h = _act(seg_matmul(x, lp, pset, w13_path, 0), cfg.act)
        return seg_matmul(h, lp, pset, w2_path, 0)
    if granularity > 1:
        return chunked_ffn(x, lp[w13_path], lp[w2_path], granularity,
                           cfg.act)
    h = _act(_contract(x, lp[w13_path]), cfg.act)
    return _contract(h, lp[w2_path])
