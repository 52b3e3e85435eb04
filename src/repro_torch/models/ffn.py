"""Dense FFN (SwiGLU / GeLU) with OSDP operator-splitting hooks."""
from __future__ import annotations

from functools import partial
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.operator_split import (_act, chunked_ffn, w2_chunks,
                                             w13_chunks)
from repro_torch.sharding.specs import ParamSet, seg_matmul, weight_use


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
    seg_matmul path's products carry checkpoint tags, as there.  On a
    mesh a ZDP w13 or w2 is gathered on use: once for all its chunks."""
    w13_path, w2_path = f"{prefix}/w13", f"{prefix}/w2"
    mixed = pset.layouts[w13_path].is_split or pset.layouts[w2_path].is_split
    if mixed:
        h = _act(seg_matmul(x, lp, pset, w13_path, 0), cfg.act)
        return seg_matmul(h, lp, pset, w2_path, 0)
    g = granularity if cfg.d_ff % max(1, granularity) == 0 else 1
    two = 2 if cfg.act == "swiglu" else 1
    uses = [weight_use(lp, pset, w13_path,
                       partial(w13_chunks, g=g, two=two) if g > 1 else None),
            weight_use(lp, pset, w2_path,
                       partial(w2_chunks, g=g) if g > 1 else None)]
    y = chunked_ffn(x, uses[0][0], uses[1][0], g, cfg.act)
    for w, new in uses:
        if new:
            w.end_forward()
    return y
