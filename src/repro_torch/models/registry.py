"""Model construction from a run config and an OSDP plan.

`build_model(run, plan)` returns a `Built` bundle: the `Model`, its
weight specs, and `init(seed, device)` for random parameters.  One
device, so no mesh and no shardings; serving never rematerializes, so
no remat policy (both come with later slices).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.cost_model import Decision
from repro_torch.models.common import attn_geometry
from repro_torch.models.transformer import Model, build_specs
from repro_torch.sharding.specs import (WeightSpec, build_param_set,
                                        plan_layouts)


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None.  Asking for CUDA without one
    raises: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (or --cpu) "
                           "to run the plain versions on the CPU")
    return dev


@dataclass
class Built:
    model: Model
    specs: List[WeightSpec]
    run: RunConfig

    def init(self, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
        """Random bf16 parameters from a torch generator seeded `seed`,
        on `device` (default: the card), segmented per the plan."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params, _ = build_param_set(self.specs, self.model.decisions, gen,
                                    dev)
        return params


def build_model(run: RunConfig, plan=None) -> Built:
    """`plan` is anything with `.decisions` (a `Plan` or a `ServePlan`);
    None builds the unsegmented (all-DP) model."""
    cfg = run.model
    cfg.validate()
    tp = run.mesh.model_parallel
    decisions: Dict[str, Decision] = plan.decisions if plan else {}
    specs = build_specs(cfg, tp)
    geom = attn_geometry(cfg, tp) if cfg.has_attention else None
    model = Model(cfg=cfg, geom=geom,
                  pset=plan_layouts(specs, decisions), decisions=decisions,
                  swa_window=(run.swa_window
                              if run.shape.name == "long_500k"
                              and not cfg.sliding_window else 0))
    return Built(model=model, specs=specs, run=run)
