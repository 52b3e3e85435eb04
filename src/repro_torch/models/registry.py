"""Model construction from a run config and an OSDP plan.

`build_model(run, plan, mesh)` returns a `Built` bundle: the `Model`,
its weight specs, the data mesh, and `init(seed, device)` for random
parameters (on a mesh, the rank's shards of the world-1 weights).  The
plan's remat axis compiles into `Model.remat` (`_remat_policy`).
`train_inputs` gives a training batch's shapes and dtypes and
`input_shardings` its placements (tokens and labels by rows); the
decoder caches and the serve path are not sharded.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.cost_model import Decision
from repro_torch.core.plan import Placement, data_sharding
from repro_torch.models.common import attn_geometry
from repro_torch.models.transformer import Model, build_specs
from repro_torch.sharding.specs import (ParamSet, WeightSpec,
                                        build_param_set, plan_layouts,
                                        saved_activation_names)


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
    mesh: Optional[Any] = None      # launch.mesh.DataMesh

    @property
    def pset(self) -> ParamSet:
        return self.model.pset

    def init(self, seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
        """Random bf16 parameters from a torch generator seeded `seed`,
        on `device` (default: the card), segmented per the plan; on a
        mesh the rank's shards of the same full draws."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params, _ = build_param_set(self.specs, self.model.decisions, gen,
                                    dev, self.mesh)
        return params


def build_model(run: RunConfig, plan=None, mesh=None) -> Built:
    """`plan` is anything with `.decisions` (a `Plan` or a `ServePlan`);
    None builds the unsegmented (all-DP) model.  `mesh` (a
    `launch.mesh.DataMesh`) shards the plan's ZDP segments over its
    ranks; its world must match `run.mesh`'s data extent."""
    cfg = run.model
    cfg.validate()
    tp = run.mesh.model_parallel
    if mesh is not None and mesh.world != run.mesh.data_parallel:
        raise ValueError(f"data mesh of {mesh.world} ranks for a run "
                         f"planned on {run.mesh.data_parallel}")
    if mesh is not None and run.shape.global_batch % mesh.world:
        raise ValueError(f"global batch {run.shape.global_batch} does not "
                         f"divide over {mesh.world} ranks")
    decisions: Dict[str, Decision] = plan.decisions if plan else {}
    specs = build_specs(cfg, tp)
    geom = attn_geometry(cfg, tp) if cfg.has_attention else None
    pset = plan_layouts(specs, decisions, mesh)
    model = Model(cfg=cfg, geom=geom, pset=pset, decisions=decisions,
                  remat=_remat_policy(run, decisions, pset),
                  swa_window=(run.swa_window
                              if run.shape.name == "long_500k"
                              and not cfg.sliding_window else 0))
    return Built(model=model, specs=specs, run=run, mesh=mesh)


def _remat_policy(run: RunConfig, decisions: Dict[str, Decision],
                  pset: ParamSet):
    """Compile the plan's remat axis into `Model.remat`, as the JAX
    package's `_remat_policy`.

    Legacy plans (no explicit per-slice bits) keep the global flag.
    Selective plans compile to the tuple of product tags whose
    activations the checkpoint policy must SAVE (everything else is
    recomputed); all-keep plans drop the checkpoint entirely and
    all-remat plans take the plain full checkpoint."""
    default = run.osdp.env_checkpointing
    if not decisions or not any(d.remat is not None
                                for d in decisions.values()):
        return default
    saved, any_remat = saved_activation_names(pset.layouts, default)
    if not any_remat:
        return False
    if not saved:
        return True
    return saved


def train_inputs(cfg: ModelConfig, B: int, S: int,
                 device="meta") -> Dict[str, torch.Tensor]:
    """A training batch of the decoder families, tokens and labels (B, S)
    int32, on `device`: by default the meta device, shapes and dtypes
    only (the JAX package's ShapeDtypeStructs).  Audio and VLM batches
    come with those families."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(f"{cfg.name}: {cfg.family} batches are "
                                  f"not ported yet")
    return {k: torch.empty((B, S), dtype=torch.int32, device=device)
            for k in ("tokens", "labels")}


def input_shardings(run: RunConfig, mesh,
                    inputs: Dict[str, Any]) -> Dict[str, Placement]:
    """Placements of a training batch on `mesh`: every array by rows (the
    batch axis), so rank r takes rows [r B/W, (r+1) B/W).  The decoder
    caches of serving are not sharded."""
    out = {}
    for k, v in inputs.items():
        if k not in ("tokens", "labels"):
            raise NotImplementedError(f"placement of {k!r}: only the "
                                      f"training batch is sharded")
        out[k] = data_sharding(mesh, len(v.shape))
    return out
