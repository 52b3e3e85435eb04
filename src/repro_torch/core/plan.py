"""Plan compilation: RunConfig -> OSDP decisions.

This is the glue between the abstract search (core.search) and the
model builder (sharding.specs + models.registry): it runs the
Profiler+SearchEngine+Scheduler pipeline of the paper and exposes the
result as the `decisions` dict the model builder consumes.  The
device-placement half of the JAX module (NamedSharding helpers) comes
with the sharded-execution slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import DeviceInfo, OSDPConfig, RunConfig
from repro_torch.core.cost_model import (DP, ZDP, CostEnv, Decision, PlanCost,
                                   plan_cost, uniform_plan)
from repro_torch.core.descriptions import ModelDescription, describe
from repro_torch.core.search import SearchResult, search_plan


@dataclass
class Plan:
    run: RunConfig
    desc: ModelDescription
    decisions: Dict[str, Decision]
    cost: PlanCost
    search: Optional[SearchResult]

    def summary(self) -> str:
        n_zdp = sum(1 for d in self.decisions.values()
                    if d.uniform() not in (DP, None))
        n_mixed = sum(1 for d in self.decisions.values()
                      if d.uniform() is None)
        lines = [
            f"plan[{self.run.model.name} x {self.run.shape.name}] "
            f"ops={len(self.decisions)} zdp={n_zdp} mixed={n_mixed}",
            f"  remat: {remat_summary(self.decisions, self.run.osdp)}",
            f"  est memory/device = {self.cost.memory / 2**30:.2f} GiB "
            f"(peak {self.cost.peak_memory / 2**30:.2f})",
            f"  est step time = {self.cost.time * 1e3:.2f} ms "
            f"(comm {self.cost.comm_time * 1e3:.2f}, "
            f"compute {self.cost.compute_time * 1e3:.2f})",
            f"  est throughput = {self.cost.throughput / 1e6:.2f} Mtok/s",
        ]
        return "\n".join(lines)


def remat_summary(decisions: Dict[str, Decision], osdp) -> str:
    """One-line remat description of a plan: the legacy global flag, or
    the per-op on/off/mixed counts of a selective plan."""
    explicit = [d for d in decisions.values()
                if d.remat is not None
                and any(r is not None for r in d.remat)]
    if not explicit:
        if osdp.selective_remat:
            return "selective (none set)"
        return "global on" if osdp.env_checkpointing else "global off"
    n_on = sum(1 for d in explicit if d.uniform_remat() is True)
    n_off = sum(1 for d in explicit if d.uniform_remat() is False)
    n_mix = len(explicit) - n_on - n_off
    n_inherit = len(decisions) - len(explicit)
    return (f"selective — {n_on} ops on, {n_off} off, {n_mix} mixed"
            + (f", {n_inherit} inherit" if n_inherit else ""))


def make_plan(run: RunConfig,
              device: Optional[DeviceInfo] = None,
              cluster=None, profile=None) -> Plan:
    """Run the OSDP pipeline for a RunConfig with a fixed global batch.

    `cluster` (a `repro.cluster.ClusterSpec`) prices collectives
    against the real bandwidth hierarchy; without one the flat
    (device, mesh) depth-2 adapter applies.  `profile` (a
    `repro.calibrate.CalibrationProfile`) prices with measured
    constants; None keeps the scalar path byte-identical."""
    device = device or (cluster.device if cluster is not None
                        else DeviceInfo())
    desc = describe(run.model, run.shape)
    # selective remat searches from the no-remat base env; bool flags
    # keep the legacy global-checkpointing environment
    env = CostEnv(device, run.mesh,
                  checkpointing=run.osdp.env_checkpointing,
                  train=(run.shape.kind == "train"),
                  cluster=cluster, profile=profile)
    if not run.osdp.enabled:
        decisions = uniform_plan(desc, DP)
        cost = plan_cost(desc, decisions, run.shape.global_batch, env)
        return Plan(run, desc, decisions, cost, None)
    res = search_plan(desc, run.shape.global_batch, env, run.osdp)
    return Plan(run, desc, res.decisions, res.cost, res)
