"""Hybrid 3D parallelism as a first-class plan space (paper Fig. 5/6).

The paper's strongest configuration replaces the DP dimension of 3D
parallelism (DP x TP x PP) with the OSDP search — "3D+OSDP".  This
module provides the pieces that make that configuration searchable by
`core.search.search_hybrid` instead of living in a one-off figure
script:

  * `Factorization`   — one (dp, tp, pp) point of the device grid,
  * `factorizations`  — the exhaustive sweep dp * tp * pp == n,
  * TP / PP cost terms expressed through the same ring-collective
    machinery as `cost_model` (CostEnv alpha/beta/gamma constants):
      TP — Megatron column+row pairs: 2 activation all-reduces per
           layer of the (b_local, s, d) tensor, each all-reduce a
           reduce-scatter + all-gather ring pass,
      PP — GPipe microbatching: bubble (pp-1)/(m+pp-1) and
           stage-boundary activation sends,
  * `slice_description` — the 1/(tp*pp) model residue the DP-dimension
    solvers (dfs/knapsack/greedy) decide over,
  * `HybridPlan`      — `core.plan.Plan`'s hybrid sibling: the chosen
    factorization, GPipe stage boundaries, and the per-operator
    DP/ZDP decisions of the inner search.

The DP residue inherits the full 4-mode decision axis: with
`OSDPConfig(checkpointing="selective")` the inner Scheduler searches
remat per slice jointly with DP/ZDP over the residue (its `Decision`s
carry explicit remat bits), and the factorization sweep's compute-only
throughput bound drops the 1.30 recompute factor so it stays
admissible for mixed-remat plans.

The activation collectives are charged in the bandwidth regime
(alpha dropped): the messages are MB-scale, so (n-1)*alpha is noise
next to the beta term, and dropping it keeps the hybrid rows directly
comparable with the analytical baselines.  The DP-dimension costs
coming out of `cost_model.plan_cost` keep their full alpha+beta
treatment.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import DeviceInfo, MeshConfig
from repro_torch.cluster.topology import ClusterSpec
from repro_torch.core.cost_model import (DP, Decision, PlanCost, _ring_time,
                                   count_remat_slices)
from repro_torch.core.descriptions import ACT_BYTES, ModelDescription

HYBRID_AXES = ("data", "model", "pipe")


@dataclass(frozen=True)
class Factorization:
    """One point of the (dp, tp, pp) device-grid sweep."""

    dp: int
    tp: int
    pp: int

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.pp

    @property
    def is_pure_dp(self) -> bool:
        return self.tp == 1 and self.pp == 1

    def mesh_config(self) -> MeshConfig:
        """3-axis logical mesh: data (DP/ZDP) x model (TP) x pipe (PP)."""
        return MeshConfig((self.dp, self.tp, self.pp), HYBRID_AXES)

    def __str__(self) -> str:
        return f"(dp={self.dp}, tp={self.tp}, pp={self.pp})"


def factorizations(n_devices: int, max_tp: int = 0,
                   max_pp: int = 0) -> List[Factorization]:
    """All (dp, tp, pp) with dp * tp * pp == n_devices, exhaustively.

    `max_tp` / `max_pp` cap the respective axes (0 = uncapped); TP is
    usually capped at the per-node device count so its all-reduces stay
    on the fast intra-node links.
    """
    out: List[Factorization] = []
    for tp in range(1, n_devices + 1):
        if n_devices % tp or (max_tp and tp > max_tp):
            continue
        rest = n_devices // tp
        for pp in range(1, rest + 1):
            if rest % pp or (max_pp and pp > max_pp):
                continue
            out.append(Factorization(rest // pp, tp, pp))
    return out


def slice_description(desc: ModelDescription, tp: int,
                      pp: int) -> ModelDescription:
    """The 1/(tp*pp) per-device model residue the DP dimension sees.

    TP divides every weight across the model axis; PP gives each
    pipeline stage 1/pp of the layers.  The DP-dimension search then
    decides DP/ZDP per operator over this residue exactly as in the
    flat case.
    """
    scale = 1.0 / (tp * pp)
    if scale == 1.0:
        return desc
    ops = [dataclasses.replace(
        op, param_count=int(op.param_count * scale),
        flops_per_token=op.flops_per_token * scale,
        act_bytes_per_token=op.act_bytes_per_token * scale)
        for op in desc.operators]
    return dataclasses.replace(
        desc, operators=ops,
        resident_act_bytes_per_token=(
            desc.resident_act_bytes_per_token * scale))


def stage_bounds(n_layers: int, pp: int) -> Tuple[int, ...]:
    """GPipe stage boundaries: pp near-equal contiguous layer ranges.

    Returns pp+1 monotone layer indices; stage s owns layers
    [bounds[s], bounds[s+1]).
    """
    pp = max(1, min(pp, n_layers))
    return tuple(round(n_layers * s / pp) for s in range(pp + 1))


# ---------------------------------------------------------------------------
# TP / PP cost terms (same alpha/beta machinery as cost_model)
# ---------------------------------------------------------------------------

def activation_bytes(desc: ModelDescription, batch_local: int) -> float:
    """Bytes of one (b_local, s, d) boundary activation tensor."""
    return batch_local * desc.shape.seq_len * desc.model.d_model * ACT_BYTES


def tp_activation_time(desc: ModelDescription, device: DeviceInfo,
                       batch_local: int, tp: int,
                       cluster: Optional[ClusterSpec] = None) -> float:
    """Megatron TP activation collectives per step.

    Each layer runs a column-parallel then a row-parallel pair, i.e.
    2 all-reduces of the (b_local, s, d) activation; an all-reduce is
    a reduce-scatter + all-gather, two ring passes over the `model`
    axis (bandwidth regime — see module docstring).

    With a `cluster`, TP occupies the *innermost* `tp` devices of the
    hierarchy and the ring is priced hierarchically over the levels it
    spans — a TP group reaching past the node/pod boundary pays that
    level's (slower) links instead of the flat `ici_bw` the legacy
    path charged unconditionally.
    """
    if tp <= 1:
        return 0.0
    act = activation_bytes(desc, batch_local)
    if cluster is not None:
        _, beta = cluster.inner_span_terms(tp)
        per_allreduce = 2 * act * beta
    else:
        per_allreduce = 2 * _ring_time(act, tp, 0.0, device.ici_bw)
    return 2 * max(1, desc.model.n_layers) * per_allreduce


def pp_bubble_fraction(pp: int, micro: int) -> float:
    """GPipe pipeline bubble: (pp-1)/(m+pp-1) of the step is idle."""
    if pp <= 1:
        return 0.0
    return (pp - 1) / (micro + pp - 1)


def pp_boundary_time(desc: ModelDescription, device: DeviceInfo,
                     batch_local: int, pp: int, micro: int,
                     cluster: Optional[ClusterSpec] = None) -> float:
    """Stage-boundary activation sends: each of the `micro` microbatches
    crosses pp-1 boundaries carrying its share of the activation.

    With a `cluster`, PP is placed across the *outermost* (slowest)
    levels — pipeline traffic is point-to-point and tolerates slow
    links best — and boundary sends are priced at the bandwidth of the
    innermost level the pp-way split reaches."""
    if pp <= 1:
        return 0.0
    act = activation_bytes(desc, batch_local)
    bw = (cluster.pp_boundary_bandwidth(pp) if cluster is not None
          else device.ici_bw)
    return (pp - 1) * micro * (act / micro) / bw


def hybrid_step_time(base_time: float, desc: ModelDescription,
                     device: DeviceInfo, batch: int, f: Factorization,
                     micro: int = 8,
                     cluster: Optional[ClusterSpec] = None) -> float:
    """Step time of the full 3D configuration.

    `base_time` is the DP-dimension step time of the 1/(tp*pp) residue
    (out of `plan_cost` / the inner search); TP collectives add to it,
    then the GPipe bubble stretches the whole step and the boundary
    sends land on the critical path.

    When the boundary level declares a comm/compute overlap factor,
    each microbatch's boundary send hides under the next microbatch's
    in-flight work: per microbatch the exposed send is
    max(0, send - ov * t/micro), which totals max(0, pp_t - ov * t)
    over the step.  At overlap 0 this is exactly the serial `+= pp_t`.
    TP activation all-reduces sit on the layer critical path (each
    layer's output feeds the next) and stay serial."""
    b_local = max(1, batch // f.dp)
    t = base_time + tp_activation_time(desc, device, b_local, f.tp,
                                       cluster)
    if f.pp > 1:
        t /= (1.0 - pp_bubble_fraction(f.pp, micro))
        pp_t = pp_boundary_time(desc, device, b_local, f.pp, micro,
                                cluster)
        ov = (cluster.pp_boundary_overlap(f.pp) if cluster is not None
              else 0.0)
        t += pp_t if ov <= 0.0 else max(0.0, pp_t - ov * t)
    return t


# ---------------------------------------------------------------------------
# HybridPlan
# ---------------------------------------------------------------------------

@dataclass
class HybridPlan:
    """A 3D(+OSDP) execution plan: core.plan.Plan's hybrid sibling.

    The (dp, tp, pp) factorization and GPipe stage boundaries come out
    of `core.search.search_hybrid`; `decisions` is the per-operator
    DP/ZDP plan of the inner search over the DP dimension (the paper's
    "3D+OSDP" when that search is OSDP, plain 3D when it is forced
    ZDP).  `cost` is the hybrid-adjusted PlanCost (TP collectives +
    pipeline bubble folded into time; memory is the per-device residue
    estimate of the inner search).
    """

    desc: ModelDescription
    device: DeviceInfo
    factorization: Factorization
    stage_bounds: Tuple[int, ...]
    decisions: Dict[str, Decision]
    cost: PlanCost
    batch_size: int
    micro: int
    feasible: bool
    dp_strategy: str                    # inner solver / forced mode label
    inner: Optional[object] = None      # core.search.SearchResult
    swept: List[Tuple[Factorization, float]] = field(default_factory=list)
    # (factorization, throughput) per feasible sweep point
    cluster: Optional[ClusterSpec] = None   # topology the plan was priced on

    @property
    def dp(self) -> int:
        return self.factorization.dp

    @property
    def tp(self) -> int:
        return self.factorization.tp

    @property
    def pp(self) -> int:
        return self.factorization.pp

    def mesh_config(self) -> MeshConfig:
        return self.factorization.mesh_config()

    def stage_layers(self) -> List[Tuple[int, int]]:
        """[(first_layer, one_past_last)] per pipeline stage."""
        return [(self.stage_bounds[s], self.stage_bounds[s + 1])
                for s in range(len(self.stage_bounds) - 1)]

    def summary(self) -> str:
        n_zdp = sum(1 for d in self.decisions.values()
                    if d.uniform() not in (DP, None))
        n_mixed = sum(1 for d in self.decisions.values()
                      if d.uniform() is None)
        n_remat = count_remat_slices(self.decisions)
        remat = (f" remat_slices={n_remat}"
                 if any(d.remat is not None
                        for d in self.decisions.values()) else "")
        lines = [
            f"hybrid[{self.desc.model.name}] {self.factorization} "
            f"dp_strategy={self.dp_strategy} "
            f"batch={self.batch_size} micro={self.micro} "
            f"{'feasible' if self.feasible else 'INFEASIBLE'}",
            f"  stages: {self.stage_layers()}",
            f"  ops={len(self.decisions)} zdp={n_zdp} "
            f"mixed={n_mixed}{remat}",
            f"  est memory/device = {self.cost.memory / 2**30:.2f} GiB "
            f"(peak {self.cost.peak_memory / 2**30:.2f})",
            f"  est step time = {self.cost.time * 1e3:.2f} ms "
            f"(dp-dim comm {self.cost.comm_time * 1e3:.2f})",
            f"  est throughput = {self.cost.throughput:.0f} tok/s",
        ]
        return "\n".join(lines)
