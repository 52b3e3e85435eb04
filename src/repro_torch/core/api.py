"""User-facing OSDP API — the paper's Figure 3 one-call wrap.

FairScale:    model = FSDP(model)
OSDP (paper): model = OSDP(model, device_information)
Here:         plan  = osdp(model_cfg, shape, mesh, memory_limit=...)

returning a `Plan` whose decisions drive parameter shardings; models
built through `repro.models.registry.build_model(run, plan)` execute
it. `force_mode="ZDP"` reproduces plain FSDP, `force_mode="DP"` plain
data parallelism — the baselines the paper compares against.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Union

from repro_torch.calibrate.profile import CalibrationProfile
from repro_torch.cluster.topology import ClusterSpec
from repro_torch.configs.base import (DeviceInfo, MeshConfig, ModelConfig,
                                OSDPConfig, RunConfig, ShapeConfig,
                                SINGLE_POD_MESH)
from repro_torch.core.cost_model import (CostEnv, Decision, PlanCost,
                                   PlanEvaluator, RequestClass,
                                   RequestClassMix, ServingWorkload)
from repro_torch.core.descriptions import ModelDescription, describe
from repro_torch.core.hybrid import Factorization, HybridPlan
from repro_torch.core.plan import Plan, make_plan
from repro_torch.core.search import FleetPlan, ServePlan
from repro_torch.core import search as _search


def osdp(model: ModelConfig,
         shape: ShapeConfig,
         mesh: Optional[MeshConfig] = None,
         *,
         memory_limit_gib: float = 16.0,
         device: Optional[DeviceInfo] = None,
         search: str = "dfs",
         operator_splitting: bool = True,
         slice_granularity: int = 4,
         checkpointing: Union[bool, str] = True,
         force_mode: Optional[str] = None,
         ilp_time_budget_s: float = 0.0,
         ilp_backend: str = "auto",
         cluster: Optional["ClusterSpec"] = None,
         profile: Optional["CalibrationProfile"] = None) -> Plan:
    """Search the optimal sharded-data-parallel plan (paper Alg. 1).

    `search` picks the cover solver: "dfs" (paper Algorithm 1),
    "knapsack", "greedy", or "ilp" — the exact integer-program oracle
    (`core.ilp`); with `ilp_time_budget_s > 0` the ilp runs anytime,
    returning the incumbent plus a proven bound
    (`plan.search.lower_bound` / `.proven_optimal`), and `ilp_backend`
    forces scipy's "milp" or the dependency-free "bnb".

    `checkpointing` accepts the legacy global flags True / False, or
    "selective" to co-optimize remat per slice with the sharding mode
    (the 4-mode axis: DP/ZDP x remat/no-remat) — the returned plan's
    `Decision.remat` then carries the per-slice bits and compiles to a
    matching `jax.checkpoint` policy via `models.registry.build_model`.

    `cluster` (a `repro.cluster.ClusterSpec`) makes the search
    topology-aware: collectives are priced with hierarchical rings,
    the sharding axis widens to level-k ZDP, and heterogeneous device
    groups bound feasibility at the worst group.  Without one, the
    flat (device, mesh) model applies (mesh defaults to
    SINGLE_POD_MESH).

    `profile` (a `repro.calibrate.CalibrationProfile`, from
    `repro calibrate`) prices with measured constants — efficiency
    curve, fitted link alpha/bandwidth, fitted recompute factor;
    None keeps the scalar datasheet path byte-identical.
    """
    if mesh is None:
        mesh = (cluster.mesh_config() if cluster is not None
                else SINGLE_POD_MESH)
    cfg = OSDPConfig(
        enabled=True,
        memory_limit_bytes=memory_limit_gib * 2**30,
        search=search,
        operator_splitting=operator_splitting,
        default_slice_granularity=slice_granularity,
        checkpointing=checkpointing,
        force_mode=force_mode,
        ilp_time_budget_s=ilp_time_budget_s,
        ilp_backend=ilp_backend,
    )
    run = RunConfig(model=model, shape=shape, mesh=mesh, osdp=cfg)
    return make_plan(run, device, cluster=cluster, profile=profile)


def search_hybrid(model: Union[ModelConfig, ModelDescription],
                  shape: Optional[ShapeConfig] = None,
                  *,
                  n_devices: Optional[int] = None,
                  memory_limit_gib: float = 16.0,
                  device: Optional[DeviceInfo] = None,
                  search: str = "dfs",
                  operator_splitting: bool = True,
                  slice_granularity: int = 4,
                  checkpointing: Union[bool, str] = True,
                  force_mode: Optional[str] = None,
                  ilp_time_budget_s: float = 0.0,
                  ilp_backend: str = "auto",
                  micro: int = 8,
                  max_tp: int = 0,
                  max_pp: int = 0,
                  batch_candidates: Optional[Sequence[int]] = None,
                  candidates: Optional[Sequence[Factorization]] = None,
                  cluster: Optional[ClusterSpec] = None,
                  profile: Optional["CalibrationProfile"] = None,
                  ) -> HybridPlan:
    """Search the hybrid 3D(+OSDP) plan space (paper Fig. 5/6 rows).

    Sweeps the (dp, tp, pp) factorizations of `n_devices`; inside
    each, the DP dimension runs the OSDP Scheduler (Algorithm 1) over
    the per-device model residue — or a forced uniform mode:
    `force_mode="ZDP"` is plain DeepSpeed-style 3D, `force_mode="DP"`
    TP/PP with replicated data parallelism.  The default (no force) is
    the paper's strongest configuration, 3D+OSDP.

    `model` may be a ModelConfig (paired with `shape`) or a prebuilt
    ModelDescription (e.g. the per-layer inconsistent models of the
    paper's I&C family).

    With a `cluster`, placement is topology-aware: TP on the
    innermost levels, PP across the outermost, the DP residue searched
    over the remaining hierarchy (level-k ZDP enabled); `n_devices`
    defaults to the cluster size.
    """
    if isinstance(model, ModelDescription):
        desc = model
    else:
        if shape is None:
            raise TypeError("shape is required when model is a ModelConfig")
        desc = describe(model, shape)
    if n_devices is None:
        if cluster is None:
            raise TypeError("n_devices is required without a cluster")
        n_devices = cluster.n_devices
    cfg = OSDPConfig(
        enabled=True,
        memory_limit_bytes=memory_limit_gib * 2**30,
        search=search,
        operator_splitting=operator_splitting,
        default_slice_granularity=slice_granularity,
        allow_pod_hierarchical=cluster is not None,
        checkpointing=checkpointing,
        force_mode=force_mode,
        ilp_time_budget_s=ilp_time_budget_s,
        ilp_backend=ilp_backend,
    )
    dev = device or (cluster.device if cluster is not None
                     else DeviceInfo())
    return _search.search_hybrid(
        desc, dev, n_devices, cfg,
        batch_candidates=batch_candidates, micro=micro,
        candidates=candidates, max_tp=max_tp, max_pp=max_pp,
        cluster=cluster, profile=profile)


def search_serve(model: ModelConfig,
                 *,
                 prompt_len: int = 512,
                 decode_len: int = 128,
                 mesh: Optional[MeshConfig] = None,
                 n_devices: int = 1,
                 memory_limit_gib: float = 16.0,
                 device: Optional[DeviceInfo] = None,
                 search: str = "dfs",
                 operator_splitting: bool = True,
                 slice_granularity: int = 4,
                 force_mode: Optional[str] = None,
                 ilp_time_budget_s: float = 0.0,
                 ilp_backend: str = "auto",
                 max_slots: int = 512,
                 slot_candidates: Optional[Sequence[int]] = None,
                 cluster: Optional[ClusterSpec] = None,
                 mix: Optional[RequestClassMix] = None,
                 profile: Optional["CalibrationProfile"] = None) -> ServePlan:
    """Search the optimal serving configuration (inference OSDP).

    Same §3.1 trade as training — memory vs utilization per operator
    under the device budget — on the inference workload: the per-op
    KV/SSM caches of every admitted sequence are the dominant memory
    term, so the search jointly picks the per-slice sharding AND the
    max-concurrency admission limit that the continuous-batching
    engine (`repro.serving.engine.ContinuousEngine`) enforces.  The
    plan is scored at both phase shapes: the compute-bound prefill
    (batch x prompt_len) and the bandwidth-bound decode (batch x 1,
    floored by streaming weights + live caches from HBM).

    `mesh` defaults to an (n_devices, 1) data mesh (or the cluster's);
    `force_mode="DP"` reproduces the unplanned replicated engine,
    `force_mode="ZDP"` weight-sharded serving without the search.

    A `mix` (`RequestClassMix`) replaces (`prompt_len`, `decode_len`)
    with weighted request classes priced per class; a single-class mix
    is an exact alias of the legacy workload.
    """
    if mesh is None:
        mesh = (cluster.mesh_config() if cluster is not None
                else MeshConfig((n_devices, 1), ("data", "model")))
    cfg = OSDPConfig(
        enabled=True,
        memory_limit_bytes=memory_limit_gib * 2**30,
        search=search,
        operator_splitting=operator_splitting,
        default_slice_granularity=slice_granularity,
        checkpointing=False,
        force_mode=force_mode,
        ilp_time_budget_s=ilp_time_budget_s,
        ilp_backend=ilp_backend,
    )
    env = CostEnv(device or (cluster.device if cluster is not None
                             else DeviceInfo()),
                  mesh, checkpointing=False, train=False, cluster=cluster,
                  profile=profile)
    workload = (mix if mix is not None
                else ServingWorkload(prompt_len, decode_len))
    return _search.search_serve(
        model, workload, env, cfg,
        max_slots=max_slots, slot_candidates=slot_candidates)


def search_fleet(model: ModelConfig,
                 *,
                 mix: Optional[RequestClassMix] = None,
                 classes: Optional[Sequence[RequestClass]] = None,
                 cluster: Optional[ClusterSpec] = None,
                 n_devices: int = 1,
                 memory_limit_gib: float = 16.0,
                 device: Optional[DeviceInfo] = None,
                 search: str = "dfs",
                 operator_splitting: bool = True,
                 slice_granularity: int = 4,
                 force_mode: Optional[str] = None,
                 max_slots: int = 512,
                 replica_candidates: Optional[Sequence[int]] = None,
                 strategy: str = "slo") -> FleetPlan:
    """Search a fleet-scale serving configuration (multi-replica OSDP).

    Partitions the `cluster` (one pool per heterogeneous
    `DeviceGroup`, else the whole fleet) into independent replica
    groups and searches replica count x per-group sharding plan x
    per-class routing jointly, returning a `FleetPlan`: per-group
    `ServePlan`s, a class -> group routing table, and per-class
    admission limits the class-aware router enforces.

    The workload is a `RequestClassMix` (pass `mix`, or `classes` as a
    sequence of `RequestClass`); `strategy="uniform"` is the
    heterogeneity-blind baseline (identical replicas, every class
    routed everywhere) the fleet benchmark compares against."""
    if mix is None:
        if not classes:
            raise TypeError("search_fleet needs mix= or classes=")
        mix = RequestClassMix(tuple(classes))
    elif classes:
        raise TypeError("pass mix= or classes=, not both")
    if cluster is None:
        cluster = ClusterSpec.from_device(device or DeviceInfo(),
                                          n_devices)
    cfg = OSDPConfig(
        enabled=True,
        memory_limit_bytes=memory_limit_gib * 2**30,
        search=search,
        operator_splitting=operator_splitting,
        default_slice_granularity=slice_granularity,
        checkpointing=False,
        force_mode=force_mode,
    )
    return _search.search_fleet(
        model, mix, cluster, cfg, max_slots=max_slots,
        replica_candidates=replica_candidates, strategy=strategy)


def rescore_serve(model: ModelConfig, plan: ServePlan,
                  *,
                  slots: Optional[int] = None,
                  mesh: Optional[MeshConfig] = None,
                  n_devices: int = 1,
                  memory_limit_gib: float = 16.0,
                  device: Optional[DeviceInfo] = None,
                  cluster: Optional[ClusterSpec] = None):
    """Re-score an existing `ServePlan` on a different cluster:
    (ServingCost, feasible).

    The resilience supervisor's first question after a device loss —
    "does the stale plan still fit the survivors?" — answered with the
    analytical cost model only (no search).  Pass the degraded
    `cluster` (from `ClusterSpec.degrade`); the memory limit tightens
    to the surviving worst group and the collective terms re-price on
    the shrunken topology."""
    if mesh is None:
        mesh = (cluster.mesh_config() if cluster is not None
                else MeshConfig((n_devices, 1), ("data", "model")))
    cfg = OSDPConfig(
        enabled=True,
        memory_limit_bytes=memory_limit_gib * 2**30,
        checkpointing=False,
    )
    env = CostEnv(device or (cluster.device if cluster is not None
                             else DeviceInfo()),
                  mesh, checkpointing=False, train=False, cluster=cluster)
    return _search.rescore_serve_plan(
        model, plan.workload, plan.decisions, env, cfg,
        plan.slots_per_device if slots is None else slots)


def evaluate_plan(model: Union[ModelConfig, ModelDescription],
                  decisions: Dict[str, Decision],
                  shape: Optional[ShapeConfig] = None,
                  mesh: Optional[MeshConfig] = SINGLE_POD_MESH,
                  *,
                  global_batch: Optional[int] = None,
                  device: Optional[DeviceInfo] = None,
                  checkpointing: bool = True,
                  train: bool = True,
                  cluster: Optional[ClusterSpec] = None,
                  profile: Optional["CalibrationProfile"] = None) -> PlanCost:
    """Score an explicit plan through the vectorized PlanEvaluator.

    Same result as `cost_model.plan_cost` (to float-summation order),
    but table-driven: callers scoring many plans against one
    (model, mesh) — schedulers, what-if tooling, external autotuners —
    should hold a `PlanEvaluator` directly; this one-call wrap is for
    one-off scoring.
    """
    if not isinstance(checkpointing, bool):
        raise ValueError(
            "evaluate_plan scores a FIXED plan, so checkpointing must "
            "be the global bool default for inherit slices — encode "
            "selective remat in the decisions' Decision.remat bits")
    if isinstance(model, ModelDescription):
        desc = model
    else:
        if shape is None:
            raise TypeError("shape is required when model is a ModelConfig")
        desc = describe(model, shape)
    if cluster is not None and mesh is SINGLE_POD_MESH:
        mesh = None          # derive the mesh from the cluster spec
    env = CostEnv(device or (cluster.device if cluster is not None
                             else DeviceInfo()), mesh,
                  checkpointing=checkpointing, train=train,
                  cluster=cluster, profile=profile)
    ev = PlanEvaluator.for_decisions(desc, env, decisions)
    modes = ev.modes_from_decisions(decisions)
    return ev.plan_cost(modes, global_batch or desc.shape.global_batch)


def fsdp_baseline(model: ModelConfig, shape: ShapeConfig,
                  mesh: MeshConfig = SINGLE_POD_MESH, **kw) -> Plan:
    """All-ZDP: the FairScale/DeepSpeed ZeRO-3 baseline."""
    return osdp(model, shape, mesh, force_mode="ZDP", **kw)


def dp_baseline(model: ModelConfig, shape: ShapeConfig,
                mesh: MeshConfig = SINGLE_POD_MESH, **kw) -> Plan:
    """All-DP: the PyTorch-DDP baseline."""
    return osdp(model, shape, mesh, force_mode="DP", **kw)
