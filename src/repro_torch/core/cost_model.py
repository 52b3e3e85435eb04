"""OSDP cost model — the paper's §3.1 Profiler, on TPU constants.

Memory:
    M_i(p_i, b) = M_model_i / (1 or N_shard) + b * M_act_i + M_extra_i

Time ((alpha, beta, gamma) model, ring collectives):
    T_i(p_i, b) = k (N-1)(alpha + S_i beta / N) + b * gamma_i
with k = 2 for DP (all-reduce = reduce-scatter + all-gather) and
k = 3 for ZDP (two all-gathers + one reduce-scatter); +1 for ZDP when
activation checkpointing forces a third parameter gather before the
recompute pass (§4.3).

Activation checkpointing (remat) is a per-slice decision, not only a
global switch: a `Decision` may carry explicit remat bits per slice
(the 4-mode axis, DP/ZDP x remat/no-remat).  A remat'd slice trades
its live activations (b * M_act_i -> /remat_layers) for the ~30%
recompute compute term and — in ZDP modes — the §4.3 4th parameter
gather; a no-remat slice keeps its activations and skips both costs.
`Decision.remat is None` reproduces the legacy global behaviour of
`CostEnv.checkpointing` byte-for-byte.  The full formula set lives in
docs/cost_model.md.

Beyond-paper additions, all flagged explicitly:
  * ZDP_POD — hierarchical sharding across only the in-pod `data` axis:
    memory /N_pod-local, collectives stay on fast ICI.
  * per-mode gathered-weight peak (M_extra): in ZDP the un-sharded
    weight must transiently exist; operator splitting divides it by g.
  * MoE awareness: expert FLOPs scale with top-k, not E.
  * per-slice selective remat (this module + core/search.py), above.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import cached_property
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.calibrate.profile import CalibrationProfile
from repro_torch.configs.base import DeviceInfo, MeshConfig
from repro_torch.cluster.topology import ClusterSpec
from repro_torch.core.descriptions import (ACT_BYTES, BYTES_PER_PARAM,
                                     ModelDescription, OperatorDesc,
                                     STATE_BYTES_PER_PARAM)

# parallel modes -------------------------------------------------------------
#
# Sharding generalizes to "ZDP at level k" of a hierarchical
# `ClusterSpec` (see repro.cluster.topology): shard model states across
# the innermost k levels, gather over that span with a hierarchical
# ring, all-reduce grads across the rest.  The legacy triple below is
# the depth-2 case (ZDP = full span, ZDP_POD = level 1); deeper specs
# add "ZDP@k" modes.  The authoritative per-env mode list is
# `CostEnv.topo.mode_names`.
DP = "DP"
ZDP = "ZDP"
ZDP_POD = "ZDP_POD"      # beyond-paper hierarchical mode (level 1 of 2)
MODES = (DP, ZDP, ZDP_POD)

# per-slice remat states (the second axis of the 4-mode decision space)
REMAT_INHERIT = 0        # follow CostEnv.checkpointing (legacy global flag)
REMAT_OFF = 1            # explicit: keep activations, no recompute
REMAT_ON = 2             # explicit: rematerialize this slice (§4.3 terms)
N_REMAT_STATES = 3
# PlanEvaluator extended column: e = mode_index + len(MODES) * remat_state
N_EXT = len(MODES) * N_REMAT_STATES


@dataclass(frozen=True)
class Decision:
    """Plan entry for one operator: per-slice modes (+ remat bits).

    `modes` has length 1 for unsplit operators, length g for split ones
    (paper §3.3: each slice is independently DP or ZDP).  `remat` is
    the second decision axis: None means every slice inherits the
    legacy global `CostEnv.checkpointing` flag; otherwise it holds one
    entry per slice — True (rematerialize), False (keep activations),
    or None (inherit) — the searched selective-remat plan.
    """

    op: str
    modes: Tuple[str, ...]
    remat: Optional[Tuple[Optional[bool], ...]] = None

    def __post_init__(self):
        if self.remat is not None and len(self.remat) != len(self.modes):
            raise ValueError(
                f"{self.op}: remat length {len(self.remat)} != "
                f"modes length {len(self.modes)}")

    @property
    def split(self) -> int:
        return len(self.modes)

    def uniform(self) -> Optional[str]:
        return self.modes[0] if len(set(self.modes)) == 1 else None

    def remat_states(self) -> Tuple[int, ...]:
        """Per-slice REMAT_* state (0 inherit / 1 off / 2 on)."""
        if self.remat is None:
            return (REMAT_INHERIT,) * self.split
        return tuple(REMAT_INHERIT if r is None
                     else (REMAT_ON if r else REMAT_OFF)
                     for r in self.remat)

    def remat_bits(self, default: bool) -> Tuple[bool, ...]:
        """Per-slice effective remat with inherits resolved to `default`."""
        if self.remat is None:
            return (bool(default),) * self.split
        return tuple(bool(default) if r is None else bool(r)
                     for r in self.remat)

    def uniform_remat(self) -> Optional[bool]:
        """The single explicit remat bit if uniform-explicit, else None."""
        if self.remat is None or None in self.remat:
            return None
        vals = {bool(r) for r in self.remat}
        return vals.pop() if len(vals) == 1 else None


@dataclass(frozen=True)
class CostEnv:
    """Everything the Profiler needs besides the plan.

    `cluster` is the hierarchical device information for the
    data-parallel extent; when absent it is derived from the flat
    (device, mesh) pair via the depth-2 adapter
    `ClusterSpec.from_flat` — on single-pod meshes every price then
    collapses to the legacy flat-ring formulas exactly.  When a
    `cluster` is given, `mesh` may be None (derived from the spec).
    """

    device: DeviceInfo
    mesh: Optional[MeshConfig] = None
    checkpointing: bool = True
    # TP already divides each operator's params across the model axis;
    # OSDP decides the data-axis story for the per-TP-shard residue.
    include_tp: bool = True
    # training = fwd + bwd (2x fwd) compute; False for serving estimates
    train: bool = True
    cluster: Optional[ClusterSpec] = None
    # measured constants (repro calibrate): an efficiency curve in
    # place of the scalar mxu_efficiency, fitted per-level alpha/bw in
    # place of the datasheet link constants, a fitted recompute factor
    # in place of the literal 1.30.  None keeps the legacy scalar path
    # byte-identical — every committed golden is pinned on it.
    profile: Optional["CalibrationProfile"] = None

    def __post_init__(self):
        if self.mesh is None:
            if self.cluster is None:
                raise ValueError("CostEnv needs a mesh or a cluster")
            object.__setattr__(self, "mesh",
                               self.cluster.mesh_config())

    @cached_property
    def topo(self) -> ClusterSpec:
        """The hierarchical cluster spec all collectives are priced
        against (the explicit `cluster`, else the depth-2 adapter),
        with fitted link constants substituted when a calibration
        profile carries any."""
        spec = (self.cluster if self.cluster is not None
                else ClusterSpec.from_flat(self.device, self.mesh))
        if self.profile is not None and self.profile.links:
            spec = spec.with_links(self.profile.links)
        return spec

    @property
    def n_data(self) -> int:
        return self.topo.n_devices              # full data extent

    @property
    def n_data_local(self) -> int:
        return self.topo.span_ways(1)           # innermost level

    @property
    def n_tp(self) -> int:
        return self.mesh.model_parallel if self.include_tp else 1

    @property
    def peak_compute(self) -> float:
        """FLOP/s the step can sustain: the slowest device group's
        peak (uniform clusters: the device's), derated by efficiency.
        This is the scalar (uncalibrated) derating; operator pricing
        goes through `op_peak_compute` so a fitted curve can resolve
        it per size."""
        return self.topo.effective_peak_flops * self.device.mxu_efficiency

    def op_peak_compute(self, op_work: float) -> float:
        """Sustained FLOP/s for one operator.  Without a profile this
        is exactly `peak_compute` (legacy scalar path, byte-identical).
        With one, the fitted curve is consulted at `op_work` — the
        operator's per-TP-shard flops for ONE batch element
        (`flops_per_token * seq / tp`), the batch-independent proxy
        for its matmul size, so the PlanEvaluator's batch-linear
        compute slopes survive calibration unchanged."""
        if self.profile is None:
            return self.peak_compute
        frac = self.profile.efficiency.at(op_work)
        return self.topo.effective_peak_flops * frac

    @property
    def remat_factor(self) -> float:
        """Recompute multiplier on checkpointed compute: the model's
        hand-set 1.30 (§4.3) unless a profile fitted one."""
        return 1.30 if self.profile is None else self.profile.remat_factor

    @property
    def remat_compute_delta(self) -> float:
        """The *extra* compute fraction remat adds (`remat_factor - 1`).
        Kept as the literal 0.30 on the uncalibrated path: in floats
        `1.30 - 1.0` is one ulp off 0.30 and the committed goldens pin
        the literal."""
        if self.profile is None:
            return 0.30
        return self.profile.remat_factor - 1.0

    @cached_property
    def overlaps(self) -> Tuple[float, ...]:
        """Per-level comm/compute overlap factors (innermost-first)."""
        return self.topo.overlaps

    @cached_property
    def has_overlap(self) -> bool:
        """True when any level hides comm under compute.  Every scalar
        price below keeps its exact legacy float order when this is
        False — the committed goldens are all pinned at overlap 0."""
        return self.topo.has_overlap


def shard_ways(mode: str, env: CostEnv) -> float:
    """State divisor of a sharding mode (1 for DP; the spanned device
    count for level-k ZDP; capacity-weighted for full-span ZDP on a
    heterogeneous cluster)."""
    return env.topo.shard_ways(mode)


def _ring_time(bytes_total: float, n: int, alpha: float, bw: float) -> float:
    """One ring all-gather / reduce-scatter over n ranks."""
    if n <= 1:
        return 0.0
    return (n - 1) * (alpha + bytes_total / n / bw)


def _rings_pass(nbytes: float, rings, n_span: int,
                alpha_scale: float = 1.0) -> float:
    """One hierarchical ring pass over a span: the sum of per-level
    `_ring_time`-shaped terms from `ClusterSpec.span_rings` (kept in
    the exact floating-point shape of the legacy flat formula, so a
    single-ring span prices bit-identically to `_ring_time`)."""
    t = 0.0
    for w, alpha, bw, prefix in rings:
        b = nbytes if prefix == 1 else nbytes * prefix
        t += (w - 1) * (alpha * alpha_scale + b / n_span / bw)
    return t


def _rings_pass_b(nbytes: float, rings, ring_levels, n_span: int,
                  buckets: List[float], scale: float,
                  alpha_scale: float = 1.0) -> float:
    """`_rings_pass` that also accumulates each ring's seconds (times
    `scale`, the caller's round multiplier) into the per-level
    `buckets` — the network-resource timeline the overlap model
    consumes.  The returned scalar is term-for-term identical to
    `_rings_pass`, so callers keep the legacy float shape by applying
    `scale` outside as before."""
    t = 0.0
    for (w, alpha, bw, prefix), li in zip(rings, ring_levels):
        b = nbytes if prefix == 1 else nbytes * prefix
        term = (w - 1) * (alpha * alpha_scale + b / n_span / bw)
        t += term
        buckets[li] += scale * term
    return t


def exposed_step_time(compute: float, comm_by_level, overlaps) -> float:
    """Two-resource (compute, network) timeline combine.

    `comm_by_level[l]` is the network time the step spends on level l's
    links; `overlaps[l]` is the fraction of the step's compute that
    level's collectives can hide behind (prefetched gathers, async
    all-reduce).  Each level exposes only what does not fit under the
    compute window:

        T = T_comp + sum_l max(0, T_net_l - overlap_l * T_comp)

    Properties the planner relies on: at overlap 0 this is the serial
    sum; it is non-increasing in every overlap factor; and it never
    drops below max(T_comp, any single level's residual) — levels are
    optimistically hidden independently, which upper-bounds what a real
    scheduler can do and is exact when one level dominates."""
    t = compute
    for c, ov in zip(comm_by_level, overlaps):
        if c <= 0.0:
            continue
        t += c if ov <= 0.0 else max(0.0, c - ov * compute)
    return t


@dataclass
class OpCost:
    memory: float          # steady per-device bytes for this op's states
    peak_extra: float      # transient gathered-weight bytes
    time: float            # seconds per step (comm + compute, serial)
    comm_time: float
    compute_time: float
    comm_by_level: Tuple[float, ...] = ()   # comm_time split by level


def op_cost(op: OperatorDesc, decision: Decision, batch_per_device: int,
            seq_len: int, env: CostEnv) -> OpCost:
    """Cost of one operator under `decision` (§3.1 equations + per-slice
    remat, §4.3).  Decisions without explicit remat bits take the exact
    legacy code path (byte-identical to the global-flag Profiler)."""
    if decision.remat is not None and any(r is not None
                                          for r in decision.remat):
        return _op_cost_per_slice(op, decision, batch_per_device, seq_len,
                                  env)
    g = decision.split
    topo = env.topo
    tp = env.n_tp
    # per-TP-shard sizes; OSDP reasons about the per-device residue
    # training holds optimizer states; serving only the bf16 weights
    state_bytes = (op.state_bytes if env.train else op.param_bytes) / tp
    param_bytes = op.param_bytes / tp
    tokens = batch_per_device * seq_len
    act = op.act_bytes_per_token / tp * tokens
    if env.checkpointing:
        # activations inside a layer are rematerialized: only one layer's
        # working set is live (the layer-boundary checkpoints are counted
        # once in ModelDescription.resident_act_bytes_per_token)
        act /= max(1, op.layers)
    compute = op.flops_per_token * tokens / tp \
        / env.op_peak_compute(op.flops_per_token * seq_len / tp)
    if env.train:
        compute *= 3.0            # fwd + bwd (2x fwd)
    if env.checkpointing:
        compute *= env.remat_factor   # ~30% recompute overhead (fitted
        #                               when a calibration profile is on)

    # merge adjacent same-mode slices: the implementation stores them as
    # one array -> one collective (sharding.specs._merge_modes), so the
    # cost model must too, or uniform split plans would be over-charged
    # (N-1) alpha per slice.
    runs: List[Tuple[str, int]] = []
    for mode in decision.modes:
        if runs and runs[-1][0] == mode:
            runs[-1] = (mode, runs[-1][1] + 1)
        else:
            runs.append((mode, 1))

    full_rings = topo.gather_rings(topo.depth)
    full_lv = topo.gather_ring_levels(topo.depth)
    n_full = topo.span_ways(topo.depth)
    mem = 0.0
    peak = 0.0
    comm = 0.0
    comm_lv = [0.0] * topo.depth    # network seconds bucketed by level
    for mode, run_len in runs:
        s_bytes = state_bytes * run_len / g
        p_bytes = param_bytes * run_len / g
        k = topo.mode_span(mode)
        mem += s_bytes / topo.shard_ways(mode)
        if k == 0:               # DP
            # grads all-reduced over the full data extent (training
            # only): one hierarchical ring per reduce/gather pass
            if env.train:
                comm += 2 * _rings_pass_b(p_bytes, full_rings, full_lv,
                                          n_full, comm_lv, 2.0)
        else:
            if env.train:
                rounds = 3 + (1 if env.checkpointing else 0)
            else:
                rounds = 1    # serving: one forward gather, no grad sync
            # splitting processes the run's slices sequentially: one
            # collective per slice -> alpha charged run_len times, beta
            # on the total bytes (matches chunked execution).
            n_k = topo.span_ways(k)
            comm += rounds * _rings_pass_b(p_bytes, topo.gather_rings(k),
                                           topo.gather_ring_levels(k),
                                           n_k, comm_lv, float(rounds),
                                           run_len)
            if k < topo.depth:
                # grads of the level-k shard all-reduced across the
                # outer (replicated) extent
                comm += 2 * _rings_pass_b(p_bytes / n_k,
                                          topo.outer_rings(k),
                                          topo.outer_ring_levels(k),
                                          n_full // n_k, comm_lv, 2.0)
            # M_extra (paper §3.1/§3.3): the gathered slice is transient
            # but counted additively per op, at the granularity actually
            # gathered — one layer's slice (scan gathers per layer).
            gathered = param_bytes / (max(1, op.layers) * g)
            mem += gathered
            peak = max(peak, gathered)
    return OpCost(memory=mem + act, peak_extra=peak, time=comm + compute,
                  comm_time=comm, compute_time=compute,
                  comm_by_level=tuple(comm_lv))


def _op_cost_per_slice(op: OperatorDesc, decision: Decision,
                       batch_per_device: int, seq_len: int,
                       env: CostEnv) -> OpCost:
    """op_cost for decisions carrying explicit per-slice remat bits.

    Sharding runs still merge by mode only (storage = sharding; remat
    re-gathers, it does not re-segment the arrays), so the state memory,
    M_extra, and base collectives match the legacy path.  Per slice:

      * remat ON  — activations / eff_remat_layers live, compute x1.30,
        and (ZDP modes, training) one extra ring gather over the slice
        before the recompute pass (§4.3's 4th gather);
      * remat OFF — full activations live, no recompute, 3 ZDP rounds;
      * inherit   — the legacy CostEnv.checkpointing scaling.
    """
    g = decision.split
    topo = env.topo
    tp = env.n_tp
    state_bytes = (op.state_bytes if env.train else op.param_bytes) / tp
    param_bytes = op.param_bytes / tp
    tokens = batch_per_device * seq_len
    act_slice = op.act_bytes_per_token / tp * tokens / g
    comp_slice = (op.flops_per_token * tokens / tp
                  / env.op_peak_compute(op.flops_per_token * seq_len
                                        / tp)) / g
    if env.train:
        comp_slice *= 3.0
    rl = op.eff_remat_layers
    states = decision.remat_states()
    bits = decision.remat_bits(env.checkpointing)
    rf = env.remat_factor

    act = compute = 0.0
    for st, r in zip(states, bits):
        if st == REMAT_INHERIT:
            act += act_slice / (max(1, op.layers)
                                if env.checkpointing else 1)
        elif r:
            act += act_slice / rl
        else:
            act += act_slice
        compute += comp_slice * (rf if r else 1.0)

    runs: List[Tuple[str, List[int]]] = []
    for j, mode in enumerate(decision.modes):
        if runs and runs[-1][0] == mode:
            runs[-1][1].append(j)
        else:
            runs.append((mode, [j]))

    mem = 0.0
    peak = 0.0
    comm = 0.0
    comm_lv = [0.0] * topo.depth
    for mode, idxs in runs:
        run_len = len(idxs)
        s_bytes = state_bytes * run_len / g
        p_bytes = param_bytes * run_len / g
        k = topo.mode_span(mode)
        mem += s_bytes / topo.shard_ways(mode)
        if k == 0:               # DP
            if env.train:
                comm += 2 * _rings_pass_b(
                    p_bytes, topo.gather_rings(topo.depth),
                    topo.gather_ring_levels(topo.depth),
                    topo.span_ways(topo.depth), comm_lv, 2.0)
            continue
        base_rounds = 3 if env.train else 1
        # maximal remat sub-runs within the sharding run: the §4.3
        # recompute gather re-fetches exactly the remat'd slices
        subs: List[int] = []
        cur = 0
        for j in idxs:
            if env.train and bits[j]:
                cur += 1
            else:
                if cur:
                    subs.append(cur)
                cur = 0
        if cur:
            subs.append(cur)
        n_k = topo.span_ways(k)
        grings = topo.gather_rings(k)
        glv = topo.gather_ring_levels(k)
        comm += base_rounds * _rings_pass_b(p_bytes, grings, glv, n_k,
                                            comm_lv, float(base_rounds),
                                            run_len)
        for sl in subs:
            comm += _rings_pass_b(param_bytes * sl / g, grings, glv, n_k,
                                  comm_lv, 1.0, sl)
        if k < topo.depth:       # cross-outer grad all-reduce
            comm += 2 * _rings_pass_b(p_bytes / n_k, topo.outer_rings(k),
                                      topo.outer_ring_levels(k),
                                      topo.span_ways(topo.depth) // n_k,
                                      comm_lv, 2.0)
        gathered = param_bytes / (max(1, op.layers) * g)
        mem += gathered
        peak = max(peak, gathered)
    return OpCost(memory=mem + act, peak_extra=peak, time=comm + compute,
                  comm_time=comm, compute_time=compute,
                  comm_by_level=tuple(comm_lv))


@dataclass
class PlanCost:
    memory: float        # steady per-device bytes
    peak_memory: float   # steady + worst transient gather
    time: float          # seconds per step (timeline-combined when the
                         # env's topology declares overlap, serial else)
    comm_time: float     # total network seconds (resource time, not
                         # necessarily exposed on the critical path)
    compute_time: float
    throughput: float    # tokens / s (global)
    comm_by_level: Tuple[float, ...] = ()   # comm_time split by level


def plan_cost(desc: ModelDescription, decisions: Dict[str, Decision],
              global_batch: int, env: CostEnv) -> PlanCost:
    """The paper's T(p, b), M(p, b) over the whole operator list.

    With per-level overlap factors on the env's topology, step time is
    the two-resource timeline `exposed_step_time` instead of the serial
    comm+compute sum; at overlap 0 the serial accumulation below is
    kept untouched (byte-identical to the committed goldens)."""
    bpd = max(1, global_batch // env.n_data)
    seq = desc.shape.seq_len
    mem = desc.resident_act_bytes_per_token * bpd * seq / env.n_tp
    peak = 0.0
    time = comm = compute = 0.0
    comm_lv = [0.0] * env.topo.depth
    for op in desc.operators:
        dec = decisions.get(op.name)
        if dec is None:
            dec = Decision(op.name, (DP,))
        c = op_cost(op, dec, bpd, seq, env)
        mem += c.memory
        peak = max(peak, c.peak_extra)
        time += c.time
        comm += c.comm_time
        compute += c.compute_time
        for li, x in enumerate(c.comm_by_level):
            comm_lv[li] += x
    if env.has_overlap:
        time = exposed_step_time(compute, comm_lv, env.overlaps)
    tokens = global_batch * seq
    return PlanCost(memory=mem, peak_memory=mem + peak, time=time,
                    comm_time=comm, compute_time=compute,
                    throughput=tokens / time if time > 0 else 0.0,
                    comm_by_level=tuple(comm_lv))


# ---------------------------------------------------------------------------
# PlanEvaluator: incremental, vectorized Profiler
# ---------------------------------------------------------------------------

class PlanEvaluator:
    """Table-driven plan evaluation with O(1) per-slice delta updates.

    ``plan_cost`` walks every operator in Python and re-derives each
    run's collective terms from scratch — fine for scoring one plan,
    quadratic when a search evaluates thousands of neighbouring plans
    (the repair loop flips one slice at a time, the Scheduler re-scores
    per batch candidate).  This class precomputes, once per
    (description, env, slice layout):

      * per-slice, per-extended-mode additive terms — sharded state
        bytes and the run-length-linear part of the collective time
        (ZDP's per-slice ``alpha`` and everyone's beta term scale with
        run length, so they distribute exactly over slices),
      * per-op, per-sharding-mode *run* constants — the terms
        ``op_cost`` charges once per merged same-sharding run: the
        transiently gathered slice (M_extra) for ZDP runs, the
        2(N-1)·alpha grad-all-reduce latency for DP runs, the cross-pod
        alpha for ZDP_POD.  Remat never re-segments storage, so run
        boundaries depend on the sharding mode only,
      * per-slice batch slopes — activation and compute scale linearly
        with the per-device batch AND with each slice's remat state, so
        changing the batch re-uses every table.

    Slices address an *extended* mode ``e = mode + 3 * remat_state``
    with remat_state in {REMAT_INHERIT, REMAT_OFF, REMAT_ON}: columns
    0..2 are the legacy global-flag semantics (byte-compatible with the
    pre-selective-remat engine), 3..5 force activations kept, 6..8
    force rematerialization (recompute x1.30 + the §4.3 4th gather in
    ZDP modes, activations / eff_remat_layers).

    A full plan evaluation is then a vectorized table gather, and
    flipping one slice's extended mode only touches that slice's
    additive terms plus (when the sharding part changes) the run
    boundaries next to it: an O(1) update (``begin`` / ``flip``).
    Results match ``plan_cost`` to float-summation-order (~1e-12
    relative; asserted at 1e-9 by tests/test_plan_evaluator.py).

    Slice layout: every operator contributes ``granularity[op.name]``
    slices (default 1 — ``plan_cost``'s layout for missing decisions).
    """

    def __init__(self, desc: ModelDescription, env: CostEnv,
                 granularity: Optional[Dict[str, int]] = None):
        self.desc = desc
        self.env = env
        gran = granularity or {}
        topo = env.topo
        tp = env.n_tp
        seq = desc.shape.seq_len
        # dynamic sharding-mode list: DP, full ZDP, then one column per
        # intermediate hierarchy level (depth-2 specs keep the legacy
        # (DP, ZDP, ZDP_POD) layout -> N_EXT == 9, byte-compatible)
        self.modes: Tuple[str, ...] = topo.mode_names
        self.n_modes = len(self.modes)
        self.n_ext = self.n_modes * N_REMAT_STATES
        self.mode_index = {m: i for i, m in enumerate(self.modes)}
        n_m = self.n_modes
        # ZDP gather rounds per remat state: inherit follows the env
        # flag; explicit off/on pin 3 / 4 (§4.3); serving gathers once
        if env.train:
            rounds = (3 + (1 if env.checkpointing else 0), 3, 4)
        else:
            rounds = (1, 1, 1)

        ops = desc.operators
        self.n_ops = len(ops)
        self.op_names = [op.name for op in ops]
        self.granularity = np.array(
            [max(1, gran.get(op.name, 1)) for op in ops], dtype=np.int64)
        self.op_start = np.zeros(self.n_ops, dtype=np.int64)
        np.cumsum(self.granularity[:-1], out=self.op_start[1:])
        self.n_slices = int(self.granularity.sum())
        self.slice_op = np.repeat(np.arange(self.n_ops), self.granularity)

        g = self.granularity.astype(np.float64)
        state_b = np.array(
            [(op.state_bytes if env.train else op.param_bytes) / tp
             for op in ops])
        param_b = np.array([op.param_bytes / tp for op in ops])
        layers = np.array([max(1, op.layers) for op in ops],
                          dtype=np.float64)
        remat_layers = np.array([op.eff_remat_layers for op in ops],
                                dtype=np.float64)
        self.gathered = param_b / (layers * g)       # per non-DP run M_extra

        # per-slice batch slopes per remat state (per unit of
        # per-device batch); independent of the sharding mode
        self._resident_slope = desc.resident_act_bytes_per_token * seq / tp
        act = np.array([op.act_bytes_per_token / tp for op in ops]) \
            * seq / g
        act_states = np.stack(
            [act / layers if env.checkpointing else act,   # inherit
             act,                                          # explicit off
             act / remat_layers], axis=1)                  # explicit on
        # per-op sustained peak: the scalar derating, or the fitted
        # curve at each op's size (elementwise divide keeps the legacy
        # float order bit-identical when every entry is the scalar)
        op_peak = np.array([env.op_peak_compute(op.flops_per_token
                                                * seq / tp)
                            for op in ops])
        comp = np.array([op.flops_per_token for op in ops]) * seq / tp \
            / op_peak / g
        if env.train:
            comp = comp * 3.0
        rf = env.remat_factor
        comp_states = np.stack(
            [comp * rf if env.checkpointing else comp,
             comp,
             comp * rf], axis=1)

        # per-op per-extended-mode tables; e = mode + n_modes * state.
        # Collective prices iterate the spec's per-level rings in the
        # exact floating-point shape of the legacy flat formula
        # (bit-identical on depth-2 single-pod adapters).
        #
        # When the topology declares overlap, the same terms are also
        # bucketed per hierarchy level (`*_lv` tables, one extra trailing
        # depth axis) so the timeline combine can expose each level's
        # residual independently; at overlap 0 the tables are skipped
        # and every price below is the untouched legacy scalar.
        self.depth = topo.depth
        self.overlaps = np.array(topo.overlaps)
        self.has_overlap = topo.has_overlap
        mem_op = np.zeros((self.n_ops, n_m))
        comm_op = np.zeros((self.n_ops, self.n_ext))     # per-slice additive
        self.mem_run = np.zeros((self.n_ops, n_m))
        self.comm_run = np.zeros((self.n_ops, n_m))
        comm_op_lv = (np.zeros((self.n_ops, self.n_ext, self.depth))
                      if self.has_overlap else None)
        self.comm_run_lv = (np.zeros((self.n_ops, n_m, self.depth))
                            if self.has_overlap else None)
        sliced = param_b / g                              # per-slice bytes
        n_full = topo.span_ways(topo.depth)
        # DP: states replicated; grads all-reduced hierarchically over
        # the full data extent (training only): alpha once per run,
        # beta per slice; remat does not change DP collectives
        mem_op[:, 0] = state_b / g
        if env.train:
            for (w, alpha, bw, prefix), li in zip(
                    topo.gather_rings(topo.depth),
                    topo.gather_ring_levels(topo.depth)):
                b = sliced if prefix == 1 else sliced * prefix
                dp_beta = 2 * (w - 1) * (b / n_full / bw)
                for st in range(N_REMAT_STATES):
                    comm_op[:, 0 + n_m * st] += dp_beta
                    if comm_op_lv is not None:
                        comm_op_lv[:, 0 + n_m * st, li] += dp_beta
                self.comm_run[:, 0] += 2 * (w - 1) * alpha
                if self.comm_run_lv is not None:
                    self.comm_run_lv[:, 0, li] += 2 * (w - 1) * alpha
        # level-k ZDP columns (ZDP = full span): hierarchical gather
        # over the innermost k levels — alpha scales with run length
        # (chunked execution), so it is fully per-slice, including the
        # remat-state-dependent 4th gather; the cross-outer grad
        # all-reduce is remat-independent (beta per slice, alpha once
        # per run)
        for mi in range(1, n_m):
            mode = self.modes[mi]
            k = topo.mode_span(mode)
            n_k = topo.span_ways(k)
            mem_op[:, mi] = state_b / g / topo.shard_ways(mode)
            for (w, alpha, bw, prefix), li in zip(
                    topo.gather_rings(k), topo.gather_ring_levels(k)):
                b = sliced if prefix == 1 else sliced * prefix
                for st in range(N_REMAT_STATES):
                    term = rounds[st] * (w - 1) * (alpha + b / n_k / bw)
                    comm_op[:, mi + n_m * st] += term
                    if comm_op_lv is not None:
                        comm_op_lv[:, mi + n_m * st, li] += term
            if k < topo.depth:
                shard = sliced / n_k
                n_outer = n_full // n_k
                for (w, alpha, bw, prefix), li in zip(
                        topo.outer_rings(k), topo.outer_ring_levels(k)):
                    b = shard if prefix == 1 else shard * prefix
                    xout = 2 * (w - 1) * (b / n_outer / bw)
                    for st in range(N_REMAT_STATES):
                        comm_op[:, mi + n_m * st] += xout
                        if comm_op_lv is not None:
                            comm_op_lv[:, mi + n_m * st, li] += xout
                    self.comm_run[:, mi] += 2 * (w - 1) * alpha
                    if self.comm_run_lv is not None:
                        self.comm_run_lv[:, mi, li] += 2 * (w - 1) * alpha
            self.mem_run[:, mi] = self.gathered
        # tile/repeat op tables into (n_slices, n_ext): state-
        # independent mem cycles over modes; act/comp repeat each state
        # n_m times so column e = mode + n_m*state lands right
        self.mem_slice = np.tile(mem_op, (1, N_REMAT_STATES))[self.slice_op]
        self.comm_slice = comm_op[self.slice_op]
        self.comm_slice_lv = (comm_op_lv[self.slice_op]
                              if comm_op_lv is not None else None)
        self.act_slice = np.repeat(act_states, n_m, axis=1)[self.slice_op]
        self.comp_slice = np.repeat(comp_states, n_m, axis=1)[self.slice_op]

        # incremental state (begin/flip)
        self._modes: Optional[np.ndarray] = None
        self._batch = 0

    # -- layout helpers ------------------------------------------------------

    @classmethod
    def for_decisions(cls, desc: ModelDescription, env: CostEnv,
                      decisions: Dict[str, Decision]) -> "PlanEvaluator":
        """Evaluator whose slice layout matches an existing plan."""
        gran = {name: d.split for name, d in decisions.items()}
        return cls(desc, env, gran)

    def modes_from_decisions(
            self, decisions: Dict[str, Decision]) -> np.ndarray:
        modes = np.zeros(self.n_slices, dtype=np.int8)
        index = self.mode_index
        for k, name in enumerate(self.op_names):
            dec = decisions.get(name)
            if dec is None:
                continue
            s = int(self.op_start[k])
            if dec.split != int(self.granularity[k]):
                raise ValueError(
                    f"{name}: decision split {dec.split} != evaluator "
                    f"layout {int(self.granularity[k])}")
            states = dec.remat_states()
            for j, (m, st) in enumerate(zip(dec.modes, states)):
                modes[s + j] = index[m] + self.n_modes * st
        return modes

    def decisions(self, modes: np.ndarray) -> Dict[str, Decision]:
        out: Dict[str, Decision] = {}
        n_m = self.n_modes
        for k, name in enumerate(self.op_names):
            s = int(self.op_start[k])
            e = s + int(self.granularity[k])
            ms = tuple(self.modes[int(m) % n_m] for m in modes[s:e])
            states = [int(m) // n_m for m in modes[s:e]]
            remat = None
            if any(states):
                remat = tuple(None if st == REMAT_INHERIT
                              else st == REMAT_ON for st in states)
            out[name] = Decision(name, ms, remat)
        return out

    # -- vectorized full evaluation ------------------------------------------

    def _bpd(self, global_batch: int) -> int:
        return max(1, global_batch // self.env.n_data)

    def all_dp_memory(self, global_batch: int,
                      remat: Optional[bool] = None) -> float:
        """Steady memory of the all-DP plan (the search's base cost).

        `remat` None takes the legacy inherit columns (env default);
        True / False pin the explicit remat state — the selective
        search's base plan is all-DP all-no-remat (`remat=False`).
        """
        st = REMAT_INHERIT if remat is None else (
            REMAT_ON if remat else REMAT_OFF)
        e = self.n_modes * st
        bpd = self._bpd(global_batch)
        return float(self.mem_slice[:, e].sum()
                     + (self._resident_slope
                        + self.act_slice[:, e].sum()) * bpd)

    def _static_sums(self, modes: np.ndarray
                     ) -> Tuple[float, float, float, float, float,
                                Optional[np.ndarray]]:
        """(steady memory w/o batch terms, comm seconds, peak extra,
        act slope, compute slope, per-level comm vector or None) for
        extended-mode array `modes`."""
        idx = np.arange(self.n_slices)
        shard = modes % self.n_modes
        mem = float(self.mem_slice[idx, modes].sum())
        comm = float(self.comm_slice[idx, modes].sum())
        act = float(self.act_slice[idx, modes].sum())
        comp = float(self.comp_slice[idx, modes].sum())
        starts = np.empty(self.n_slices, dtype=bool)
        starts[0] = True
        np.logical_or(shard[1:] != shard[:-1],
                      self.slice_op[1:] != self.slice_op[:-1],
                      out=starts[1:])
        ops_r = self.slice_op[starts]
        shard_r = shard[starts]
        mem += float(self.mem_run[ops_r, shard_r].sum())
        comm += float(self.comm_run[ops_r, shard_r].sum())
        comm_lv = None
        if self.has_overlap:
            comm_lv = self.comm_slice_lv[idx, modes].sum(axis=0)
            comm_lv += self.comm_run_lv[ops_r, shard_r].sum(axis=0)
        nonzero = np.add.reduceat(
            (shard != 0).astype(np.int64), self.op_start)
        peak = float(self.gathered[nonzero > 0].max()) \
            if bool((nonzero > 0).any()) else 0.0
        return mem, comm, peak, act, comp, comm_lv

    def _combine(self, comm: float, compute: float,
                 comm_lv: Optional[np.ndarray]) -> float:
        """Step time: the serial sum (legacy float order) at overlap 0,
        the exposed-comm timeline otherwise."""
        if comm_lv is None:
            return comm + compute
        return exposed_step_time(compute, comm_lv, self.overlaps)

    def plan_cost(self, modes: np.ndarray,
                  global_batch: int) -> PlanCost:
        """Full vectorized evaluation — `cost_model.plan_cost` semantics."""
        mem_s, comm, peak, act_sl, comp_sl, comm_lv = \
            self._static_sums(modes)
        bpd = self._bpd(global_batch)
        mem = float(mem_s + (self._resident_slope + act_sl) * bpd)
        compute = comp_sl * bpd
        time = self._combine(comm, compute, comm_lv)
        tokens = global_batch * self.desc.shape.seq_len
        return PlanCost(memory=mem, peak_memory=mem + peak, time=time,
                        comm_time=comm, compute_time=compute,
                        throughput=tokens / time if time > 0 else 0.0,
                        comm_by_level=() if comm_lv is None
                        else tuple(float(x) for x in comm_lv))

    # -- incremental evaluation ----------------------------------------------

    def begin(self, modes: np.ndarray, global_batch: int) -> None:
        """Start an incremental evaluation from `modes` (copied)."""
        self._modes = np.asarray(modes, dtype=np.int8).copy()
        self._batch = global_batch
        mem_s, comm, _, act_sl, comp_sl, comm_lv = \
            self._static_sums(self._modes)
        self._mem_static = mem_s
        self._comm = comm
        self._comm_lv = comm_lv
        self._act_sl = act_sl
        self._comp_sl = comp_sl
        self._nonzero = np.add.reduceat(
            ((self._modes % self.n_modes) != 0).astype(np.int64),
            self.op_start)

    def _run_const_window(self, j: int, k: int, shard_j: int) -> \
            Tuple[float, float, Optional[np.ndarray]]:
        """Run-constant contribution of the boundaries at j and j+1 if
        slice j had sharding mode `shard_j` (neighbours read from
        current state; run boundaries ignore the remat state).  The
        third element is the per-level comm vector (None at overlap 0)."""
        modes = self._modes
        n_m = self.n_modes
        mem = comm = 0.0
        lv = np.zeros(self.depth) if self.has_overlap else None
        left_same = j > 0 and int(self.slice_op[j - 1]) == k
        if (not left_same) or int(modes[j - 1]) % n_m != shard_j:
            mem += self.mem_run[k, shard_j]
            comm += self.comm_run[k, shard_j]
            if lv is not None:
                lv += self.comm_run_lv[k, shard_j]
        right = j + 1
        if right < self.n_slices and int(self.slice_op[right]) == k:
            mr = int(modes[right]) % n_m
            if mr != shard_j:
                mem += self.mem_run[k, mr]
                comm += self.comm_run[k, mr]
                if lv is not None:
                    lv += self.comm_run_lv[k, mr]
        return mem, comm, lv

    def flip(self, j: int, new_mode: int) -> None:
        """O(1): change slice j's extended mode in the running
        evaluation (sharding and/or remat state).  The per-level comm
        vector updates are O(depth) — depth <= 3 on every preset, so
        the flip stays constant-time."""
        assert self._modes is not None, "begin() first"
        old = int(self._modes[j])
        if old == new_mode:
            return
        k = int(self.slice_op[j])
        self._mem_static += float(self.mem_slice[j, new_mode]
                                  - self.mem_slice[j, old])
        self._comm += float(self.comm_slice[j, new_mode]
                            - self.comm_slice[j, old])
        if self._comm_lv is not None:
            self._comm_lv += (self.comm_slice_lv[j, new_mode]
                              - self.comm_slice_lv[j, old])
        self._act_sl += float(self.act_slice[j, new_mode]
                              - self.act_slice[j, old])
        self._comp_sl += float(self.comp_slice[j, new_mode]
                               - self.comp_slice[j, old])
        n_m = self.n_modes
        old_s, new_s = old % n_m, new_mode % n_m
        if old_s != new_s:
            # only a sharding change can create/destroy run boundaries
            mem_b, comm_b, lv_b = self._run_const_window(j, k, old_s)
            mem_a, comm_a, lv_a = self._run_const_window(j, k, new_s)
            self._mem_static += float(mem_a - mem_b)
            self._comm += float(comm_a - comm_b)
            if self._comm_lv is not None:
                self._comm_lv += lv_a - lv_b
            self._nonzero[k] += (new_s != 0) - (old_s != 0)
        self._modes[j] = new_mode

    @property
    def current_modes(self) -> np.ndarray:
        """Extended mode indices of the running evaluation (live view)."""
        assert self._modes is not None, "begin() first"
        return self._modes

    @property
    def memory(self) -> float:
        """Steady per-device bytes of the running evaluation."""
        bpd = self._bpd(self._batch)
        return (self._mem_static
                + (self._resident_slope + self._act_sl) * bpd)

    def result(self) -> PlanCost:
        """PlanCost of the running evaluation (peak recomputed exactly)."""
        bpd = self._bpd(self._batch)
        mem = self.memory
        compute = self._comp_sl * bpd
        time = self._combine(self._comm, compute, self._comm_lv)
        peak = float(self.gathered[self._nonzero > 0].max()) \
            if bool((self._nonzero > 0).any()) else 0.0
        tokens = self._batch * self.desc.shape.seq_len
        return PlanCost(memory=mem, peak_memory=mem + peak, time=time,
                        comm_time=self._comm, compute_time=compute,
                        throughput=tokens / time if time > 0 else 0.0,
                        comm_by_level=() if self._comm_lv is None
                        else tuple(float(x) for x in self._comm_lv))


# convenience whole-model plans ----------------------------------------------

def count_remat_slices(decisions: Dict[str, Decision],
                       value: bool = True) -> int:
    """Slices across a plan whose explicit remat bit equals `value`
    (inherit slices are never counted)."""
    return sum(sum(1 for r in (d.remat or ())
                   if r is not None and bool(r) == value)
               for d in decisions.values())


def uniform_plan(desc: ModelDescription, mode: str,
                 split: int = 1) -> Dict[str, Decision]:
    out = {}
    for op in desc.operators:
        if not op.decidable:
            out[op.name] = Decision(op.name, (DP,))
        else:
            g = split if (split > 1 and op.splittable) else 1
            out[op.name] = Decision(op.name, (mode,) * g)
    return out


def zdp_saving(op: OperatorDesc, env: CostEnv, mode: str = ZDP,
               split: int = 1) -> float:
    """Net memory bytes saved by moving op from DP to `mode` at slice
    granularity `split`: sharded model states minus the transiently
    gathered per-layer slice (paper M_extra; shrinks with splitting).
    Serving envs (train=False) hold only the bf16 weights, so the
    sharding saving is 8x smaller than the optimizer-state saving."""
    n = shard_ways(mode, env)
    s = (op.state_bytes if env.train else op.param_bytes) / env.n_tp
    gathered = op.param_bytes / env.n_tp / (max(1, op.layers) * max(1, split))
    return max(0.0, s * (1 - 1 / n) - gathered)


def zdp_extra_time(op: OperatorDesc, env: CostEnv, mode: str = ZDP) -> float:
    """Per-step seconds added by moving op from DP to `mode`.

    Under an overlapped topology the solvers' additive surrogate
    discounts each level's comm by its hideable fraction (1 - overlap):
    a second of level-l traffic only costs (1 - ov_l) seconds at the
    margin when that level's collectives ride behind compute.  The
    exposed-comm max() makes the true objective non-additive; the
    surrogate ranks items, the timeline evaluator scores the final
    plan exactly (and the repair loop judges memory only, which is
    overlap-independent)."""
    d_dp = Decision(op.name, (DP,))
    d_z = Decision(op.name, (mode,))
    # batch/seq affect only compute, identical across modes -> use 1,1
    c_dp = op_cost(op, d_dp, 1, 1, env)
    c_z = op_cost(op, d_z, 1, 1, env)
    if not env.has_overlap:
        return c_z.comm_time - c_dp.comm_time
    ov = env.overlaps
    return (sum((1.0 - o) * c for c, o in zip(c_z.comm_by_level, ov))
            - sum((1.0 - o) * c for c, o in zip(c_dp.comm_by_level, ov)))


# selective-remat per-slice terms (the 4-mode axis item costs) ---------------

def remat_gather_time(op: OperatorDesc, env: CostEnv, mode: str = ZDP,
                      split: int = 1) -> float:
    """Seconds of the §4.3 recompute-pass parameter gather for ONE
    remat'd slice of `op` at granularity `split` (training only; DP
    recomputes from local weights at no collective cost)."""
    if not env.train or mode == DP:
        return 0.0
    topo = env.topo
    k = topo.mode_span(mode)
    p = op.param_bytes / env.n_tp / max(1, split)
    return _rings_pass(p, topo.gather_rings(k), topo.span_ways(k))


def remat_act_saving_slope(op: OperatorDesc, env: CostEnv, seq_len: int,
                           split: int = 1) -> float:
    """Steady activation bytes ONE remat'd slice stops holding, per unit
    of per-device batch: act_slice * (1 - 1/eff_remat_layers)."""
    act_slice = op.act_bytes_per_token / env.n_tp * seq_len / max(1, split)
    return act_slice * (1.0 - 1.0 / op.eff_remat_layers)


def remat_compute_slope(op: OperatorDesc, env: CostEnv, seq_len: int,
                        split: int = 1) -> float:
    """Recompute seconds ONE remat'd slice adds, per unit of per-device
    batch: the recompute fraction (30%, or the fitted factor minus 1)
    of the slice's (train) compute."""
    comp = (op.flops_per_token * seq_len / env.n_tp
            / env.op_peak_compute(op.flops_per_token * seq_len
                                  / env.n_tp)) / max(1, split)
    if env.train:
        comp *= 3.0
    return env.remat_compute_delta * comp


# ---------------------------------------------------------------------------
# Serving workload model: prefill/decode asymmetry + the KV-cache budget
# ---------------------------------------------------------------------------
#
# Inference is the same §3.1 trade — memory vs hardware utilization per
# operator under a device budget — with two twists the training model
# cannot see:
#
#   * the dominant memory term is the per-sequence KV/SSM cache
#     (OperatorDesc.kv_cache_bytes_per_token / cache_bytes_per_seq),
#     which scales with the *admitted concurrency*, not the batch of one
#     step — so the planner trades sharded weights against cache slots;
#   * the two phases price differently: prefill is compute-bound
#     (batch x prompt_len tokens amortize every gather), decode is
#     bandwidth-bound (batch x 1 token must still stream the full
#     weight set + all live caches from HBM every step).
#
# `serving_plan_cost` therefore evaluates one plan at BOTH shapes and
# adds an HBM-roofline floor to each phase's compute term; the
# prefill/decode formulas live in docs/cost_model.md §8.

@dataclass(frozen=True)
class ServingWorkload:
    """Steady-state serving traffic: requests arrive with
    `prompt_len`-token prompts and decode `decode_len` tokens, so an
    admitted sequence pins a cache of `cache_len` attended tokens."""

    prompt_len: int = 512
    decode_len: int = 128

    def __post_init__(self):
        if self.prompt_len < 1 or self.decode_len < 1:
            raise ValueError("workload needs prompt_len/decode_len >= 1")

    @property
    def cache_len(self) -> int:
        return self.prompt_len + self.decode_len


@dataclass(frozen=True)
class RequestClass:
    """One class of serving traffic: its shape (`prompt_len`,
    `decode_len`), its offered load (`arrival_rate`, requests/s into
    the fleet), and its tail-latency targets (`ttft_slo` / `tpot_slo`,
    seconds; `inf` = no SLO).  A `RequestClassMix` weights several of
    these; the single-class mix is an exact alias of the legacy
    `ServingWorkload`."""

    name: str
    prompt_len: int = 512
    decode_len: int = 128
    arrival_rate: float = 1.0
    ttft_slo: float = math.inf
    tpot_slo: float = math.inf

    def __post_init__(self):
        if not self.name:
            raise ValueError("request class needs a name")
        if self.prompt_len < 1 or self.decode_len < 1:
            raise ValueError("class needs prompt_len/decode_len >= 1")
        if self.arrival_rate <= 0:
            raise ValueError("class needs arrival_rate > 0")
        if self.ttft_slo <= 0 or self.tpot_slo <= 0:
            raise ValueError("SLOs must be positive (inf = none)")

    @property
    def cache_len(self) -> int:
        return self.prompt_len + self.decode_len

    def workload(self) -> ServingWorkload:
        """The class's single-class `ServingWorkload` projection."""
        return ServingWorkload(self.prompt_len, self.decode_len)


@dataclass(frozen=True)
class RequestClassMix:
    """Weighted request classes — the fleet-serving workload model.

    Slot occupancy weighting: every admitted sequence shares the same
    batched decode step, so a class's steady-state share of the slot
    pool is proportional to `arrival_rate * decode_len` (Little's law
    with a common per-token service time).  `slot_share` drives both
    the expected per-slot cache bytes the planner budgets for and the
    per-class throughput split; with one class every share is exactly
    1.0, which is what makes the single-class mix an exact alias of
    `ServingWorkload`."""

    classes: Tuple[RequestClass, ...]

    def __post_init__(self):
        if not self.classes:
            raise ValueError("mix needs at least one class")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate class names: {names}")

    @classmethod
    def single(cls, prompt_len: int = 512, decode_len: int = 128,
               name: str = "default", **kw) -> "RequestClassMix":
        return cls((RequestClass(name, prompt_len, decode_len, **kw),))

    @classmethod
    def of(cls, workload: "WorkloadLike") -> "RequestClassMix":
        """Normalize a `ServingWorkload` (or mix) to a mix."""
        if isinstance(workload, RequestClassMix):
            return workload
        return cls.single(workload.prompt_len, workload.decode_len)

    def __len__(self) -> int:
        return len(self.classes)

    def __iter__(self):
        return iter(self.classes)

    def __getitem__(self, name: str) -> RequestClass:
        for c in self.classes:
            if c.name == name:
                return c
        raise KeyError(name)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.classes)

    @property
    def total_rate(self) -> float:
        return sum(c.arrival_rate for c in self.classes)

    @property
    def offered_tokens_per_s(self) -> float:
        """Decode tokens/s the mix demands at its arrival rates."""
        return sum(c.arrival_rate * c.decode_len for c in self.classes)

    def slot_share(self, c: Union[RequestClass, str]) -> float:
        """Class `c`'s steady-state fraction of the slot pool (by
        object or name)."""
        if isinstance(c, str):
            c = self[c]
        total = sum(k.arrival_rate * k.decode_len for k in self.classes)
        return c.arrival_rate * c.decode_len / total

    @property
    def max_cache_len(self) -> int:
        """Slot sizing: slots must hold the largest class's cache."""
        return max(c.cache_len for c in self.classes)

    def workload(self) -> ServingWorkload:
        """Single-class projection (exact only for one class; multi-
        class mixes project to the worst-case shape for slot sizing)."""
        if len(self.classes) == 1:
            return self.classes[0].workload()
        return ServingWorkload(max(c.prompt_len for c in self.classes),
                               max(c.decode_len for c in self.classes))

    def subset(self, names: Sequence[str]) -> "RequestClassMix":
        """The sub-mix of the named classes (shares renormalize)."""
        keep = tuple(c for c in self.classes if c.name in set(names))
        if not keep:
            raise ValueError(f"no classes left from {names}")
        return RequestClassMix(keep)


WorkloadLike = Union[ServingWorkload, RequestClassMix]


@dataclass
class ServingCost:
    """One plan's serving economics at a fixed per-device concurrency."""

    weight_memory: float       # per-device plan-sharded weights (+M_extra)
    cache_bytes_per_seq: float  # per-device cache one sequence pins
    slots_per_device: int      # admitted concurrency per device
    concurrency: int           # global in-flight requests (slots x n_data)
    memory: float              # steady per-device bytes, caches included
    prefill_time: float        # one admitted request's prefill (batch 1)
    decode_step_time: float    # one decode step at full concurrency
    ttft: float                # time to first token ~= prefill_time
    tpot: float                # inter-token latency ~= decode_step_time
    request_latency: float     # ttft + decode_len * tpot
    throughput: float          # steady-state output tokens/s, global


def plan_weight_bytes(desc: ModelDescription,
                      decisions: Dict[str, Decision],
                      env: CostEnv) -> float:
    """Per-device bytes the plan's sharded model states occupy
    (batch-independent: op_cost at zero tokens)."""
    total = 0.0
    for op in desc.operators:
        dec = decisions.get(op.name) or Decision(op.name, (DP,))
        total += op_cost(op, dec, 0, 1, env).memory
    return total


def inference_act_bytes(desc: ModelDescription, env: CostEnv,
                        batch_per_device: int, seq_len: int) -> float:
    """Live activation bytes of one inference forward pass.

    No backward pass retains anything: the layer scan holds the
    residual stream plus ONE layer's working set (the widest op's),
    and the head materializes last-position fp32 logits.  This is the
    serving analogue of the training act term, which counts every
    layer's activations."""
    tokens = batch_per_device * seq_len
    tp = env.n_tp
    per_layer = max((op.act_bytes_per_token / max(1, op.layers)
                     for op in desc.operators), default=0.0)
    residual = desc.model.d_model * ACT_BYTES * tokens
    logits = desc.model.padded_vocab * 4.0 * batch_per_device
    return (residual + per_layer * tokens) / tp + logits


def weight_read_bytes(desc: ModelDescription, env: CostEnv) -> float:
    """HBM bytes of weights one forward step streams per device.

    Matmul ops read their full (per-TP-shard) weights; MoE experts are
    read at the top-k/E active fraction — recovered exactly from the
    flops/param ratio (a matmul's flops_per_token is 2 x params, so the
    ratio is the active fraction); param-less and zero-flop ops stream
    nothing that scales with the model."""
    total = 0.0
    for op in desc.operators:
        if op.param_count <= 0 or op.flops_per_token <= 0:
            continue
        frac = min(1.0, op.flops_per_token / (2.0 * op.param_count))
        total += frac * op.param_bytes
    return total / env.n_tp


def serving_plan_cost(desc_prefill: ModelDescription,
                      desc_decode: ModelDescription,
                      decisions: Dict[str, Decision],
                      workload: ServingWorkload, env: CostEnv,
                      slots_per_device: int) -> ServingCost:
    """Score one sharding plan for serving at a fixed concurrency.

    `desc_prefill` / `desc_decode` describe the same model at the two
    phase shapes (seq_len = prompt_len and 1); `env` must be a serving
    env (train=False: one forward gather per ZDP run, no grad sync).
    Prefill runs one request per device (continuous batching admits
    requests one at a time); decode runs all `slots_per_device` slots.
    Each phase's compute is floored by its HBM streaming time:
    weights for both, plus every live cache for decode.  Memory is
    weights + caches + the worst phase's live activations
    (`inference_act_bytes` — inference keeps nothing for a backward
    pass, so the training act term does not apply)."""
    if env.train:
        raise ValueError("serving_plan_cost needs a train=False CostEnv")
    n = env.n_data
    slots = max(1, slots_per_device)
    cache_seq = desc_decode.cache_bytes_per_seq(workload.cache_len,
                                                env.n_tp)
    dec = plan_cost(desc_decode, decisions, slots * n, env)
    pre = plan_cost(desc_prefill, decisions, n, env)
    bw = env.device.hbm_bw
    reads = weight_read_bytes(desc_decode, env)
    if env.has_overlap:
        # the HBM-floor streaming (weights + live caches) is the busy
        # window the phase's collectives can hide behind
        decode_step = exposed_step_time(
            max(dec.compute_time, (reads + slots * cache_seq) / bw),
            dec.comm_by_level, env.overlaps)
        prefill = exposed_step_time(max(pre.compute_time, reads / bw),
                                    pre.comm_by_level, env.overlaps)
    else:
        decode_step = (max(dec.compute_time,
                           (reads + slots * cache_seq) / bw)
                       + dec.comm_time)
        prefill = max(pre.compute_time, reads / bw) + pre.comm_time
    latency = prefill + workload.decode_len * decode_step
    weight_mem = plan_weight_bytes(desc_decode, decisions, env)
    act = max(inference_act_bytes(desc_prefill, env, 1,
                                  workload.prompt_len),
              inference_act_bytes(desc_decode, env, slots, 1))
    return ServingCost(
        weight_memory=weight_mem,
        cache_bytes_per_seq=cache_seq,
        slots_per_device=slots,
        concurrency=slots * n,
        memory=weight_mem + act + slots * cache_seq,
        prefill_time=prefill,
        decode_step_time=decode_step,
        ttft=prefill,
        tpot=decode_step,
        request_latency=latency,
        throughput=(slots * n * workload.decode_len / latency
                    if latency > 0 else 0.0))


@dataclass
class MixServingCost:
    """One plan's serving economics under a `RequestClassMix`.

    `per_class` prices each class through the same phase machinery as
    `serving_plan_cost` — its own prefill shape, the shared batched
    decode step — with the decode HBM floor and the memory budget
    charged at the occupancy-weighted *expected* cache bytes
    (`cache_bytes_per_slot`).  `memory` is the binding (max) per-class
    figure, so feasibility is judged at the worst phase of the worst
    class."""

    per_class: Dict[str, ServingCost]
    slots_per_device: int
    concurrency: int
    weight_memory: float
    cache_bytes_per_slot: float
    memory: float
    decode_step_time: float
    throughput: float             # aggregate output tokens/s
    offered_tokens_per_s: float   # decode tokens/s the mix demands

    def slo_attained(self, mix: RequestClassMix) -> Dict[str, bool]:
        """Analytic per-class SLO check: phase latencies within the
        class targets AND the class's throughput share covers its
        offered load (otherwise queues grow without bound)."""
        out = {}
        for c in mix.classes:
            sc = self.per_class[c.name]
            out[c.name] = (sc.ttft <= c.ttft_slo
                           and sc.tpot <= c.tpot_slo
                           and sc.throughput + 1e-12
                           >= c.arrival_rate * c.decode_len)
        return out


def serving_mix_cost(desc_prefills: Dict[int, ModelDescription],
                     desc_decode: ModelDescription,
                     decisions: Dict[str, Decision],
                     mix: RequestClassMix, env: CostEnv,
                     slots_per_device: int) -> MixServingCost:
    """Score one sharding plan for serving a `RequestClassMix`.

    `desc_prefills` maps each class's prompt_len to the model described
    at that prefill shape (`desc_decode` is shared — decode is always
    seq_len 1).  Every class sees the same decode step (all admitted
    sequences decode in one batch), floored by streaming the weights
    plus the *expected* live cache (slot-share weighted over class
    cache lengths); each class pays its own prefill.  Class throughput
    is its slot share of the pool.  With a single class every figure
    reduces exactly to `serving_plan_cost` (share = 1.0)."""
    if env.train:
        raise ValueError("serving_mix_cost needs a train=False CostEnv")
    n = env.n_data
    slots = max(1, slots_per_device)
    cache_exp = sum(
        mix.slot_share(c)
        * desc_decode.cache_bytes_per_seq(c.cache_len, env.n_tp)
        for c in mix.classes)
    dec = plan_cost(desc_decode, decisions, slots * n, env)
    bw = env.device.hbm_bw
    reads = weight_read_bytes(desc_decode, env)
    if env.has_overlap:
        decode_step = exposed_step_time(
            max(dec.compute_time, (reads + slots * cache_exp) / bw),
            dec.comm_by_level, env.overlaps)
    else:
        decode_step = (max(dec.compute_time,
                           (reads + slots * cache_exp) / bw)
                       + dec.comm_time)
    weight_mem = plan_weight_bytes(desc_decode, decisions, env)
    act_dec = inference_act_bytes(desc_decode, env, slots, 1)
    per_class: Dict[str, ServingCost] = {}
    for c in mix.classes:
        desc_pre = desc_prefills[c.prompt_len]
        pre = plan_cost(desc_pre, decisions, n, env)
        if env.has_overlap:
            prefill = exposed_step_time(
                max(pre.compute_time, reads / bw),
                pre.comm_by_level, env.overlaps)
        else:
            prefill = max(pre.compute_time, reads / bw) + pre.comm_time
        latency = prefill + c.decode_len * decode_step
        act = max(inference_act_bytes(desc_pre, env, 1, c.prompt_len),
                  act_dec)
        share = mix.slot_share(c)
        per_class[c.name] = ServingCost(
            weight_memory=weight_mem,
            cache_bytes_per_seq=desc_decode.cache_bytes_per_seq(
                c.cache_len, env.n_tp),
            slots_per_device=slots,
            concurrency=slots * n,
            memory=weight_mem + act + slots * cache_exp,
            prefill_time=prefill,
            decode_step_time=decode_step,
            ttft=prefill,
            tpot=decode_step,
            request_latency=latency,
            throughput=(share * slots * n * c.decode_len / latency
                        if latency > 0 else 0.0))
    return MixServingCost(
        per_class=per_class,
        slots_per_device=slots,
        concurrency=slots * n,
        weight_memory=weight_mem,
        cache_bytes_per_slot=cache_exp,
        memory=max(sc.memory for sc in per_class.values()),
        decode_step_time=decode_step,
        throughput=sum(sc.throughput for sc in per_class.values()),
        offered_tokens_per_s=mix.offered_tokens_per_s)
