"""OSDP Search Engine + Scheduler (paper Algorithm 1).

Four solvers over the same problem
    min_p  T(p, b)   s.t.  M(p, b) <= M_limit,  p_i in {DP, ZDP[, ZDP_POD]}

With `OSDPConfig(checkpointing="selective")` the per-slice decision
space widens to the 4-mode axis {DP, ZDP[, ZDP_POD]} x {remat,
no-remat}: the base plan is all-DP-no-remat and every item offers
remat'd variants of each sharding mode (plus remat-only), whose
activation savings and recompute costs are batch-linear — the solvers
stay unchanged, they just see more choices per item, materialized per
batch candidate.  `checkpointing=True/False` keep the legacy global
behaviour byte-for-byte.

  * ``dfs``      — the paper's depth-first search with its two pruning
                   rules (memory-exceeded, worse-than-incumbent), made
                   exact-and-fast with branch-and-bound lower bounds,
                   best-ratio branch ordering, and *group collapsing*:
                   per-layer descriptions expose hundreds of slices with
                   identical (saving, cost) signatures, and the search
                   branches on how many of each signature to shard
                   instead of which — same optimum, exponentially fewer
                   nodes. Paper-faithful semantics: returns the same
                   argmin as brute force.
  * ``knapsack`` — beyond-paper exact solver: choosing ZDP for op i
                   saves dM_i memory and costs dT_i time, so the problem
                   is a 0/1 knapsack-cover; solved by a vectorized
                   (numpy row-wise) DP over discretized memory savings
                   with a compact int8 parent encoding. O(n * M/Q) cell
                   relaxations with quantum Q.
  * ``greedy``   — dT/dM ratio heuristic, O(n log n); near-optimal when
                   savings are small relative to the gap (used to seed
                   the DFS incumbent).
  * ``ilp``      — the explicit integer-linear-program oracle
                   (``core.ilp``): scipy's HiGHS MILP when available, a
                   dependency-free Lagrangian-bound branch-and-bound
                   otherwise.  Exact by construction rather than by
                   search engineering — the reference the other three
                   are audited against (``benchmarks/solver_audit.py``)
                   — and *anytime* under ``OSDPConfig.ilp_time_budget_s``
                   (incumbent + proven ``SearchResult.lower_bound``).

Plan evaluation around the solvers goes through
``cost_model.PlanEvaluator``: per-op/per-mode cost tables are built once
per (description, env), full evaluations are vectorized, and the repair
loop's one-slice flips are O(1) delta updates instead of full
``plan_cost`` re-walks (the pre-optimization path was
O(slices^2 * ops) when repair triggered).

The Scheduler sweeps the batch size b upward until even the
all-ZDP+split plan exceeds the limit, keeping the throughput-argmax
(Algorithm 1 lines 3–18, 20); items and tables are shared across the
whole sweep because only the batch-linear activation/compute terms
change between candidates.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import (DeviceInfo, MeshConfig, ModelConfig,
                                OSDPConfig, ShapeConfig)
from repro_torch.cluster.topology import ClusterSpec
from repro_torch.core.cost_model import (DP, MODES, REMAT_INHERIT, REMAT_OFF,
                                   REMAT_ON, ZDP, ZDP_POD, CostEnv,
                                   Decision, MixServingCost, PlanCost,
                                   PlanEvaluator, RequestClass,
                                   RequestClassMix, ServingCost,
                                   ServingWorkload, WorkloadLike,
                                   plan_cost, remat_act_saving_slope,
                                   remat_compute_slope, remat_gather_time,
                                   inference_act_bytes, serving_mix_cost,
                                   serving_plan_cost, uniform_plan,
                                   zdp_extra_time, zdp_saving)
from repro_torch.core.descriptions import ModelDescription, OperatorDesc, describe
from repro_torch.core.ilp import solve_ilp
from repro_torch.core.hybrid import (Factorization, HybridPlan, factorizations,
                               hybrid_step_time, pp_boundary_time,
                               slice_description, stage_bounds,
                               tp_activation_time)


# selective remat widens each item's choice set from sharding modes to
# (sharding x remat) pairs, keyed "ZDP" / "ZDP+R" / "DP+R" / ...; the
# "+R" choices rematerialize the slice (keep 1/remat_layers of its
# activations, pay the ~30% recompute and — sharded — the 4th gather).
REMAT_KEY = "+R"


def _key(mode: str, remat: bool) -> str:
    return mode + REMAT_KEY if remat else mode


def _parse_key(key: str) -> Tuple[str, bool]:
    if key.endswith(REMAT_KEY):
        return key[:-len(REMAT_KEY)], True
    return key, False


@dataclass
class SliceItem:
    """One decidable unit: an operator slice (whole op if unsplit).

    `savings` / `extra_time` are the batch-independent parts; the
    `_slope` dicts (selective remat only) hold the batch-linear parts
    per unit of per-device batch — activation bytes saved and recompute
    seconds added scale with b.  `_SearchContext.solve` materializes
    concrete per-batch items before handing them to the solvers, so the
    solvers themselves stay batch-agnostic.
    """

    op_name: str
    slice_idx: int
    n_slices: int
    savings: Dict[str, float]      # choice -> steady bytes saved vs base
    extra_time: Dict[str, float]   # choice -> seconds added vs base
    savings_slope: Dict[str, float] = field(default_factory=dict)
    extra_time_slope: Dict[str, float] = field(default_factory=dict)


@dataclass
class SearchResult:
    decisions: Dict[str, Decision]
    cost: PlanCost
    batch_size: int
    feasible: bool
    solver: str
    search_seconds: float
    # solver effort, one unified integer per backend (each is the
    # backend's natural unit of work, monotone in the solver's budget
    # for one fixed instance — pinned by tests/test_ilp.py):
    #   dfs      — branch-and-bound nodes expanded (0 when the root
    #              capacity prune proves the need uncoverable)
    #   knapsack — DP cells relaxed (0 when round-down quantization
    #              proves the quantized need uncoverable and the solve
    #              short-circuits to the max-saving fallback)
    #   greedy   — items ranked (= number of items, always)
    #   ilp      — integer variables + branch-and-bound nodes (HiGHS
    #              mip_node_count for the milp backend, best-first pops
    #              for the pure-Python bnb; >= 1 always — trivial and
    #              uncoverable instances still report model size)
    nodes_visited: int = 0
    candidates: List[Tuple[int, float]] = field(default_factory=list)
    # (batch, throughput) per Scheduler iteration — Algorithm 1's P set
    # --- ilp-only optimality certificate (None for other solvers) ----------
    # proven lower bound on the cover objective of the winning solve,
    # and whether the incumbent closed the gap (False = anytime mode
    # returned early); solver_backend records which ilp engine ran
    lower_bound: Optional[float] = None
    proven_optimal: Optional[bool] = None
    solver_backend: str = ""


def auto_granularity(op, env: CostEnv, osdp: OSDPConfig,
                     candidates=(1, 2, 4, 8, 16)) -> int:
    """Per-operator slice granularity (beyond paper — §4.3 names this
    as open future work).

    Larger g shrinks the transiently-gathered slice (M_extra/g) but
    adds (g-1) extra collective-latency terms. Pick the g minimizing
        alpha_cost(g) + shadow_price * gathered(g)
    where the shadow price converts bytes to seconds at the ring rate
    of this op's own gather (the marginal cost of covering the same
    bytes by sharding some other operator instead)."""
    if not (osdp.operator_splitting and op.splittable):
        return 1
    topo = env.topo
    rounds = (3 + (1 if env.checkpointing else 0)) if env.train else 1
    gathered_full = op.param_bytes / env.n_tp / max(1, op.layers)
    # seconds per byte of memory covered by sharding elsewhere, at the
    # full-span hierarchical ring rate (= the flat bottleneck ring on a
    # depth-2 single-pod adapter)
    ga, gb = topo.gather_terms(topo.depth)
    shadow = rounds * gb

    def total(g: int) -> float:
        alpha_cost = rounds * ga * (g - 1)
        return alpha_cost + shadow * gathered_full / g

    return min(candidates, key=total)


def _build_items(desc: ModelDescription, env: CostEnv,
                 osdp: OSDPConfig) -> List[SliceItem]:
    modes = [ZDP]
    if osdp.allow_pod_hierarchical:
        # level-k ZDP: one extra choice per intermediate hierarchy
        # level whose span is a real subdivision (depth-2 adapters
        # expose the legacy ZDP_POD exactly when the mesh is multi-pod)
        topo = env.topo
        modes += [topo.span_mode(k) for k in topo.shard_levels]
    selective = osdp.selective_remat
    seq = desc.shape.seq_len
    items: List[SliceItem] = []
    for op in desc.decidable():
        if osdp.auto_granularity:
            g = auto_granularity(op, env, osdp)
        else:
            g = (osdp.default_slice_granularity
                 if (osdp.operator_splitting and op.splittable) else 1)
        sav = {m: zdp_saving(op, env, m, g) / g for m in modes}
        ext = {m: zdp_extra_time(op, env, m) / g for m in modes}
        if not selective:
            for j in range(g):
                items.append(SliceItem(op.name, j, g, sav, ext))
            continue
        # 4-mode axis: every sharding choice with and without remat,
        # plus remat-only (stay DP) when it can actually save memory.
        # The base (no choice) is (DP, no-remat).
        act_slope = remat_act_saving_slope(op, env, seq, g)
        comp_slope = remat_compute_slope(op, env, seq, g)
        sav_slope: Dict[str, float] = {}
        ext_slope: Dict[str, float] = {}
        if act_slope > 0:
            for m in modes:
                rk = _key(m, True)
                sav[rk] = sav[m]
                ext[rk] = ext[m] + remat_gather_time(op, env, m, g)
                sav_slope[rk] = act_slope
                ext_slope[rk] = comp_slope
            rdp = _key(DP, True)
            sav[rdp] = 0.0
            ext[rdp] = 0.0
            sav_slope[rdp] = act_slope
            ext_slope[rdp] = comp_slope
        for j in range(g):
            items.append(SliceItem(op.name, j, g, sav, ext,
                                   sav_slope, ext_slope))
    if selective:
        # remat is orthogonal to sharding: operators pinned to DP
        # (decidable=False) still choose remat/no-remat — without this
        # a selective plan could not reach the global-remat memory
        # floor (e.g. mamba2's conv/gate group holds real activations)
        for op in desc.operators:
            if op.decidable:
                continue
            act_slope = remat_act_saving_slope(op, env, seq, 1)
            if act_slope <= 0:
                continue
            rdp = _key(DP, True)
            items.append(SliceItem(
                op.name, 0, 1, {rdp: 0.0}, {rdp: 0.0},
                {rdp: act_slope},
                {rdp: remat_compute_slope(op, env, seq, 1)}))
    return items


def _materialize_items(items: List[SliceItem], bpd: int) -> List[SliceItem]:
    """Fold the batch-linear slopes into concrete per-batch items."""
    out: List[SliceItem] = []
    for it in items:
        if not it.savings_slope and not it.extra_time_slope:
            out.append(it)
            continue
        sav = {m: v + bpd * it.savings_slope.get(m, 0.0)
               for m, v in it.savings.items()}
        ext = {m: v + bpd * it.extra_time_slope.get(m, 0.0)
               for m, v in it.extra_time.items()}
        out.append(SliceItem(it.op_name, it.slice_idx, it.n_slices,
                             sav, ext))
    return out


def _items_to_decisions(desc: ModelDescription, items: List[SliceItem],
                        choice: List[Optional[str]]
                        ) -> Dict[str, Decision]:
    """Legacy (2-mode) choices -> decisions; the production path emits
    decisions through PlanEvaluator.decisions() instead (which also
    carries the remat axis) — this helper remains the reference shape
    used by the golden tests."""
    per_op: Dict[str, List[str]] = {}
    for it, c in zip(items, choice):
        per_op.setdefault(it.op_name, [DP] * it.n_slices)
        if c is not None:
            per_op[it.op_name][it.slice_idx] = _parse_key(c)[0]
    out: Dict[str, Decision] = {}
    for op in desc.operators:
        if op.name in per_op:
            out[op.name] = Decision(op.name, tuple(per_op[op.name]))
        else:
            out[op.name] = Decision(op.name, (DP,))
    return out


def _best_mode(it: SliceItem) -> str:
    """Cheapest dT/dM mode for one item (the repair/branch order key)."""
    return min(it.savings, key=lambda m: it.extra_time[m]
               / max(it.savings[m], 1e-9))


def _best_ratio(it: SliceItem) -> float:
    return min(it.extra_time[m] / max(it.savings[m], 1e-9)
               for m in it.savings)


# ---------------------------------------------------------------------------
# Solver 1: the paper's DFS (branch and bound over signature groups, exact)
# ---------------------------------------------------------------------------

def _solve_dfs(items: List[SliceItem], need: float,
               node_budget: int = 2_000_000) -> Tuple[List[Optional[str]], int]:
    """Minimize sum extra_time s.t. sum savings >= need.

    Paper Algorithm 1 lines 5–11: traverse the plan space depth-first,
    pruning on (a) memory infeasibility and (b) incumbent time bound.
    Items with identical (savings, extra_time) signatures — all slices
    of one stacked operator, and every per-layer copy of the same
    operator — are interchangeable, so the search branches on *how
    many* of each signature group to shard per mode (a prefix of the
    group, WLOG) rather than on each slice: the optimum is unchanged
    and the tree shrinks from 2^n to a product over distinct
    signatures. Within the remaining tree the classic bounds apply:
    best-ratio level ordering, an admissible remaining-time bound
    (remaining need x best remaining ratio), and a capacity bound
    (even sharding everything left cannot cover the need).
    """
    n = len(items)
    if need <= 0:
        return [None] * n, 1

    # greedy incumbent (also the fallback when the need is uncoverable,
    # matching the pre-grouping implementation)
    inc_choice, inc_time = _solve_greedy(items, need)

    # group by exact cost signature
    sig_groups: Dict[tuple, List[int]] = {}
    for i, it in enumerate(items):
        sig = (tuple(sorted(it.savings.items())),
               tuple(sorted(it.extra_time.items())))
        sig_groups.setdefault(sig, []).append(i)
    glist = sorted(
        ([idxs, items[idxs[0]]] for idxs in sig_groups.values()),
        key=lambda g: _best_ratio(g[1]))

    # levels: one per (group, mode), contiguous per group, cheapest
    # ratio first within the group
    levels: List[Tuple[int, str, float, float, int, bool]] = []
    for gi, (idxs, it) in enumerate(glist):
        ms = sorted(it.savings, key=lambda m: it.extra_time[m]
                    / max(it.savings[m], 1e-9))
        for mj, m in enumerate(ms):
            levels.append((gi, m, it.savings[m], it.extra_time[m],
                           len(idxs), mj == 0))
    L = len(levels)

    # bounds: max savings still reachable from a level (per-item, within
    # the level's group) and over all later groups; best ratio suffix
    inner_max = [0.0] * L
    group_best = {}
    for li in range(L - 1, -1, -1):
        gi, m, sav, ext, k, is_first = levels[li]
        group_best[gi] = max(group_best.get(gi, 0.0), sav)
        inner_max[li] = group_best[gi]
    suffix_group_sav = [0.0] * (len(glist) + 1)
    for gi in range(len(glist) - 1, -1, -1):
        idxs, it = glist[gi]
        suffix_group_sav[gi] = (suffix_group_sav[gi + 1]
                                + len(idxs) * max(it.savings.values()))
    suffix_ratio = [float("inf")] * (L + 1)
    for li in range(L - 1, -1, -1):
        gi, m, sav, ext, k, is_first = levels[li]
        suffix_ratio[li] = min(suffix_ratio[li + 1],
                               ext / max(sav, 1e-9))

    # fractional (LP) suffix bound: cheapest fractional cover of the
    # remaining need by levels >= li, each level capped at its full
    # group capacity (relaxes mode exclusivity and group sharing —
    # admissible).  Far stronger than need x best-remaining-ratio when
    # the cheap levels have small capacity, which is exactly what blows
    # up the 4-mode (selective remat) tree: 5 incomparable modes per
    # signature would otherwise branch near-unpruned.
    frac_tables: List[Tuple[List[float], List[float], List[float]]] = []
    for li in range(L + 1):
        lvls = sorted((ext / max(sav, 1e-9), k * sav)
                      for _, _, sav, ext, k, _ in levels[li:] if sav > 0)
        cum_s, cum_c = [0.0], [0.0]
        for r, cap in lvls:
            cum_s.append(cum_s[-1] + cap)
            cum_c.append(cum_c[-1] + r * cap)
        frac_tables.append((cum_s, cum_c, [r for r, _ in lvls]))

    def frac_bound(li: int, need_rem: float) -> float:
        if need_rem <= 0:
            return 0.0
        cum_s, cum_c, ratios = frac_tables[li]
        if need_rem > cum_s[-1]:
            return float("inf")
        j = bisect.bisect_left(cum_s, need_rem)
        return cum_c[j - 1] + (need_rem - cum_s[j - 1]) * ratios[j - 1]

    best_time = inc_time
    best_counts: Optional[List[int]] = None
    counts = [0] * L
    nodes = 0

    def c_max_at(li: int, rem: int, saved: float) -> int:
        gi, m, sav, ext, k, is_first = levels[li]
        if sav > 0:
            c_cover = math.ceil((need - saved) / sav)
            # sharding beyond coverage is dominated when it costs time
            return min(rem, c_cover) if ext > 0 else rem
        return rem if ext <= 0 else 0

    # iterative DFS: frames of (level, remaining group capacity on
    # entry, saved, t, next-branch index); branch bi maps to taking
    # c = c_max - bi slices at this level (greedy-like: most first)
    stack: List[Tuple[int, int, float, float, int]] = [(0, 0, 0.0, 0.0, 0)]
    while stack:
        li, rem, saved, t, bi = stack.pop()
        if bi == 0:
            if saved >= need:
                if t < best_time:
                    best_time = t
                    best_counts = counts[:li] + [0] * (L - li)
                continue
            if li == L:
                continue
            if levels[li][5]:                 # first level of its group
                rem = levels[li][4]
            gi = levels[li][0]
            # prune: even sharding everything left cannot cover the need
            if (saved + rem * inner_max[li]
                    + suffix_group_sav[gi + 1] < need):
                continue
            # prune: admissible lower bound on remaining time (cheap
            # best-ratio test first, then the fractional-cover bound)
            if (t + (need - saved) * suffix_ratio[li] >= best_time
                    or t + frac_bound(li, need - saved) >= best_time):
                continue
            nodes += 1
            if nodes > node_budget:
                break
        # re-check the bound when revisiting (incumbent may have improved)
        elif (t + (need - saved) * suffix_ratio[li] >= best_time
              or t + frac_bound(li, need - saved) >= best_time):
            counts[li] = 0
            continue
        c = c_max_at(li, rem, saved) - bi
        if c < 0:                             # branches exhausted
            counts[li] = 0
            continue
        _, m, sav, ext, k, _ = levels[li]
        counts[li] = c
        stack.append((li, rem, saved, t, bi + 1))   # resume point
        stack.append((li + 1, rem - c, saved + c * sav, t + c * ext, 0))

    if best_counts is None:
        return list(inc_choice), nodes
    choice: List[Optional[str]] = [None] * n
    ptr = {gi: 0 for gi in range(len(glist))}
    for li, c in enumerate(best_counts):
        gi, m, sav, ext, k, is_first = levels[li]
        idxs = glist[gi][0]
        for _ in range(c):
            choice[idxs[ptr[gi]]] = m
            ptr[gi] += 1
    return choice, nodes


# ---------------------------------------------------------------------------
# Solver 2: exact knapsack-cover DP (beyond paper), vectorized
# ---------------------------------------------------------------------------

def _solve_knapsack(items: List[SliceItem], need: float,
                    quantum: float = 16 * 2**20
                    ) -> Tuple[List[Optional[str]], int]:
    """DP over discretized memory saving. Savings are rounded DOWN (so a
    'covered' answer is truly feasible); `need` is rounded up.

    The relaxation is row-vectorized with numpy: one strided
    minimum-update per (item, mode) instead of a Python loop over every
    cell, and the n x cap parent table is an int8 mode index (plus one
    int per item for the saturated top cell) instead of a list of
    (state, mode) tuples. Returns (choice, cells_relaxed).
    """
    n = len(items)
    if need <= 0:
        return [None] * n, 0
    cap = int(-(-need // quantum))          # ceil
    mode_lists = [list(it.savings) for it in items]
    q_best = [max((int(sav // quantum) for sav in it.savings.values()),
                  default=0) for it in items]
    if sum(q_best) < cap:
        # uncoverable even at full sharding (the saturating DP could
        # never reach the cap cell): same fallback, without the table
        return [max(it.savings, key=it.savings.get) for it in items], 0

    INF = float("inf")
    dp = np.full(cap + 1, INF)
    dp[0] = 0.0
    pmode = np.full((n, cap + 1), -1, dtype=np.int8)
    pcap = np.full(n, -1, dtype=np.int64)   # source state for cap updates
    cells = 0
    for i, it in enumerate(items):
        ndp = dp.copy()
        row = pmode[i]
        for mi, m in enumerate(mode_lists[i]):
            q = int(it.savings[m] // quantum)
            if q == 0:
                continue
            t = it.extra_time[m]
            cells += int(np.isfinite(dp).sum())
            if q <= cap and cap - q >= 1:
                # exact targets: state s -> s + q for s in [0, cap-q)
                cand = dp[:cap - q] + t
                tgt = ndp[q:cap]
                imp = cand < tgt
                if imp.any():
                    tgt[imp] = cand[imp]
                    row[q:cap][imp] = mi
            # states [max(0, cap-q), cap] all saturate into the cap
            # cell; the winner is the first minimum (strict-improvement
            # sweep order of the scalar implementation)
            lo = max(0, cap - q)
            window = dp[lo:]
            j = int(np.argmin(window))
            v = window[j] + t
            if v < ndp[cap]:
                ndp[cap] = v
                row[cap] = mi
                pcap[i] = lo + j
        dp = ndp
    if not np.isfinite(dp[cap]):
        return [max(it.savings, key=it.savings.get) for it in items], cells
    # backtrack
    choice: List[Optional[str]] = [None] * n
    s = cap
    for i in range(n - 1, -1, -1):
        mi = int(pmode[i, s])
        if mi < 0:
            continue
        m = mode_lists[i][mi]
        choice[i] = m
        if s == cap:
            s = int(pcap[i])
        else:
            s -= int(items[i].savings[m] // quantum)
    return choice, cells


# ---------------------------------------------------------------------------
# Solver 3: greedy ratio heuristic
# ---------------------------------------------------------------------------

def _solve_greedy(items: List[SliceItem],
                  need: float) -> Tuple[List[Optional[str]], float]:
    n = len(items)
    choice: List[Optional[str]] = [None] * n
    if need <= 0:
        return choice, 0.0
    ranked = []
    for i, it in enumerate(items):
        m = _best_mode(it)
        ranked.append((it.extra_time[m] / max(it.savings[m], 1e-9), i, m))
    ranked.sort()
    saved = t = 0.0
    for _, i, m in ranked:
        if saved >= need:
            break
        choice[i] = m
        saved += items[i].savings[m]
        t += items[i].extra_time[m]
    return choice, (t if saved >= need else float("inf"))


# ---------------------------------------------------------------------------
# Search Engine: reusable context + fixed-b solve
# ---------------------------------------------------------------------------

class _SearchContext:
    """Everything batch-independent about one search problem.

    Items (per-slice savings / extra-time) and the PlanEvaluator tables
    depend only on (description, env, osdp); the Scheduler's batch sweep
    and search_hybrid's factorization sweep re-use one context instead
    of rebuilding them per candidate — only the batch-linear activation
    and compute terms change between solves.
    """

    def __init__(self, desc: ModelDescription, env: CostEnv,
                 osdp: OSDPConfig):
        self.desc = desc
        self.env = env
        self.osdp = osdp
        self.selective = osdp.selective_remat
        if self.selective and env.checkpointing:
            raise ValueError(
                "selective remat expects CostEnv(checkpointing=False): "
                "the search's base plan keeps activations and turns "
                "remat on per slice")
        self.items = _build_items(desc, env, osdp)
        self._has_slopes = any(it.savings_slope or it.extra_time_slope
                               for it in self.items)
        gran = {it.op_name: it.n_slices for it in self.items}
        self.ev = PlanEvaluator(desc, env, gran)
        op_index = {name: k for k, name in enumerate(self.ev.op_names)}
        self.item_slice = np.array(
            [int(self.ev.op_start[op_index[it.op_name]]) + it.slice_idx
             for it in self.items], dtype=np.int64)
        self.mode_idx = self.ev.mode_index
        # per-group memory limits: uniform clusters use the config's
        # limit; heterogeneous clusters bind at the worst group (its
        # hbm_bytes is its budget — see ClusterSpec.memory_limit)
        self.limit = env.topo.memory_limit(osdp.memory_limit_bytes)
        # hierarchical topologies get the stronger upgrade repair (the
        # solver's level-k mixes overshoot the item model's savings
        # more often); flat envs — including the flat single-level
        # residues search_hybrid builds on the legacy no-cluster path —
        # keep the legacy repair semantics bit-for-bit
        # (BENCH_search.json decisions are pinned on them).  A topology
        # is "hierarchical" exactly when it offers level-k items.
        self._upgrade_repair = (env.cluster is not None
                                and bool(env.topo.shard_levels))

    def _mirror_items(self, remat_on: bool) -> Tuple[List[SliceItem],
                                                     np.ndarray]:
        """Legacy 2-mode items for a uniform-remat mirror problem
        (lazily built and cached), plus their evaluator slice map."""
        attr = "_mirror_on" if remat_on else "_mirror_off"
        cached = getattr(self, attr, None)
        if cached is not None:
            return cached
        env = dataclasses.replace(self.env, checkpointing=remat_on)
        osdp = dataclasses.replace(self.osdp, checkpointing=remat_on)
        items = _build_items(self.desc, env, osdp)
        op_index = {name: k for k, name in enumerate(self.ev.op_names)}
        item_slice = np.array(
            [int(self.ev.op_start[op_index[it.op_name]]) + it.slice_idx
             for it in items], dtype=np.int64)
        if any(int(it.n_slices) != int(
                self.ev.granularity[op_index[it.op_name]])
                for it in items):
            raise ValueError("mirror granularity mismatch")
        setattr(self, attr, (items, item_slice))
        return items, item_slice

    def _ext_index(self, choice_key: str, state_map) -> int:
        """Extended evaluator column for one item choice key."""
        m, r = _parse_key(choice_key)
        return self.mode_idx[m] + self.ev.n_modes * state_map(r)

    def _solve_once(self, global_batch: int, items: List[SliceItem],
                    item_slice: np.ndarray, base_modes: np.ndarray,
                    need: float, state_map, solver: str,
                    node_budget: int,
                    quantum: Optional[float] = None) -> SearchResult:
        """One covering solve + repair on a prepared problem.

        `base_modes` is the extended-mode array the choices overlay;
        `state_map` maps each choice key's remat flag to the evaluator
        remat state (inherit for legacy runs, explicit off/on for
        selective and the uniform mirrors).
        """
        limit = self.limit
        ilp = None
        if solver == "dfs":
            choice, nodes = _solve_dfs(items, need, node_budget)
        elif solver == "knapsack":
            choice, nodes = (_solve_knapsack(items, need, quantum)
                             if quantum else _solve_knapsack(items, need))
        elif solver == "greedy":
            choice, _ = _solve_greedy(items, need)
            nodes = len(items)
        elif solver == "ilp":
            ilp = solve_ilp(items, need,
                            time_budget=self.osdp.ilp_time_budget_s,
                            backend=self.osdp.ilp_backend,
                            node_budget=node_budget)
            choice, nodes = list(ilp.choice), ilp.nodes
        else:
            raise ValueError(f"unknown solver {solver!r}")

        def modes_of(ch):
            modes = base_modes.copy()
            for i, c in enumerate(ch):
                if c is not None:
                    modes[item_slice[i]] = self._ext_index(c, state_map)
            return modes

        ev = self.ev
        ev.begin(modes_of(choice), global_batch)

        # Repair: per-slice savings are exact for uniform runs but
        # slightly optimistic for mixed ones (each ZDP run re-gathers a
        # slice), so the Profiler's evaluation can come out a hair over
        # the limit. Flip the cheapest remaining base slices until the
        # evaluation fits — each flip is an O(1) evaluator delta, and
        # under selective remat it may flip remat independently of
        # sharding (whatever the item's cheapest remaining choice is).
        if ev.memory > limit:
            remaining = sorted(
                (i for i, c in enumerate(choice) if c is None),
                key=lambda i: _best_ratio(items[i]))
            for i in remaining:
                m = _best_mode(items[i])
                choice[i] = m
                ev.flip(int(item_slice[i]), self._ext_index(m, state_map))
                if ev.memory <= limit:
                    break
            if ev.memory > limit and self._upgrade_repair:
                # upgrade already-chosen slices toward their max-saving
                # mode, cheapest marginal dT/dM first (each flip exact
                # through the evaluator) — on hierarchical topologies
                # the solver's cover often mixes level-k modes whose
                # per-run re-gathers the item model cannot see, and
                # escalating straight to the all-max plan would throw
                # the whole mix away
                upgrades = []
                for i, c in enumerate(choice):
                    it = items[i]
                    best = max(it.savings, key=it.savings.get)
                    if c == best:
                        continue
                    dsav = it.savings[best] - (it.savings[c] if c else 0.0)
                    if dsav <= 0:
                        continue
                    dt = (it.extra_time[best]
                          - (it.extra_time[c] if c else 0.0))
                    upgrades.append((dt / dsav, i, best))
                upgrades.sort()
                for _, i, best in upgrades:
                    choice[i] = best
                    ev.flip(int(item_slice[i]),
                            self._ext_index(best, state_map))
                    if ev.memory <= limit:
                        break
            if ev.memory > limit:
                # escalate every slice to its max-saving mode (ZDP,
                # remat'd under selective) — the most-sharded plan is
                # the feasibility frontier
                choice = [max(it.savings, key=it.savings.get)
                          for it in items]
                ev.begin(modes_of(choice), global_batch)

        cost = ev.result()
        decisions = ev.decisions(ev.current_modes)
        res = SearchResult(decisions, cost, global_batch,
                           bool(cost.memory <= limit), self.osdp.search,
                           0.0, nodes)
        if ilp is not None:
            res.lower_bound = ilp.lower_bound
            res.proven_optimal = ilp.optimal
            res.solver_backend = ilp.backend
        return res

    def solve(self, global_batch: int) -> SearchResult:
        t0 = _time.perf_counter()
        osdp = self.osdp
        limit = self.limit
        bpd = self.ev._bpd(global_batch)
        n_m = self.ev.n_modes

        if not self.selective:
            base = np.zeros(self.ev.n_slices, dtype=np.int8)
            need = self.ev.all_dp_memory(global_batch) - limit
            res = self._solve_once(
                global_batch, self.items, self.item_slice, base, need,
                lambda r: REMAT_INHERIT, osdp.search, 2_000_000)
            res.search_seconds = _time.perf_counter() - t0
            return res

        # Selective remat solves three covering problems and keeps the
        # best: the full 4-mode search (bounded B&B effort — near the
        # feasibility frontier the 5-choice tree is genuinely hard),
        # plus the two uniform-remat mirrors (cheap legacy 2-mode
        # problems evaluated on the explicit columns).  The mirrors
        # guarantee the selective plan never loses to either global
        # checkpointing setting, whatever the solver budget did.
        base_off = np.zeros(self.ev.n_slices, dtype=np.int8)
        base_off[self.item_slice] = n_m * REMAT_OFF
        need_off = self.ev.all_dp_memory(global_batch, False) - limit
        items = (_materialize_items(self.items, bpd)
                 if self._has_slopes else self.items)
        # per-slice remat savings can be far below the legacy 16 MiB
        # knapsack quantum (one slice of one layer's activations), and
        # each item loses up to one quantum to round-down — so the
        # 4-mode knapsack sizes its grid from the coverage headroom:
        # n/2 expected quanta of loss must fit inside it, else a
        # coverable need quantizes to "uncoverable"
        quantum = None
        if need_off > 0 and items:
            headroom = (sum(max(it.savings.values()) for it in items)
                        - need_off)
            quantum = min(16 * 2.0**20,
                          max(2.0**16, headroom / len(items),
                              need_off / 65536))
        best = self._solve_once(
            global_batch, items, self.item_slice, base_off, need_off,
            lambda r: REMAT_ON if r else REMAT_OFF, osdp.search, 10_000,
            quantum)
        nodes = best.nodes_visited

        mirrors = [(False, base_off, need_off)]
        base_on = base_off.copy()
        base_on[self.item_slice] = n_m * REMAT_ON
        mirrors.append((True, base_on,
                        self.ev.all_dp_memory(global_batch, True) - limit))
        for remat_on, base, need in mirrors:
            m_items, m_slice = self._mirror_items(remat_on)
            st = REMAT_ON if remat_on else REMAT_OFF
            res = self._solve_once(
                global_batch, m_items, m_slice, base, need,
                lambda r, st=st: st, osdp.search, 2_000_000)
            nodes += res.nodes_visited
            if (res.feasible and
                    (not best.feasible
                     or res.cost.throughput > best.cost.throughput)):
                best = res
        best.nodes_visited = nodes
        best.search_seconds = _time.perf_counter() - t0
        return best


def search_plan(desc: ModelDescription, global_batch: int, env: CostEnv,
                osdp: OSDPConfig) -> SearchResult:
    if osdp.force_mode:
        t0 = _time.perf_counter()
        dec = uniform_plan(
            desc, osdp.force_mode,
            osdp.default_slice_granularity if osdp.operator_splitting else 1)
        cost = plan_cost(desc, dec, global_batch, env)
        # feasibility is judged on steady memory, same as the searched
        # path below (transient peaks stay visible in cost.peak_memory)
        limit = env.topo.memory_limit(osdp.memory_limit_bytes)
        return SearchResult(dec, cost, global_batch,
                            cost.memory <= limit,
                            f"forced:{osdp.force_mode}",
                            _time.perf_counter() - t0)
    return _SearchContext(desc, env, osdp).solve(global_batch)


# ---------------------------------------------------------------------------
# Scheduler: batch-size sweep (Algorithm 1 outer loop)
# ---------------------------------------------------------------------------

def schedule(desc: ModelDescription, env: CostEnv, osdp: OSDPConfig,
             batch_candidates: Optional[Sequence[int]] = None,
             max_batch: int = 4096) -> SearchResult:
    t0 = _time.perf_counter()
    best: Optional[SearchResult] = None
    first: Optional[SearchResult] = None
    cands: List[Tuple[int, float]] = []
    batches = (list(batch_candidates) if batch_candidates is not None
               else _default_batches(max_batch, env))
    if not batches:
        raise ValueError("empty batch_candidates")
    ctx = None if osdp.force_mode else _SearchContext(desc, env, osdp)
    for b in batches:
        res = ctx.solve(b) if ctx is not None \
            else search_plan(desc, b, env, osdp)
        if first is None:
            first = res
        if not res.feasible:
            # Algorithm 1 line 12–14: all plans exceed the limit -> stop
            if best is not None:
                break
            continue
        cands.append((b, res.cost.throughput))
        if best is None or res.cost.throughput > best.cost.throughput:
            best = res
    if best is None:
        # nothing fits even fully sharded: the first candidate's result
        # is already the most-sharded plan — reuse it instead of paying
        # a duplicate solve
        best = first
    best.candidates = cands
    best.search_seconds = _time.perf_counter() - t0
    return best


def _default_batches(max_batch: int, env: CostEnv) -> List[int]:
    # per-device microbatch 1,2,3,... like Algorithm 1's b in {1,2,3,...}
    n = env.n_data
    out = []
    b = n
    while b <= max_batch:
        out.append(b)
        b += n
    return out or [n]


# ---------------------------------------------------------------------------
# Serving Scheduler: sharding + concurrency under the KV-cache budget
# ---------------------------------------------------------------------------

@dataclass
class ServePlan:
    """A searched serving configuration: per-slice sharding decisions
    plus the KV-budget admission limit.

    `slots_per_device` is the throughput-argmax concurrency;
    `max_slots_per_device` is the largest concurrency that still fits
    the memory limit under the (same-search) plan — the continuous
    engine's admission limit.  `candidates` records every probed
    (slots, output tokens/s) pair, the serving analogue of Algorithm
    1's P set."""

    model_name: str
    workload: ServingWorkload
    decisions: Dict[str, Decision]
    cost: ServingCost
    slots_per_device: int
    max_slots_per_device: int
    max_concurrency: int
    feasible: bool
    solver: str
    search_seconds: float
    nodes_visited: int = 0
    candidates: List[Tuple[int, float]] = field(default_factory=list)
    inner: Optional[SearchResult] = None
    # fleet generalization: the mix the plan was searched for and its
    # exact per-class economics (None on the legacy single-workload
    # path — a single-class mix routes through that path byte-for-byte)
    mix: Optional[RequestClassMix] = None
    class_costs: Optional[Dict[str, ServingCost]] = None

    def summary(self) -> str:
        c = self.cost
        n_zdp = sum(1 for d in self.decisions.values()
                    if d.uniform() not in (DP, None))
        n_mixed = sum(1 for d in self.decisions.values()
                      if d.uniform() is None)
        return "\n".join([
            f"serve-plan[{self.model_name} p{self.workload.prompt_len}"
            f"+d{self.workload.decode_len}] ops={len(self.decisions)} "
            f"zdp={n_zdp} mixed={n_mixed} "
            f"({'feasible' if self.feasible else 'INFEASIBLE'})",
            f"  concurrency = {c.concurrency} in flight "
            f"({c.slots_per_device} slots/device, admission limit "
            f"{self.max_concurrency})",
            f"  est memory/device = {c.memory / 2**30:.2f} GiB "
            f"(weights {c.weight_memory / 2**30:.2f}, cache/seq "
            f"{c.cache_bytes_per_seq / 2**20:.1f} MiB)",
            f"  est ttft = {c.ttft * 1e3:.2f} ms, tpot = "
            f"{c.tpot * 1e3:.3f} ms, request latency = "
            f"{c.request_latency * 1e3:.1f} ms",
            f"  est throughput = {c.throughput:.0f} output tok/s",
        ])


def search_serve(model: ModelConfig, workload: WorkloadLike,
                 env: CostEnv, osdp: OSDPConfig, max_slots: int = 512,
                 slot_candidates: Optional[Sequence[int]] = None
                 ) -> ServePlan:
    """Search the serving plan space: per-slice sharding x concurrency.

    The inner problem at a fixed per-device concurrency `s` is exactly
    the training search with the KV budget folded into the limit — the
    caches of `s` admitted sequences are mode-independent, so the
    sharding cover problem runs against `M_limit - s * cache_seq` on
    the decode-shaped description (the phase whose step time the
    sharding actually taxes) and reuses the existing solvers and
    `PlanEvaluator` tables across the whole sweep.  Every probed plan
    is then re-scored with `serving_plan_cost` (both phases + HBM
    floors + the cache term), and the sweep keeps the throughput
    argmax plus the largest feasible concurrency (the admission
    limit).  Without explicit `slot_candidates` the sweep doubles
    until infeasible, then bisects the frontier.

    `workload` may also be a `RequestClassMix`: a single-class mix is
    an exact alias of its `ServingWorkload` (same path, byte-identical
    plan); a multi-class mix prices every probe per class through
    `serving_mix_cost` and keeps the aggregate-throughput argmax.
    """
    t0 = _time.perf_counter()
    if env.train:
        raise ValueError("search_serve needs a train=False CostEnv")
    if env.checkpointing:
        raise ValueError("serving env must not checkpoint "
                         "(CostEnv(checkpointing=False)): inference "
                         "keeps no activations to rematerialize")
    if osdp.selective_remat:
        raise ValueError("serving has no backward pass to rematerialize: "
                         "use checkpointing=False")
    mix: Optional[RequestClassMix] = None
    if isinstance(workload, RequestClassMix):
        mix = workload
        if len(mix) > 1:
            return _search_serve_mix(model, mix, env, osdp, max_slots,
                                     slot_candidates)
        workload = mix.classes[0].workload()
    pre_shape = ShapeConfig("serve_prefill", workload.prompt_len,
                            env.n_data, "prefill")
    dec_shape = ShapeConfig("serve_decode", 1, env.n_data, "decode")
    desc_pre = describe(model, pre_shape)
    desc_dec = describe(model, dec_shape)
    limit = env.topo.memory_limit(osdp.memory_limit_bytes)
    cache_seq = desc_dec.cache_bytes_per_seq(workload.cache_len, env.n_tp)

    ctx = None if osdp.force_mode else _SearchContext(desc_dec, env, osdp)
    base_limit = ctx.limit if ctx is not None else limit
    # the evaluator charges the training act term (every layer's
    # activations x batch); inference holds one layer + the residual
    # stream (`inference_act_bytes`), so the folded limit swaps one for
    # the other — per-slot slopes, both linear in the concurrency
    act_ev_slope = (desc_dec.resident_act_bytes_per_token
                    + sum(op.act_bytes_per_token
                          for op in desc_dec.operators)) / env.n_tp
    nodes = 0
    evals: Dict[int, Tuple[Dict[str, Decision], Optional[SearchResult],
                           ServingCost, bool]] = {}

    def probe(slots: int):
        nonlocal nodes
        if slots in evals:
            return evals[slots]
        if ctx is None:
            g = (osdp.default_slice_granularity
                 if osdp.operator_splitting else 1)
            decisions = uniform_plan(desc_dec, osdp.force_mode, g)
            res = None
        else:
            # fold the KV budget into the limit (caches are
            # mode-independent, so this is exact) and correct the
            # training-vs-inference activation gap
            act_inf = inference_act_bytes(desc_dec, env, slots, 1)
            ctx.limit = max(0.0, base_limit - slots * cache_seq
                            - act_inf + act_ev_slope * slots)
            res = ctx.solve(slots * env.n_data)
            decisions = res.decisions
            nodes += res.nodes_visited
        sc = serving_plan_cost(desc_pre, desc_dec, decisions, workload,
                               env, slots)
        ok = sc.memory <= limit
        evals[slots] = (decisions, res, sc, ok)
        return evals[slots]

    probed: List[int] = []
    if slot_candidates is not None:
        probed = sorted({max(1, int(s)) for s in slot_candidates})
        for s in probed:
            probe(s)
    else:
        s, last_ok, first_bad = 1, 0, None
        while s <= max_slots:
            probed.append(s)
            if probe(s)[3]:
                last_ok = s
            else:
                first_bad = s
                break
            s *= 2
        if first_bad is None and probed and probed[-1] != max_slots:
            probed.append(max_slots)
            if probe(max_slots)[3]:
                last_ok = max_slots
            else:
                first_bad = max_slots
        if first_bad is not None and last_ok:
            lo, hi = last_ok, first_bad
            while hi - lo > 1:          # bisect the admission frontier
                mid = (lo + hi) // 2
                probed.append(mid)
                if probe(mid)[3]:
                    lo = mid
                else:
                    hi = mid

    if ctx is not None:
        ctx.limit = base_limit
    feas = [s for s in evals if evals[s][3]]
    max_feas = max(feas) if feas else 0
    if feas:
        best_slots = max(feas, key=lambda s: evals[s][2].throughput)
        feasible = True
    else:
        best_slots = min(evals)     # most-sharded repair plan at slots=1
        feasible = False
    decisions, res, sc, _ = evals[best_slots]
    return ServePlan(
        model_name=model.name, workload=workload, decisions=decisions,
        cost=sc, slots_per_device=best_slots if feasible else 0,
        max_slots_per_device=max_feas,
        max_concurrency=max_feas * env.n_data,
        feasible=feasible,
        solver=(f"forced:{osdp.force_mode}" if osdp.force_mode
                else osdp.search),
        search_seconds=_time.perf_counter() - t0,
        nodes_visited=nodes,
        candidates=sorted((s, evals[s][2].throughput if evals[s][3]
                           else 0.0) for s in evals),
        inner=res,
        mix=mix,
        class_costs=({mix.classes[0].name: sc} if mix is not None
                     else None))


def _blend_mix_cost(mix: RequestClassMix,
                    mc: MixServingCost) -> ServingCost:
    """Aggregate display `ServingCost` for a mix plan: latency figures
    are arrival-rate weighted means, throughput/memory the aggregate /
    binding figures (exact per-class numbers live in
    `ServePlan.class_costs`)."""
    total = mix.total_rate
    w = {c.name: c.arrival_rate / total for c in mix.classes}

    def mean(attr):
        return sum(w[n] * getattr(sc, attr)
                   for n, sc in mc.per_class.items())

    return ServingCost(
        weight_memory=mc.weight_memory,
        cache_bytes_per_seq=mc.cache_bytes_per_slot,
        slots_per_device=mc.slots_per_device,
        concurrency=mc.concurrency,
        memory=mc.memory,
        prefill_time=mean("prefill_time"),
        decode_step_time=mc.decode_step_time,
        ttft=mean("ttft"),
        tpot=mc.decode_step_time,
        request_latency=mean("request_latency"),
        throughput=mc.throughput)


def _search_serve_mix(model: ModelConfig, mix: RequestClassMix,
                      env: CostEnv, osdp: OSDPConfig, max_slots: int,
                      slot_candidates: Optional[Sequence[int]]
                      ) -> ServePlan:
    """The multi-class body of `search_serve`: same sweep, but every
    probe folds the *expected* (slot-share weighted) cache bytes into
    the solver limit and is priced per class with `serving_mix_cost`;
    the argmax is the aggregate output-token throughput."""
    t0 = _time.perf_counter()
    dec_shape = ShapeConfig("serve_decode", 1, env.n_data, "decode")
    desc_dec = describe(model, dec_shape)
    desc_pres: Dict[int, ModelDescription] = {}
    for c in mix.classes:
        if c.prompt_len not in desc_pres:
            desc_pres[c.prompt_len] = describe(
                model, ShapeConfig("serve_prefill", c.prompt_len,
                                   env.n_data, "prefill"))
    limit = env.topo.memory_limit(osdp.memory_limit_bytes)
    cache_exp = sum(
        mix.slot_share(c)
        * desc_dec.cache_bytes_per_seq(c.cache_len, env.n_tp)
        for c in mix.classes)

    ctx = None if osdp.force_mode else _SearchContext(desc_dec, env, osdp)
    base_limit = ctx.limit if ctx is not None else limit
    act_ev_slope = (desc_dec.resident_act_bytes_per_token
                    + sum(op.act_bytes_per_token
                          for op in desc_dec.operators)) / env.n_tp
    nodes = 0
    evals: Dict[int, Tuple[Dict[str, Decision], Optional[SearchResult],
                           MixServingCost, bool]] = {}

    def probe(slots: int):
        nonlocal nodes
        if slots in evals:
            return evals[slots]
        if ctx is None:
            g = (osdp.default_slice_granularity
                 if osdp.operator_splitting else 1)
            decisions = uniform_plan(desc_dec, osdp.force_mode, g)
            res = None
        else:
            act_inf = inference_act_bytes(desc_dec, env, slots, 1)
            ctx.limit = max(0.0, base_limit - slots * cache_exp
                            - act_inf + act_ev_slope * slots)
            res = ctx.solve(slots * env.n_data)
            decisions = res.decisions
            nodes += res.nodes_visited
        mc = serving_mix_cost(desc_pres, desc_dec, decisions, mix, env,
                              slots)
        ok = mc.memory <= limit
        evals[slots] = (decisions, res, mc, ok)
        return evals[slots]

    probed: List[int] = []
    if slot_candidates is not None:
        probed = sorted({max(1, int(s)) for s in slot_candidates})
        for s in probed:
            probe(s)
    else:
        s, last_ok, first_bad = 1, 0, None
        while s <= max_slots:
            probed.append(s)
            if probe(s)[3]:
                last_ok = s
            else:
                first_bad = s
                break
            s *= 2
        if first_bad is None and probed and probed[-1] != max_slots:
            probed.append(max_slots)
            if probe(max_slots)[3]:
                last_ok = max_slots
            else:
                first_bad = max_slots
        if first_bad is not None and last_ok:
            lo, hi = last_ok, first_bad
            while hi - lo > 1:
                mid = (lo + hi) // 2
                probed.append(mid)
                if probe(mid)[3]:
                    lo = mid
                else:
                    hi = mid

    if ctx is not None:
        ctx.limit = base_limit
    feas = [s for s in evals if evals[s][3]]
    max_feas = max(feas) if feas else 0
    if feas:
        best_slots = max(feas, key=lambda s: evals[s][2].throughput)
        feasible = True
    else:
        best_slots = min(evals)
        feasible = False
    decisions, res, mc, _ = evals[best_slots]
    return ServePlan(
        model_name=model.name, workload=mix.workload(),
        decisions=decisions, cost=_blend_mix_cost(mix, mc),
        slots_per_device=best_slots if feasible else 0,
        max_slots_per_device=max_feas,
        max_concurrency=max_feas * env.n_data,
        feasible=feasible,
        solver=(f"forced:{osdp.force_mode}" if osdp.force_mode
                else osdp.search),
        search_seconds=_time.perf_counter() - t0,
        nodes_visited=nodes,
        candidates=sorted((s, evals[s][2].throughput if evals[s][3]
                           else 0.0) for s in evals),
        inner=res,
        mix=mix,
        class_costs=dict(mc.per_class))


def rescore_serve_plan(model: ModelConfig, workload: WorkloadLike,
                       decisions: Dict[str, Decision], env: CostEnv,
                       osdp: OSDPConfig, slots: int
                       ) -> Tuple[ServingCost, bool]:
    """Re-score an existing serving plan's decisions against a (possibly
    different) environment: (cost, fits-memory).

    This is the resilience supervisor's feasibility check after a
    device loss — a plan searched on the healthy cluster is re-costed
    verbatim on the degraded `CostEnv` (whose `topo.memory_limit` has
    typically tightened) to decide whether the survivors can keep
    running it, or whether a fresh `search_serve` is required.  No
    solver runs: only the analytical cost model.

    A multi-class `RequestClassMix` re-scores through
    `serving_mix_cost` (returning the blended aggregate cost); a
    single-class mix is the exact `ServingWorkload` alias."""
    if isinstance(workload, RequestClassMix):
        if len(workload) > 1:
            dec_shape = ShapeConfig("serve_decode", 1, env.n_data,
                                    "decode")
            desc_dec = describe(model, dec_shape)
            desc_pres = {
                c.prompt_len: describe(model, ShapeConfig(
                    "serve_prefill", c.prompt_len, env.n_data,
                    "prefill"))
                for c in workload.classes}
            limit = env.topo.memory_limit(osdp.memory_limit_bytes)
            mc = serving_mix_cost(desc_pres, desc_dec, decisions,
                                  workload, env, max(1, int(slots)))
            return _blend_mix_cost(workload, mc), mc.memory <= limit
        workload = workload.classes[0].workload()
    pre_shape = ShapeConfig("serve_prefill", workload.prompt_len,
                            env.n_data, "prefill")
    dec_shape = ShapeConfig("serve_decode", 1, env.n_data, "decode")
    desc_pre = describe(model, pre_shape)
    desc_dec = describe(model, dec_shape)
    limit = env.topo.memory_limit(osdp.memory_limit_bytes)
    sc = serving_plan_cost(desc_pre, desc_dec, decisions, workload,
                           env, max(1, int(slots)))
    return sc, sc.memory <= limit


# ---------------------------------------------------------------------------
# Fleet Scheduler: replica count x per-group plan x per-class routing
# ---------------------------------------------------------------------------

@dataclass
class ReplicaGroup:
    """`n_replicas` identical serving replicas carved out of one pool
    (a heterogeneous `DeviceGroup`, or the whole uniform fleet), each
    running `plan` on the `cluster` sub-spec and serving the named
    request classes."""

    name: str
    n_replicas: int
    devices_per_replica: int
    cluster: ClusterSpec
    plan: ServePlan
    classes: Tuple[str, ...]

    @property
    def capacity_tokens_per_s(self) -> float:
        """Aggregate planned output tokens/s across the replicas."""
        return self.n_replicas * self.plan.cost.throughput

    def class_capacity(self, name: str) -> float:
        """Planned output tokens/s the group allots to one class."""
        if self.plan.class_costs and name in self.plan.class_costs:
            return (self.n_replicas
                    * self.plan.class_costs[name].throughput)
        return self.capacity_tokens_per_s if name in self.classes else 0.0


@dataclass
class FleetPlan:
    """A searched fleet configuration: replica groups (each with its
    own `ServePlan`), a class -> group routing table, and per-class
    admission limits (max in-flight + queued requests fleet-wide —
    2x the planned steady-state slot allocation).

    `goodput` is the planned satisfied load Σ_c min(offered_c,
    capacity_c) in output tokens/s; `slo_attained` is the analytic
    per-class check (phase latencies within target AND capacity covers
    the offered load).  The traffic simulator
    (`repro.serving.simulator`) is the measured-under-load validator
    of both claims."""

    model_name: str
    mix: RequestClassMix
    cluster: ClusterSpec
    strategy: str                       # "slo" | "uniform"
    groups: List[ReplicaGroup]
    routing: Dict[str, Dict[str, float]]
    admission: Dict[str, int]
    slo_attained: Dict[str, bool]
    feasible: bool
    throughput: float
    goodput: float
    search_seconds: float

    @property
    def n_replicas(self) -> int:
        return sum(g.n_replicas for g in self.groups)

    @property
    def n_slo_attained(self) -> int:
        return sum(1 for ok in self.slo_attained.values() if ok)

    def summary(self) -> str:
        lines = [
            f"fleet-plan[{self.model_name} {self.strategy}] "
            f"{self.n_replicas} replicas in {len(self.groups)} groups "
            f"({'feasible' if self.feasible else 'INFEASIBLE'}), "
            f"SLO {self.n_slo_attained}/{len(self.mix)} classes",
            f"  planned capacity = {self.throughput:.0f} tok/s, "
            f"satisfied load = {self.goodput:.0f} of "
            f"{self.mix.offered_tokens_per_s:.0f} tok/s offered",
        ]
        for g in self.groups:
            lines.append(
                f"  group {g.name}: {g.n_replicas} x "
                f"{g.devices_per_replica} devices, "
                f"{g.plan.max_slots_per_device} slots/device, "
                f"classes [{', '.join(g.classes)}], "
                f"{g.capacity_tokens_per_s:.0f} tok/s")
        adm = ", ".join(f"{k}<={v}" for k, v in self.admission.items())
        lines.append(f"  admission (in-flight + queued): {adm}")
        return "\n".join(lines)


def _fleet_pools(cluster: ClusterSpec
                 ) -> List[Tuple[str, ClusterSpec]]:
    """Partition a fleet into uniform pools: one per heterogeneous
    `DeviceGroup` (groups split at the outermost level, so each pool
    keeps the inner levels and scales the outer fan-out), or the whole
    cluster when it is already uniform."""
    if not cluster.groups:
        return [("fleet", cluster)]
    inner = math.prod(l.ways for l in cluster.levels[:-1])
    pools = []
    for g in cluster.groups:
        dev = dataclasses.replace(cluster.device, hbm_bytes=g.hbm_bytes)
        if g.peak_flops > 0:
            dev = dataclasses.replace(dev, peak_flops=g.peak_flops)
        if inner > 0 and g.n_devices % inner == 0 \
                and g.n_devices >= inner:
            levels = cluster.levels[:-1] + (dataclasses.replace(
                cluster.levels[-1], ways=g.n_devices // inner),)
        else:
            # the group does not tile the inner levels: flatten it
            levels = (dataclasses.replace(cluster.levels[0],
                                          ways=g.n_devices),)
        pools.append((g.name, ClusterSpec(levels=tuple(levels),
                                          device=dev)))
    return pools


def _replica_counts(pool: ClusterSpec,
                    candidates: Optional[Sequence[int]]) -> List[int]:
    """Admissible replica counts for a pool: the requested candidates
    (or powers of two up to the pool size) that `consume_outer`
    accepts — replicas are independent engines, so they split at the
    outermost level like pipeline stages."""
    if candidates is None:
        cands, r = [], 1
        while r <= pool.n_devices:
            cands.append(r)
            r *= 2
    else:
        cands = sorted({int(r) for r in candidates if r >= 1})
    out = []
    for r in cands:
        if r > pool.n_devices or pool.n_devices % r:
            continue
        try:
            pool.consume_outer(r)
        except ValueError:
            continue
        out.append(r)
    return out or [1]


def search_fleet(model: ModelConfig, mix: WorkloadLike,
                 cluster: ClusterSpec, osdp: OSDPConfig, *,
                 max_slots: int = 512,
                 replica_candidates: Optional[Sequence[int]] = None,
                 strategy: str = "slo") -> FleetPlan:
    """Search the fleet plan space: replica count x per-group plan x
    per-class routing/admission.

    The fleet is first partitioned into uniform pools (one per
    heterogeneous `DeviceGroup`, else the whole cluster); each pool
    may be split into `r` independent replicas (`consume_outer`, like
    pipeline stages — no collectives cross replicas).  The search then
    enumerates class -> pool assignments; every (pool, replica count,
    class subset) combination reuses `search_serve` on the
    per-replica sub-spec with the sub-mix routed there, and the winner
    maximizes (feasibility, #SLO-attained classes, satisfied load,
    capacity).

    `strategy="uniform"` is the baseline the fleet benchmark compares
    against: the whole cluster is split into identical replicas, every
    class routed everywhere — heterogeneity is ignored, so planning is
    bound by the worst group's memory and long-prompt classes share
    slots with latency-critical ones.  `strategy="slo"` plans each
    pool at its real budget and routes classes to the groups that can
    hold their SLOs."""
    t0 = _time.perf_counter()
    mix = RequestClassMix.of(mix)
    if strategy not in ("slo", "uniform"):
        raise ValueError(f"unknown fleet strategy {strategy!r}")
    if strategy == "uniform":
        pools = [("uniform", cluster)]
        assignments = [tuple(0 for _ in mix.classes)]
    else:
        pools = _fleet_pools(cluster)
        n_pools = len(pools)
        assignments = [(0,) * len(mix)] if n_pools == 1 else [
            tuple(a) for a in _np_cartesian(n_pools, len(mix))]

    offered = {c.name: c.arrival_rate * c.decode_len
               for c in mix.classes}
    pool_osdp = []
    for name, spec in pools:
        limit = (spec.device.hbm_bytes if cluster.groups
                 and strategy == "slo"
                 else osdp.memory_limit_bytes)
        pool_osdp.append(dataclasses.replace(
            osdp, memory_limit_bytes=limit))

    plan_cache: Dict[Tuple, ServePlan] = {}

    def pool_plan(pi: int, r: int, names: Tuple[str, ...]) -> ServePlan:
        key = (pi, r, names)
        if key not in plan_cache:
            rep = pools[pi][1].consume_outer(r)
            env = CostEnv(rep.device, None, checkpointing=False,
                          train=False, cluster=rep)
            plan_cache[key] = search_serve(
                model, mix.subset(names), env, pool_osdp[pi],
                max_slots=max_slots)
        return plan_cache[key]

    best = None        # (score, groups, routing, slo, thr, good, feas)
    for assign in assignments:
        by_pool: Dict[int, List[str]] = {}
        for ci, pi in enumerate(assign):
            by_pool.setdefault(pi, []).append(mix.classes[ci].name)
        groups: List[ReplicaGroup] = []
        slo: Dict[str, bool] = {}
        cap: Dict[str, float] = {}
        feas = True
        for pi, names in sorted(by_pool.items()):
            pname, pspec = pools[pi]
            names_t = tuple(names)
            sub = mix.subset(names_t)
            best_r = None
            for r in _replica_counts(pspec, replica_candidates):
                plan = pool_plan(pi, r, names_t)
                if not plan.feasible:
                    continue
                costs = plan.class_costs or {}
                r_slo, r_cap = {}, {}
                for c in sub.classes:
                    sc = costs.get(c.name, plan.cost)
                    r_cap[c.name] = r * sc.throughput
                    r_slo[c.name] = (
                        sc.ttft <= c.ttft_slo
                        and sc.tpot <= c.tpot_slo
                        and r_cap[c.name] + 1e-12 >= offered[c.name])
                score = (sum(r_slo.values()),
                         sum(min(offered[n], r_cap[n]) for n in names),
                         sum(r_cap.values()))
                if best_r is None or score > best_r[0]:
                    best_r = (score, r, plan, r_slo, r_cap)
            if best_r is None:
                # nothing fits this pool: keep the r=1 repair plan
                plan = pool_plan(pi, 1, names_t)
                groups.append(ReplicaGroup(
                    pname, 1, pspec.n_devices, pspec.consume_outer(1),
                    plan, names_t))
                for n in names:
                    slo[n], cap[n] = False, 0.0
                feas = False
                continue
            _, r, plan, r_slo, r_cap = best_r
            groups.append(ReplicaGroup(
                pname, r, pspec.n_devices // r, pspec.consume_outer(r),
                plan, names_t))
            slo.update(r_slo)
            cap.update(r_cap)
        thr = sum(g.capacity_tokens_per_s for g in groups
                  if g.plan.feasible)
        good = sum(min(offered[n], cap[n]) for n in offered)
        score = (feas, sum(slo.values()), good, thr)
        if best is None or score > best[0]:
            routing = {c.name: {g.name: 1.0 for g in groups
                                if c.name in g.classes}
                       for c in mix.classes}
            best = (score, groups, routing, slo, thr, good, feas)

    _, groups, routing, slo, thr, good, feas = best
    admission: Dict[str, int] = {}
    for c in mix.classes:
        alloc = 0.0
        for g in groups:
            if c.name not in g.classes:
                continue
            sub = RequestClassMix(tuple(
                k for k in mix.classes if k.name in g.classes))
            alloc += (g.n_replicas * g.plan.max_concurrency
                      * sub.slot_share(c))
        admission[c.name] = max(1, int(math.ceil(2.0 * alloc)))
    return FleetPlan(
        model_name=model.name, mix=mix, cluster=cluster,
        strategy=strategy, groups=groups, routing=routing,
        admission=admission, slo_attained=slo, feasible=feas,
        throughput=thr, goodput=good,
        search_seconds=_time.perf_counter() - t0)


def _np_cartesian(n_pools: int, n_classes: int):
    """All class -> pool assignments (n_pools ** n_classes tuples)."""
    grids = np.meshgrid(*([np.arange(n_pools)] * n_classes),
                        indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


# ---------------------------------------------------------------------------
# Hybrid Scheduler: (dp, tp, pp) factorization sweep ("3D+OSDP")
# ---------------------------------------------------------------------------

def search_hybrid(desc: ModelDescription, device: DeviceInfo,
                  n_devices: int, osdp: OSDPConfig,
                  batch_candidates: Optional[Sequence[int]] = None,
                  micro: int = 8,
                  candidates: Optional[Sequence[Factorization]] = None,
                  max_tp: int = 0, max_pp: int = 0,
                  cluster: Optional[ClusterSpec] = None,
                  profile=None) -> HybridPlan:
    """The paper's strongest configuration, "3D+OSDP", as a search.

    Sweeps every (dp, tp, pp) factorization of `n_devices` (or the
    given `candidates`); inside each, the DP dimension of the
    1/(tp*pp) model residue is decided by the existing Scheduler —
    i.e. the dfs/knapsack/greedy solvers, or a forced uniform mode
    when `osdp.force_mode` is set (force_mode="ZDP" reproduces plain
    DeepSpeed-style 3D; no force is 3D+OSDP).  Returns the global
    throughput argmax as a `HybridPlan`.

    Topology placement: with a `cluster` (hierarchical `ClusterSpec`),
    TP occupies the innermost levels (its per-layer activation
    all-reduces need the fastest links), PP the outermost (its
    point-to-point sends tolerate the slowest), and the DP dimension
    searches over the *residual* hierarchy — so the inner Scheduler
    sees level-k ZDP items and per-group memory limits of the actual
    data extent.  Factorizations that do not divide the level
    structure are skipped as inadmissible.  Without a `cluster` one is
    inferred from the device (`ClusterSpec.from_device`): flat devices
    keep the legacy all-ICI pricing; devices declaring
    `devices_per_node` get a node/cluster hierarchy, fixing the old
    path that charged `ici_bw` for TP groups spanning nodes.

    When the OSDP search is on with operator splitting, the unsplit
    search runs as well and the better of the two is kept (splitting
    trades smaller transient gathers for extra collective latency, so
    neither dominates — same policy as the fig5 benchmark).

    Sweep-level optimizations (results unchanged):
      * the inner problem only depends on (dp, residual topology) —
        factorizations sharing a residue and data extent reuse one
        sliced description and one Scheduler solve,
      * factorizations are visited best-bound-first and skipped when
        even their compute-only step time (comm >= 0 is dropped — an
        admissible bound) cannot beat the incumbent's throughput.
    """
    t0 = _time.perf_counter()
    if cluster is not None and cluster.n_devices != n_devices:
        raise ValueError(
            f"cluster has {cluster.n_devices} devices, search asked "
            f"for {n_devices}")
    topo = cluster if cluster is not None \
        else ClusterSpec.from_device(device, n_devices)
    if candidates is None:
        candidates = factorizations(n_devices, max_tp, max_pp)
    seq = desc.shape.seq_len
    batches = (list(batch_candidates) if batch_candidates is not None
               else [desc.shape.global_batch])
    n_layers = max(1, desc.model.n_layers)

    # TP innermost, PP outermost: the data residue of each admissible
    # factorization (skip those that don't divide the level structure)
    residues: Dict[Factorization, ClusterSpec] = {}
    for f in candidates:
        if f.pp > n_layers:
            continue
        try:
            residues[f] = topo.consume_inner(f.tp).consume_outer(f.pp)
        except ValueError:
            continue

    # admissible throughput upper bound: the inner step time is at
    # least the residue's compute time (the only mode-independent term;
    # under selective remat the bound drops the 1.30 recompute factor —
    # a fully-no-remat plan is reachable, so 1.0x stays admissible).
    # Heterogeneous fleets run lockstep at the slowest group's pace.
    flops_tok = sum(op.flops_per_token for op in desc.operators)
    if profile is None:
        comp_unit = seq * 3.0 * (1.30 if osdp.env_checkpointing else 1.0) \
            / (topo.effective_peak_flops * device.mxu_efficiency)
    else:
        # calibrated bound stays admissible: no op runs above the
        # curve's best fraction, and every op pays >= the fitted
        # recompute factor when checkpointing is forced on
        eff_hi = max(profile.efficiency.fraction)
        rf = profile.remat_factor if osdp.env_checkpointing else 1.0
        comp_unit = seq * 3.0 * rf \
            / (topo.effective_peak_flops * eff_hi)

    def thr_bound(f: Factorization) -> float:
        best_b = 0.0
        for b in batches:
            bpd = max(1, b // f.dp)
            t_comp = flops_tok / (f.tp * f.pp) * comp_unit * bpd
            t = hybrid_step_time(t_comp, desc, device, b, f, micro, topo)
            if t > 0:
                best_b = max(best_b, b * seq / t)
        return best_b

    admissible = list(residues)
    bounds = {f: thr_bound(f) for f in admissible}
    admissible.sort(key=bounds.__getitem__, reverse=True)

    variants = [osdp]
    if osdp.force_mode is None and osdp.operator_splitting:
        variants.append(dataclasses.replace(osdp,
                                            operator_splitting=False))

    slice_cache: Dict[int, ModelDescription] = {}
    sched_cache: Dict[Tuple, SearchResult] = {}

    best: Optional[HybridPlan] = None
    fallback: Optional[HybridPlan] = None   # min-memory infeasible plan
    swept: List[Tuple[Factorization, float]] = []

    for f in admissible:
        # dominance pruning: an incumbent nothing here can beat
        if best is not None and (bounds[f] * (1 + 1e-9)
                                 <= best.cost.throughput):
            continue
        mp = f.tp * f.pp
        sub = slice_cache.get(mp)
        if sub is None:
            sub = slice_cache[mp] = slice_description(desc, f.tp, f.pp)
        data_spec = residues[f]
        env = CostEnv(device, MeshConfig((f.dp, 1), ("data", "model")),
                      checkpointing=osdp.env_checkpointing,
                      include_tp=False, cluster=data_spec,
                      profile=profile)
        local: Optional[HybridPlan] = None
        for vi, cfg in enumerate(variants):
            key = (mp, data_spec, vi)
            res = sched_cache.get(key)
            if res is None:
                res = sched_cache[key] = schedule(
                    sub, env, cfg, batch_candidates=batches)
            t = hybrid_step_time(res.cost.time, desc, device,
                                 res.batch_size, f, micro, topo)
            plan = _as_hybrid_plan(desc, device, f, res, t, micro, cfg,
                                   topo)
            if not res.feasible:
                if fallback is None or (plan.cost.memory
                                        < fallback.cost.memory):
                    fallback = plan
                continue
            if local is None or plan.cost.throughput > local.cost.throughput:
                local = plan
        if local is None:
            continue
        swept.append((f, local.cost.throughput))
        if best is None or local.cost.throughput > best.cost.throughput:
            best = local

    if best is None:
        if fallback is None:
            # every candidate inadmissible (e.g. pp > n_layers for a
            # forced factorization): report an infeasible placeholder
            # rather than raise — same contract as the flat Scheduler.
            cands = list(candidates)
            if not cands:
                raise ValueError(
                    f"no factorization candidates for {n_devices} devices")
            f = cands[0]
            inf = float("inf")
            best = HybridPlan(
                desc=desc, device=device, factorization=f,
                stage_bounds=stage_bounds(desc.model.n_layers, f.pp),
                decisions={}, cost=PlanCost(inf, inf, inf, 0.0, 0.0, 0.0),
                batch_size=batches[0], micro=micro, feasible=False,
                dp_strategy="inadmissible", inner=None, cluster=topo)
        else:
            best = fallback
    best.swept = swept
    if best.inner is not None:
        best.inner.search_seconds = _time.perf_counter() - t0
    return best


def _as_hybrid_plan(desc: ModelDescription, device: DeviceInfo,
                    f: Factorization, res: SearchResult, t: float,
                    micro: int, cfg: OSDPConfig,
                    cluster: Optional[ClusterSpec] = None) -> HybridPlan:
    b_local = max(1, res.batch_size // f.dp)
    tp_t = tp_activation_time(desc, device, b_local, f.tp, cluster)
    pp_t = pp_boundary_time(desc, device, b_local, f.pp, micro, cluster)
    tokens = res.batch_size * desc.shape.seq_len
    cost = PlanCost(
        memory=res.cost.memory, peak_memory=res.cost.peak_memory,
        time=t, comm_time=res.cost.comm_time + tp_t + pp_t,
        compute_time=res.cost.compute_time,
        throughput=tokens / t if t > 0 else 0.0)
    strategy = (f"forced:{cfg.force_mode}" if cfg.force_mode
                else cfg.search + ("" if cfg.operator_splitting
                                   else "/nosplit"))
    return HybridPlan(
        desc=desc, device=device, factorization=f,
        stage_bounds=stage_bounds(desc.model.n_layers, f.pp),
        decisions=res.decisions, cost=cost, batch_size=res.batch_size,
        micro=micro, feasible=res.feasible, dp_strategy=strategy,
        inner=res, cluster=cluster)
