"""Exact ILP backend for the OSDP cover problem (the fourth solver).

The Search Engine's covering problem (``core/search.py``)

    min  sum_i  extra_time_i[m_i]
    s.t. sum_i  savings_i[m_i]  >=  need,      m_i in modes(i) + {None}

is a 0/1 multiple-choice knapsack-cover: every slice item picks at most
one of its (mode, remat) choices.  The shipped dfs/knapsack/greedy
solvers are heuristically engineered (branch ordering, quantization,
ratio ranking) — this module solves the *same* problem as an explicit
integer linear program, so their answers can be audited against a
formulation whose optimality is a property of the model, not of the
search implementation (ROADMAP item 4; cf. AutoDDL's offline
near-optimal layout solves and scamp-ml's interchangeable z3 / MiniZinc
/ CPLEX templates behind one interface).

Group collapsing (exact). Items with identical (savings, extra_time)
signatures — every per-layer copy of one operator, all slices of a
stacked op — are interchangeable, so the ILP's variables are *counts*:

    y[g, m] = number of group-g slices assigned choice m
    min   sum_{g,m} ext[g,m]  y[g,m]
    s.t.  sum_{g,m} sav[g,m]  y[g,m] >= need         (cover)
          sum_m     y[g,m]          <= K_g   (all g) (exclusivity)
          y integer, 0 <= y[g,m] <= K_g

Identical optimum, exponentially fewer variables (885 per-layer ops
collapse to a few dozen signatures).  Solutions decode to per-item
choices in the DFS's canonical order (cheapest-ratio mode takes the
earliest slices of each group), so a unique optimum yields decisions
*byte-identical* to ``_solve_dfs`` — asserted by
``benchmarks/solver_audit.py`` on the committed BENCH cases.

Two interchangeable backends behind ``solve_ilp``:

  * ``milp`` — ``scipy.optimize.milp`` (HiGHS) when scipy is present;
    ``mip_rel_gap=0`` so the answer is exact, `time_limit` for the
    anytime mode.
  * ``bnb``  — dependency-free best-first branch-and-bound whose lower
    bound is the LP relaxation, evaluated through its Lagrangian dual:
    for any multiplier lam >= 0 on the cover row,

        LP >= lam * need + sum_g  min over feasible y_g of
                              sum_m (ext[g,m] - lam sav[g,m]) y[g,m]
            = lam * need + sum_g  K_g * min(0, min_m rc[g,m](lam))

    (each group's inner minimum puts all capacity on its most negative
    reduced cost).  The dual is concave piecewise-linear in lam with
    breakpoints only at reduced-cost sign changes and crossings, so
    maximizing over that finite candidate set gives the exact LP bound;
    any subset stays admissible.  Tier-1 therefore never gains a hard
    dependency: scipy missing only removes the milp path.

Both backends are *anytime*: given a time (or node) budget they return
the best incumbent found plus a proven lower bound on the optimum —
``ILPSolve.objective`` vs ``ILPSolve.lower_bound`` — with
``optimal=False`` when the gap is open.
"""
from __future__ import annotations

import heapq
import math
import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:                                     # optional exact backend
    from scipy.optimize import Bounds, LinearConstraint, milp as _milp
    HAVE_SCIPY_MILP = True
except Exception:                        # pragma: no cover - env without scipy
    HAVE_SCIPY_MILP = False

ILP_BACKENDS = ("auto", "milp", "bnb")


@dataclass
class ILPSolve:
    """Result of one exact-cover solve.

    ``objective`` is the incumbent's cover cost (seconds of step time
    added over the all-base plan); ``lower_bound`` the proven minimum.
    ``optimal`` means the gap is closed (or infeasibility proven —
    then ``objective`` is inf and ``choice`` is the max-saving
    fallback every other solver returns on uncoverable instances).
    ``nodes`` is the backend's effort: branch-and-bound nodes expanded
    plus one per integer variable (so trivially-presolved instances
    still report their model size).
    """

    choice: List[Optional[str]]
    nodes: int
    objective: float
    lower_bound: float
    optimal: bool
    backend: str

    @property
    def gap(self) -> float:
        """Relative optimality gap of the incumbent (0 when closed)."""
        if not math.isfinite(self.objective):
            return math.inf
        if self.objective <= self.lower_bound:
            return 0.0
        return (self.objective - self.lower_bound) \
            / max(abs(self.lower_bound), 1e-30)


class _Group:
    """One signature group: interchangeable items, shared choice menu."""

    __slots__ = ("idxs", "modes", "sav", "ext", "cap")

    def __init__(self, idxs: List[int], savings: Dict[str, float],
                 extra_time: Dict[str, float]):
        self.idxs = idxs
        # the DFS's canonical within-group mode order (cheapest dT/dM
        # first; same key, same stable sort) — the decode contract
        self.modes = sorted(savings, key=lambda m: extra_time[m]
                            / max(savings[m], 1e-9))
        self.sav = [savings[m] for m in self.modes]
        self.ext = [extra_time[m] for m in self.modes]
        self.cap = len(idxs)


def _group_items(items: Sequence) -> List[_Group]:
    """Collapse items into signature groups (the DFS's exact grouping:
    items are interchangeable iff their full choice menus match)."""
    table: Dict[tuple, List[int]] = {}
    for i, it in enumerate(items):
        sig = (tuple(sorted(it.savings.items())),
               tuple(sorted(it.extra_time.items())))
        table.setdefault(sig, []).append(i)
    groups = [_Group(idxs, items[idxs[0]].savings,
                     items[idxs[0]].extra_time)
              for idxs in table.values()]
    # best-ratio group order (the DFS's glist order): irrelevant for
    # correctness, it just makes the bnb find good incumbents first
    groups.sort(key=lambda g: min(e / max(s, 1e-9)
                                  for s, e in zip(g.sav, g.ext)))
    return groups


def _decode(items: Sequence, groups: List[_Group],
            counts: List[List[int]]) -> List[Optional[str]]:
    """Counts -> per-item choices, in the DFS's canonical order: mode
    j of a group takes the next counts[g][j] of the group's item
    indices (ascending), cheapest-ratio mode first."""
    choice: List[Optional[str]] = [None] * len(items)
    for g, cnt in zip(groups, counts):
        ptr = 0
        for m, c in zip(g.modes, cnt):
            for _ in range(int(c)):
                choice[g.idxs[ptr]] = m
                ptr += 1
    return choice


def _max_saving_fallback(items: Sequence) -> List[Optional[str]]:
    """The uncoverable-instance fallback every solver agrees on:
    shard everything at its max-saving choice (the feasibility
    frontier; ``_solve_once``'s repair escalates to the same plan)."""
    return [max(it.savings, key=it.savings.get) for it in items]


def _objective(groups: List[_Group], counts: List[List[int]]) -> float:
    return sum(c * e for g, cnt in zip(groups, counts)
               for c, e in zip(cnt, g.ext))


def _coverage(groups: List[_Group], counts: List[List[int]]) -> float:
    return sum(c * s for g, cnt in zip(groups, counts)
               for c, s in zip(cnt, g.sav))


def _greedy_counts(groups: List[_Group], need: float
                   ) -> Optional[List[List[int]]]:
    """Ratio-greedy incumbent on the grouped problem (None if it
    cannot cover)."""
    lvls = sorted((g.ext[j] / max(g.sav[j], 1e-9), gi, j)
                  for gi, g in enumerate(groups)
                  for j in range(len(g.modes)) if g.sav[j] > 0)
    counts = [[0] * len(g.modes) for g in groups]
    rem = [g.cap for g in groups]
    saved = 0.0
    for _, gi, j in lvls:
        if saved >= need:
            break
        take = min(rem[gi],
                   int(math.ceil((need - saved) / groups[gi].sav[j])))
        counts[gi][j] += take
        rem[gi] -= take
        saved += take * groups[gi].sav[j]
    return counts if saved >= need else None


def _topup(groups: List[_Group], counts: List[List[int]],
           need: float) -> None:
    """Greedily add spare capacity until `counts` covers `need` (used
    to absorb sub-quantum float slack in backend solutions)."""
    saved = _coverage(groups, counts)
    if saved >= need:
        return
    lvls = sorted((g.ext[j] / max(g.sav[j], 1e-9), gi, j)
                  for gi, g in enumerate(groups)
                  for j in range(len(g.modes)) if g.sav[j] > 0)
    for _, gi, j in lvls:
        if saved >= need:
            return
        g = groups[gi]
        rem = g.cap - sum(counts[gi])
        take = min(rem, int(math.ceil((need - saved) / g.sav[j])))
        counts[gi][j] += take
        saved += take * g.sav[j]


# ---------------------------------------------------------------------------
# Backend 1: scipy.optimize.milp (HiGHS)
# ---------------------------------------------------------------------------

def _solve_milp(groups: List[_Group], need: float, time_budget: float
                ) -> Tuple[Optional[List[List[int]]], int, float, bool]:
    """Returns (counts | None, nodes, lower_bound, optimal)."""
    n_var = sum(len(g.modes) for g in groups)
    c = np.empty(n_var)
    s = np.empty(n_var)
    ub = np.empty(n_var)
    rows = np.zeros((1 + len(groups), n_var))
    off = 0
    for gi, g in enumerate(groups):
        w = len(g.modes)
        c[off:off + w] = g.ext
        s[off:off + w] = g.sav
        ub[off:off + w] = g.cap
        rows[1 + gi, off:off + w] = 1.0
        off += w
    rows[0] = s
    lb_row = np.full(1 + len(groups), -np.inf)
    ub_row = np.array([np.inf] + [float(g.cap) for g in groups])
    lb_row[0], ub_row[0] = need, np.inf
    options = {"mip_rel_gap": 0.0}
    if time_budget > 0:
        options["time_limit"] = float(time_budget)
    res = _milp(c=c, constraints=LinearConstraint(rows, lb_row, ub_row),
                integrality=np.ones(n_var), bounds=Bounds(0, ub),
                options=options)
    nodes = n_var + max(0, int(getattr(res, "mip_node_count", 0) or 0))
    if res.x is None:
        # proven infeasible (status 2) or budget exhausted with no
        # incumbent — the caller already screened uncoverable needs,
        # so a missing x with status 2 can only be float slack at the
        # cover row; either way fall back to the caller's incumbent
        bound = float(getattr(res, "mip_dual_bound", 0.0) or 0.0)
        return None, nodes, bound, False
    counts: List[List[int]] = []
    off = 0
    for g in groups:
        w = len(g.modes)
        cnt = [int(v) for v in np.clip(np.round(res.x[off:off + w]),
                                       0, g.cap)]
        over = sum(cnt) - g.cap          # exclusivity after rounding
        for j in range(w - 1, -1, -1):
            if over <= 0:
                break
            take = min(cnt[j], over)
            cnt[j] -= take
            over -= take
        counts.append(cnt)
        off += w
    _topup(groups, counts, need)         # absorb solver float slack
    optimal = res.status == 0
    bound = (float(res.mip_dual_bound)
             if getattr(res, "mip_dual_bound", None) is not None
             else 0.0)
    if optimal:
        bound = _objective(groups, counts)
    return counts, nodes, bound, optimal


# ---------------------------------------------------------------------------
# Backend 2: dependency-free branch-and-bound over the LP relaxation
# ---------------------------------------------------------------------------

class _DualTables:
    """Precomputed Lagrangian-dual machinery for the bnb bound.

    For every candidate multiplier lam (the dual's breakpoints) and
    every level position, hold the within-group suffix minimum reduced
    cost and the over-later-groups capacity-weighted dual sum, so one
    bound evaluation is a vectorized max over candidates."""

    MAX_CANDIDATES = 1024

    def __init__(self, groups: List[_Group]):
        self.levels: List[Tuple[int, float, float, bool]] = []
        for gi, g in enumerate(groups):
            for j in range(len(g.modes)):
                self.levels.append((gi, g.sav[j], g.ext[j], j == 0))
        L = len(self.levels)
        cands = {0.0}
        for g in groups:
            for j in range(len(g.modes)):
                if g.sav[j] > 0:
                    cands.add(max(0.0, g.ext[j] / g.sav[j]))
                for k in range(j + 1, len(g.modes)):
                    ds = g.sav[j] - g.sav[k]
                    if ds:
                        lam = (g.ext[j] - g.ext[k]) / ds
                        if lam > 0:
                            cands.add(lam)
        lam = np.array(sorted(cands))
        if lam.size > self.MAX_CANDIDATES:   # any subset stays admissible
            keep = np.linspace(0, lam.size - 1,
                               self.MAX_CANDIDATES).astype(int)
            lam = lam[np.unique(keep)]
        self.lam = lam
        A = lam.size
        # rc[li, a] = ext - lam * sav
        sav = np.array([s for _, s, _, _ in self.levels])
        ext = np.array([e for _, _, e, _ in self.levels])
        rc = ext[:, None] - lam[None, :] * sav[:, None]
        # within-group suffix min reduced cost, clamped at 0
        self.inmin = np.zeros((L + 1, A))
        gid = [gi for gi, _, _, _ in self.levels]
        for li in range(L - 1, -1, -1):
            below = (self.inmin[li + 1]
                     if li + 1 < L and gid[li + 1] == gid[li] else 0.0)
            self.inmin[li] = np.minimum(np.minimum(rc[li], below), 0.0)
        # capacity-weighted dual over the groups strictly after gi
        G = len(groups)
        gmin = np.zeros((G, A))
        first_level = {}
        for li, (gi, _, _, first) in enumerate(self.levels):
            if first:
                first_level[gi] = li
        for gi, g in enumerate(groups):
            gmin[gi] = g.cap * self.inmin[first_level[gi]]
        self.suffix_dual = np.zeros((G + 1, A))
        for gi in range(G - 1, -1, -1):
            self.suffix_dual[gi] = self.suffix_dual[gi + 1] + gmin[gi]
        # capacity pruning tables (dfs-style): best saving reachable
        # per remaining-group slice, and total over later groups
        self.inner_max = np.zeros(L)
        for li in range(L - 1, -1, -1):
            below = (self.inner_max[li + 1]
                     if li + 1 < L and gid[li + 1] == gid[li] else 0.0)
            self.inner_max[li] = max(self.levels[li][1], below)
        self.suffix_cap = np.zeros(G + 1)
        for gi in range(G - 1, -1, -1):
            self.suffix_cap[gi] = (self.suffix_cap[gi + 1]
                                   + groups[gi].cap * max(groups[gi].sav))
        self.gid = gid
        self.first = [f for _, _, _, f in self.levels]
        self.cap_at = [groups[gi].cap for gi in gid]

    def bound(self, li: int, need_rem: float, rem: int) -> float:
        """Admissible lower bound on finishing from level li with
        `need_rem` still to cover (`rem` slices left in li's group;
        ignored — reset to the group capacity — when li opens a fresh
        group).  Covered (need_rem <= 0) is NOT zero when negative-cost
        levels remain: the lam=0 dual term counts every still-available
        cost *reduction*, keeping the bound admissible for modes that
        are both memory-saving and faster."""
        L = len(self.levels)
        if li >= L:
            return 0.0 if need_rem <= 0 else math.inf
        if self.first[li]:
            rem = self.cap_at[li]
        gi = self.gid[li]
        if need_rem <= 0:
            # lam = 0 (index 0: candidates are sorted, all >= 0)
            return float(rem * self.inmin[li, 0]
                         + self.suffix_dual[gi + 1, 0])
        if rem * self.inner_max[li] + self.suffix_cap[gi + 1] < need_rem:
            return math.inf              # capacity: uncoverable from here
        vals = (self.lam * need_rem + rem * self.inmin[li]
                + self.suffix_dual[gi + 1])
        return float(vals.max())


def _solve_bnb(groups: List[_Group], need: float, node_budget: int,
               time_budget: float
               ) -> Tuple[Optional[List[List[int]]], int, float, bool]:
    """Best-first branch-and-bound on the grouped cover problem.

    Nodes branch one level (group, mode) at a time on the count taken;
    priority = cost so far + the Lagrangian LP bound on the rest.  Every
    covered node popped updates the incumbent (None for all remaining
    slices completes it); with an admissible bound, the search is exact
    the moment the smallest outstanding priority reaches the incumbent.
    Budget exhaustion returns the best incumbent plus the smallest
    outstanding node priority — a proven lower bound (anytime mode)."""
    t0 = _time.perf_counter()
    tables = _DualTables(groups)
    levels = tables.levels
    L = len(levels)

    inc_counts = _greedy_counts(groups, need)
    inc_cost = (_objective(groups, inc_counts)
                if inc_counts is not None else math.inf)

    root_bound = tables.bound(0, need, groups[0].cap if groups else 0)
    if not math.isfinite(root_bound):
        return inc_counts, 1, inc_cost, inc_counts is not None
    heap: List[Tuple[float, int, int, int, float, float, tuple]] = []
    tie = 0
    heapq.heappush(heap, (root_bound, tie, 0,
                          groups[0].cap if groups else 0, 0.0, 0.0, ()))
    nodes = 0
    best_outstanding = root_bound
    while heap:
        bound, _, li, rem, saved, cost, path = heapq.heappop(heap)
        if bound >= inc_cost:
            # everything left is no better than the incumbent: the
            # incumbent is optimal (priority queue is bound-sorted)
            best_outstanding = inc_cost
            break
        nodes += 1
        if saved >= need and cost < inc_cost:
            # choosing None for every remaining slice completes this
            # node; keep expanding — remaining negative-cost levels
            # (modes both memory-saving and faster) may improve it
            inc_cost = cost
            inc_counts = _path_counts(groups, levels, path)
        if nodes > node_budget or (time_budget > 0 and
                                   _time.perf_counter() - t0 > time_budget):
            best_outstanding = bound     # smallest outstanding priority
            return inc_counts, nodes, best_outstanding, False
        if li == L:
            continue
        gi, sav, ext, first = levels[li]
        if first:
            rem = groups[gi].cap
        if ext <= 0:
            c_max = rem                  # free (or profitable) capacity
        elif sav > 0:
            c_max = min(rem, max(0, int(math.ceil((need - saved) / sav))))
        else:
            c_max = 0
        for c in range(c_max, -1, -1):
            s2 = saved + c * sav
            t2 = cost + c * ext
            b2 = t2 + tables.bound(li + 1, need - s2, rem - c)
            if b2 >= inc_cost or not math.isfinite(b2):
                continue
            tie += 1
            heapq.heappush(heap, (b2, tie, li + 1, rem - c, s2, t2,
                                  path + (c,)))
    else:
        best_outstanding = inc_cost
    if inc_counts is None:
        return None, max(1, nodes), best_outstanding, False
    return inc_counts, max(1, nodes), min(best_outstanding, inc_cost), True


def _path_counts(groups: List[_Group], levels, path: tuple
                 ) -> List[List[int]]:
    counts = [[0] * len(g.modes) for g in groups]
    j_in_group = 0
    for li, c in enumerate(path):
        gi, _, _, first = levels[li]
        if first:
            j_in_group = 0
        counts[gi][j_in_group] = c
        j_in_group += 1
    return counts


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------

def solve_ilp(items: Sequence, need: float, *, time_budget: float = 0.0,
              backend: str = "auto",
              node_budget: int = 2_000_000) -> ILPSolve:
    """Solve the cover problem exactly (or anytime, under a budget).

    `items` duck-types ``search.SliceItem`` (``savings`` /
    ``extra_time`` choice dicts).  ``backend="auto"`` picks scipy's
    milp when importable, else the pure-Python branch-and-bound;
    explicit ``"milp"`` / ``"bnb"`` force one (milp without scipy
    raises ImportError).  ``time_budget > 0`` (seconds) turns on the
    anytime mode: the result carries the incumbent and a proven
    ``lower_bound`` with ``optimal=False`` when the gap stayed open.
    """
    if backend not in ILP_BACKENDS:
        raise ValueError(f"unknown ilp backend {backend!r}; "
                         f"known: {ILP_BACKENDS}")
    if backend == "milp" and not HAVE_SCIPY_MILP:
        raise ImportError(
            "ilp_backend='milp' needs scipy.optimize.milp; install "
            "scipy or use backend='bnb' (the dependency-free fallback)")
    use = backend if backend != "auto" else \
        ("milp" if HAVE_SCIPY_MILP else "bnb")
    n = len(items)
    if need <= 0:
        return ILPSolve([None] * n, 1, 0.0, 0.0, True, use)
    groups = _group_items(items)
    capacity = sum(g.cap * max(g.sav) for g in groups)
    if capacity < need:
        # proven uncoverable: agree with every other backend's
        # max-saving fallback (repair escalates to the same plan)
        return ILPSolve(_max_saving_fallback(items), 1, math.inf,
                        math.inf, True, use)
    if use == "milp":
        counts, nodes, bound, optimal = _solve_milp(groups, need,
                                                    time_budget)
    else:
        counts, nodes, bound, optimal = _solve_bnb(groups, need,
                                                   node_budget,
                                                   time_budget)
    if counts is None:
        # budget ran out before any incumbent: fall back to the greedy
        # cover (feasible — capacity was proven sufficient above)
        g = _greedy_counts(groups, need)
        if g is None:                    # pragma: no cover - capacity>=need
            return ILPSolve(_max_saving_fallback(items), nodes,
                            math.inf, bound, False, use)
        counts = g
    obj = _objective(groups, counts)
    if optimal:
        bound = obj
    return ILPSolve(_decode(items, groups, counts), nodes, obj,
                    min(bound, obj), optimal, use)
