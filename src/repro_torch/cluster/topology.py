"""Hierarchical cluster topology — the paper's "device information" DI,
generalized from a flat two-bandwidth model to a real hierarchy.

The paper frames OSDP as "given the model description and the device
information, generate the distributed computation graph".  Until this
module, "device information" was a flat `DeviceInfo` (one ICI and one
DCI bandwidth): the search could not see chip -> node -> pod -> cluster
structure, and collectives crossing several link classes were priced at
the bottleneck bandwidth of the whole span (GSPMD / AutoDDL both show
that is what drives mis-placement at scale).

A `ClusterSpec` is an ordered list of `ClusterLevel`s, **innermost
(fastest) first**, each with a fan-out `ways`, a per-link `bandwidth`,
and a per-collective-step latency `alpha`.  The data-parallel extent of
the cluster is `prod(ways)`.  Optional `DeviceGroup`s describe
heterogeneous sub-fleets (their own `hbm_bytes` / `peak_flops`), which
partition the cluster at the outermost level.

Collectives are priced with a *hierarchical ring*: a collective
spanning levels `[0, k)` runs one ring pass per level, each pass over
that level's `ways` with that level's `alpha` and `bandwidth`, moving
only the chunk already aggregated below it.  For a tensor of B bytes
fully gathered over a span of N devices, the pass at level l (ways w_l,
prefix product P_l = prod_{j<l} w_j) costs

    (w_l - 1) * (alpha_l + B * P_l / (N * bw_l))

which degenerates to the classic flat ring `(n-1)(alpha + B/n/bw)` at
depth 1.  `_span_terms` returns the `(sum of (w-1)*alpha, per-byte
beta)` pair so the cost model can table-ize the prices.

The legacy flat model is the depth-2 degenerate case:
`ClusterSpec.from_flat(device, mesh)` maps the mesh's `data` axis to an
inner level at `ici_bw` and its `pod` axis to an outer level at
`dci_bw` — and on single-pod meshes every hierarchical price collapses
to the exact pre-existing flat formula (asserted byte-identical by
tests/test_topology.py).

Sharding modes generalize to "ZDP at level k": shard the model states
across the innermost k levels, gather over that span, and all-reduce
gradients across the remaining outer extent.  `ZDP` is level `depth`
(shard everything), the legacy `ZDP_POD` is level 1 of a depth-2 spec.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import DeviceInfo, MeshConfig

# canonical sharding-mode names (shared with core.cost_model)
DP = "DP"
ZDP = "ZDP"
ZDP_POD = "ZDP_POD"          # depth-2 alias for "ZDP at level 1"
LEVEL_PREFIX = "ZDP@"        # generalized: "ZDP@k" shards levels [0, k)


def level_mode(k: int) -> str:
    """Mode name for ZDP sharded across the innermost k levels."""
    return f"{LEVEL_PREFIX}{k}"


def parse_level_mode(mode: str) -> Optional[int]:
    """Span (in levels) of a 'ZDP@k' mode name, None if not one."""
    if mode.startswith(LEVEL_PREFIX):
        return int(mode[len(LEVEL_PREFIX):])
    return None


@dataclass(frozen=True)
class ClusterLevel:
    """One rung of the bandwidth hierarchy (innermost levels are the
    fastest: chip-to-chip ICI / NVLink; outer levels are node, pod,
    cluster interconnects)."""

    name: str
    ways: int                 # fan-out at this level
    bandwidth: float          # bytes/s per link at this level
    alpha: float = 1e-6      # per-collective-step latency (s)
    overlap: float = 0.0     # fraction of this level's comm hideable
                             # under compute (0 = serial legacy model)


@dataclass(frozen=True)
class DeviceGroup:
    """A heterogeneous sub-fleet: `n_devices` devices sharing one HBM
    capacity and peak-FLOPs figure.  Groups partition the cluster at
    the outermost level (mixed generations *within* a node are out of
    scope).  `hbm_bytes` is the per-device memory budget the planner
    may fill; `peak_flops=0` inherits the base `DeviceInfo`."""

    name: str
    n_devices: int
    hbm_bytes: float
    peak_flops: float = 0.0


@dataclass(frozen=True)
class ClusterSpec:
    """Hierarchical device information for the planner.

    `levels` are innermost-first; the spec describes the *data-parallel
    extent* seen by one search (TP/PP spans are carved off with
    `consume_inner` / `consume_outer` before the DP search runs).
    """

    levels: Tuple[ClusterLevel, ...]
    device: DeviceInfo = field(default_factory=DeviceInfo)
    groups: Tuple[DeviceGroup, ...] = ()

    def __post_init__(self):
        if not self.levels:
            raise ValueError("ClusterSpec needs at least one level")
        names = [l.name for l in self.levels]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate level names: {names}")
        for l in self.levels:
            if l.ways < 1 or l.bandwidth <= 0:
                raise ValueError(f"bad level {l}")
            if not 0.0 <= l.overlap <= 1.0:
                raise ValueError(
                    f"level {l.name}: overlap {l.overlap} outside [0, 1]")
        # a ways > 1 level outside a ways == 1 level would break the
        # level-index <-> mesh-axis correspondence (mesh_config drops
        # ways == 1 axes, and sharding maps "ZDP@k" to the k innermost
        # data axes); degenerate levels may only trail outermost
        seen_one = False
        for l in self.levels:
            if l.ways == 1:
                seen_one = True
            elif seen_one:
                raise ValueError(
                    f"level {l.name} (ways {l.ways}) appears outside a "
                    f"ways-1 level; fold degenerate levels outward")
        if self.groups:
            n = sum(g.n_devices for g in self.groups)
            if n != self.n_devices:
                raise ValueError(
                    f"groups cover {n} devices, cluster has "
                    f"{self.n_devices}")

    # -- shape ---------------------------------------------------------------

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def n_devices(self) -> int:
        return math.prod(l.ways for l in self.levels)

    def span_ways(self, k: int) -> int:
        """Devices inside one span of the innermost k levels."""
        return math.prod(l.ways for l in self.levels[:k])

    # -- comm/compute overlap ------------------------------------------------

    @property
    def overlaps(self) -> Tuple[float, ...]:
        """Per-level overlap factors, innermost-first (parallel to
        `levels`)."""
        return tuple(l.overlap for l in self.levels)

    @property
    def has_overlap(self) -> bool:
        """True when any level can hide communication under compute —
        the cost model only leaves its serial-sum (legacy, golden-
        pinned) path when this is set."""
        return any(l.overlap > 0.0 for l in self.levels)

    def with_overlap(self, overlap) -> "ClusterSpec":
        """Copy of this spec with overlap factors replaced: a scalar
        applies to every level, a mapping ``{level_name: factor}``
        sets only the named levels (others keep their current value).
        ``with_overlap(0.0)`` recovers the serial cost model."""
        if isinstance(overlap, (int, float)):
            by_name = {l.name: float(overlap) for l in self.levels}
        else:
            by_name = dict(overlap)
            unknown = set(by_name) - {l.name for l in self.levels}
            if unknown:
                raise ValueError(
                    f"unknown levels {sorted(unknown)}; have "
                    f"{[l.name for l in self.levels]}")
        levels = tuple(
            dataclasses.replace(l, overlap=by_name[l.name])
            if l.name in by_name else l for l in self.levels)
        return dataclasses.replace(self, levels=levels)

    # -- calibration ---------------------------------------------------------

    def with_links(self, links) -> "ClusterSpec":
        """Copy of this spec with measured (alpha, bandwidth) pairs
        substituted for the datasheet constants — the ClusterSpec half
        of attaching a `CalibrationProfile` to a `CostEnv`.

        ``links`` is an iterable of objects with ``.level``,
        ``.alpha`` and ``.bandwidth`` attributes
        (`repro_torch.calibrate.profile.LinkCalibration`; duck-typed so
        this module stays import-free of the calibrate package).  Links are
        matched to levels by name; if *no* link name matches any level
        the links are assigned positionally innermost-first instead
        (a profile fitted on a flat "data"/"pod" mesh still prices a
        "node"/"cluster" spec).  Unmatched levels keep their datasheet
        constants."""
        links = list(links)
        if not links:
            return self
        level_names = {l.name for l in self.levels}
        by_name = {ln.level: ln for ln in links}
        if not (set(by_name) & level_names):
            by_name = {lvl.name: ln
                       for lvl, ln in zip(self.levels, links)}
        levels = tuple(
            dataclasses.replace(l, alpha=by_name[l.name].alpha,
                                bandwidth=by_name[l.name].bandwidth)
            if l.name in by_name else l
            for l in self.levels)
        return dataclasses.replace(self, levels=levels)

    # -- sharding modes ------------------------------------------------------

    @property
    def shard_levels(self) -> List[int]:
        """Intermediate spans k (1 <= k < depth) that differ from both
        DP and full ZDP — the searchable "ZDP at level k" items.  Spans
        whose ways collapse to 1 or to the full extent are skipped."""
        out = []
        n = self.n_devices
        for k in range(1, self.depth):
            w = self.span_ways(k)
            if 1 < w < n and (not out or w != self.span_ways(out[-1])):
                out.append(k)
        return out

    @property
    def mode_names(self) -> Tuple[str, ...]:
        """Ordered decision-mode names: DP, full ZDP, then one entry
        per intermediate level.  Depth-2 specs keep the legacy
        ``ZDP_POD`` name (byte-compatible plans); deeper specs use
        ``ZDP@k``.  The list always includes the depth-2 triple for a
        depth-<=2 spec so evaluator column layouts stay stable."""
        if self.depth <= 2:
            return (DP, ZDP, ZDP_POD)
        names = [DP, ZDP]
        names += [level_mode(k) for k in range(1, self.depth)]
        return tuple(names)

    def span_mode(self, k: int) -> str:
        """Canonical mode name for sharding across the innermost k
        levels (inverse of `mode_span`)."""
        if not 0 < k <= self.depth:
            raise ValueError(f"span {k} out of range for depth "
                             f"{self.depth}")
        if k == self.depth:
            return ZDP
        if self.depth <= 2 and k == 1:
            return ZDP_POD
        return level_mode(k)

    def mode_span(self, mode: str) -> int:
        """Levels [0, span) a mode's shard extent covers (0 for DP)."""
        if mode == DP:
            return 0
        if mode == ZDP:
            return self.depth
        if mode == ZDP_POD:
            return min(1, self.depth)
        k = parse_level_mode(mode)
        if k is None or not 0 < k <= self.depth:
            raise ValueError(f"unknown mode {mode!r} for depth "
                             f"{self.depth}")
        return k

    def shard_ways(self, mode: str) -> float:
        """State divisor for a mode.  Full-span ZDP on a heterogeneous
        cluster uses capacity-weighted sharding: device d holds states
        proportional to its HBM, so the *binding* (smallest-memory)
        group holds `states * hbm_min / total_hbm` — an effective
        divisor of `total_hbm / hbm_min >= n_devices`."""
        k = self.mode_span(mode)
        if k == 0:
            return 1.0
        if k == self.depth and self.groups:
            return self.total_hbm / self.min_hbm
        return float(self.span_ways(k))

    # -- heterogeneous groups ------------------------------------------------

    @property
    def total_hbm(self) -> float:
        if self.groups:
            return sum(g.n_devices * g.hbm_bytes for g in self.groups)
        return self.n_devices * self.device.hbm_bytes

    @property
    def min_hbm(self) -> float:
        if self.groups:
            return min(g.hbm_bytes for g in self.groups)
        return self.device.hbm_bytes

    def memory_limit(self, default: float) -> float:
        """Per-device memory budget the search must respect.  Uniform
        clusters use the caller's limit; heterogeneous clusters judge
        feasibility at the worst group (its `hbm_bytes` IS its budget
        — encode headroom by shrinking the group's `hbm_bytes`), which
        is exact under capacity-weighted sharding: group g's state
        share scales with hbm_g while its budget does too, so the
        smallest group binds first."""
        if self.groups:
            return self.min_hbm
        return default

    @property
    def effective_peak_flops(self) -> float:
        """Synchronous training runs at the slowest group's pace."""
        flops = [g.peak_flops for g in self.groups if g.peak_flops > 0]
        return min(flops) if flops else self.device.peak_flops

    # -- hierarchical ring pricing -------------------------------------------

    def _span_terms(self, k_lo: int, k_hi: int) -> Tuple[float, float]:
        """(alpha_sum, beta_per_byte) of ONE hierarchical ring pass
        over levels [k_lo, k_hi).  beta multiplies the bytes of the
        tensor as fully held over the span (for a gather: the gathered
        size; for the outer grad all-reduce: the shard)."""
        n = math.prod(l.ways for l in self.levels[k_lo:k_hi])
        if n <= 1:
            return 0.0, 0.0
        alpha_sum = 0.0
        beta = 0.0
        prefix = 1
        for l in self.levels[k_lo:k_hi]:
            if l.ways > 1:
                alpha_sum += (l.ways - 1) * l.alpha
                beta += (l.ways - 1) * prefix / (n * l.bandwidth)
            prefix *= l.ways
        return alpha_sum, beta

    def gather_terms(self, k: int) -> Tuple[float, float]:
        """One ring pass of a gather/scatter over the innermost k
        levels (a ZDP-at-level-k parameter all-gather)."""
        return self._span_terms(0, k)

    def outer_terms(self, k: int) -> Tuple[float, float]:
        """One ring pass across the outer extent (levels [k, depth)) —
        the replicated-gradient all-reduce of a level-k shard.  beta is
        per byte of the shard."""
        return self._span_terms(k, self.depth)

    def span_rings(self, k_lo: int,
                   k_hi: int) -> List[Tuple[int, float, float, int]]:
        """The ring passes of one hierarchical collective over levels
        [k_lo, k_hi), as [(ways, alpha, bandwidth, prefix)] per
        (ways > 1) level — `prefix` is the product of ways of the
        preceding levels *within the span*.  One pass over the span
        moving B fully-held bytes costs

            sum_rings (ways - 1) * (alpha + B * prefix / n_span / bw)

        Cost-model code iterates these rings and keeps the exact
        floating-point shape of the legacy flat formula, so a depth-2
        single-pod span prices bit-identically to the pre-topology
        engine (one ring: (n-1) * (alpha + B / n / bw))."""
        rings: List[Tuple[int, float, float, int]] = []
        prefix = 1
        for l in self.levels[k_lo:k_hi]:
            if l.ways > 1:
                rings.append((l.ways, l.alpha, l.bandwidth, prefix))
            prefix *= l.ways
        return rings

    def gather_rings(self, k: int) -> List[Tuple[int, float, float, int]]:
        return self.span_rings(0, k)

    def outer_rings(self, k: int) -> List[Tuple[int, float, float, int]]:
        return self.span_rings(k, self.depth)

    def span_ring_levels(self, k_lo: int, k_hi: int) -> List[int]:
        """Absolute level index of each ring `span_rings(k_lo, k_hi)`
        returns (the ways-1 levels are skipped by both), so timeline
        cost code can bucket each ring's seconds under the level whose
        `overlap` factor governs it."""
        return [k_lo + i for i, l in enumerate(self.levels[k_lo:k_hi])
                if l.ways > 1]

    def gather_ring_levels(self, k: int) -> List[int]:
        return self.span_ring_levels(0, k)

    def outer_ring_levels(self, k: int) -> List[int]:
        return self.span_ring_levels(k, self.depth)

    def inner_span_terms(self, n: int) -> Tuple[float, float]:
        """(alpha_sum, beta_per_byte) of one ring pass over the
        innermost `n` devices, cutting through a level if `n` only
        partially covers it (used to price TP all-reduces placed on the
        innermost links).  `n` must divide into the level structure."""
        if n <= 1:
            return 0.0, 0.0
        rem = n
        prefix = 1
        alpha_sum = 0.0
        beta = 0.0
        for l in self.levels:
            if rem <= 1:
                break
            r = min(l.ways, rem)
            if rem % r or (r < l.ways and l.ways % r):
                raise ValueError(
                    f"span {n} does not fit the level structure "
                    f"{[l.ways for l in self.levels]}")
            if r > 1:
                alpha_sum += (r - 1) * l.alpha
                beta += (r - 1) * prefix / (n * l.bandwidth)
            prefix *= r
            rem //= r
        if rem > 1:
            raise ValueError(f"span {n} exceeds cluster "
                             f"({self.n_devices} devices)")
        return alpha_sum, beta

    def ring_time(self, nbytes: float, k: int,
                  alpha_scale: float = 1.0) -> float:
        """Seconds of one hierarchical ring pass gathering `nbytes`
        over the innermost k levels."""
        a, b = self.gather_terms(k)
        return a * alpha_scale + nbytes * b

    # -- carving TP / PP spans off the hierarchy -----------------------------

    def consume_inner(self, ways: int) -> "ClusterSpec":
        """Residual spec after assigning the innermost `ways` devices
        of every span to another axis (tensor parallelism).  Raises
        ValueError when `ways` does not divide the level structure —
        such factorizations are inadmissible on this topology."""
        if ways <= 1:
            return self
        levels: List[ClusterLevel] = []
        rem = ways
        for l in self.levels:
            if rem <= 1:
                levels.append(l)
            elif l.ways <= rem:
                if rem % l.ways:
                    raise ValueError(
                        f"tp={ways} does not divide level {l.name} "
                        f"(ways {l.ways})")
                rem //= l.ways       # level fully consumed
            else:
                if l.ways % rem:
                    raise ValueError(
                        f"tp={ways} does not divide level {l.name} "
                        f"(ways {l.ways})")
                levels.append(dataclasses.replace(l, ways=l.ways // rem))
                rem = 1
        if rem > 1:
            raise ValueError(f"tp={ways} exceeds cluster size")
        if not levels:
            levels = [dataclasses.replace(self.levels[0], ways=1)]
        return dataclasses.replace(self, levels=tuple(levels),
                                   groups=self._scaled_groups(ways))

    def consume_outer(self, ways: int) -> "ClusterSpec":
        """Residual spec after assigning the outermost `ways`-way split
        to another axis (pipeline parallelism)."""
        if ways <= 1:
            return self
        levels: List[ClusterLevel] = []
        rem = ways
        for l in reversed(self.levels):
            if rem <= 1:
                levels.append(l)
            elif l.ways <= rem:
                if rem % l.ways:
                    raise ValueError(
                        f"pp={ways} does not divide level {l.name} "
                        f"(ways {l.ways})")
                rem //= l.ways
            else:
                if l.ways % rem:
                    raise ValueError(
                        f"pp={ways} does not divide level {l.name} "
                        f"(ways {l.ways})")
                levels.append(dataclasses.replace(l, ways=l.ways // rem))
                rem = 1
        if rem > 1:
            raise ValueError(f"pp={ways} exceeds cluster size")
        levels.reverse()
        if not levels:
            levels = [dataclasses.replace(self.levels[0], ways=1)]
        # PP stages split the fleet at the outermost level, so each
        # stage keeps groups only if they still tile the residue; a
        # heterogeneous fleet split across stages keeps the worst
        # group's budget (conservative).
        return dataclasses.replace(self, levels=tuple(levels),
                                   groups=self._scaled_groups(ways))

    def _scaled_groups(self, consumed: int) -> Tuple[DeviceGroup, ...]:
        if not self.groups:
            return ()
        groups = []
        for g in self.groups:
            if g.n_devices % consumed:
                # group no longer tiles the residue: collapse to the
                # binding (min-HBM) group for the whole residue
                worst = min(self.groups, key=lambda x: x.hbm_bytes)
                n = self.n_devices // consumed
                return (dataclasses.replace(worst, n_devices=n),)
            groups.append(dataclasses.replace(
                g, n_devices=g.n_devices // consumed))
        return tuple(groups)

    # -- degraded fleets (device loss) ---------------------------------------

    def degrade(self, *, group: Optional[str] = None,
                level: Optional[str] = None,
                ways: int = 1) -> "ClusterSpec":
        """The post-failure spec after losing part of the fleet.

        Two forms:

          * ``degrade(group="large")`` — a heterogeneous `DeviceGroup`
            dies entirely (groups partition at the outermost level, so
            the lost devices must tile whole outermost spans);
          * ``degrade(level="pod", ways=2)`` — lose `ways` spans of the
            named level (default: the outermost ways > 1 level).

        The survivors keep their level structure; sharding capacity
        can only shrink (`shard_ways` of every mode is non-increasing,
        `total_hbm` strictly decreases), so a stale plan's per-device
        memory never *improves* on the degraded spec — which is why
        the supervisor must re-verify feasibility before resuming.
        """
        if group is not None and level is not None:
            raise ValueError("degrade by group OR by level, not both")
        outer = max((i for i, l in enumerate(self.levels) if l.ways > 1),
                    default=None)
        if outer is None:
            raise ValueError("cannot degrade a single-device cluster")
        if group is not None:
            g = next((x for x in self.groups if x.name == group), None)
            if g is None:
                raise ValueError(
                    f"no group {group!r} in "
                    f"{[x.name for x in self.groups]}")
            inner_span = self.n_devices // self.levels[outer].ways
            if g.n_devices % inner_span:
                raise ValueError(
                    f"group {group!r} ({g.n_devices} devices) does not "
                    f"tile the outermost spans of {inner_span}")
            lost_ways = g.n_devices // inner_span
            survivors = tuple(x for x in self.groups if x.name != group)
            return self._drop_ways(outer, lost_ways, survivors)
        idx = outer
        if level is not None:
            named = [i for i, l in enumerate(self.levels)
                     if l.name == level]
            if not named:
                raise ValueError(
                    f"no level {level!r} in "
                    f"{[l.name for l in self.levels]}")
            idx = named[0]
        if ways < 1 or ways >= self.levels[idx].ways:
            raise ValueError(
                f"cannot lose {ways} of {self.levels[idx].ways} spans "
                f"at level {self.levels[idx].name!r} (need at least "
                f"one survivor)")
        lost_dev = ways * (self.n_devices // self.levels[idx].ways)
        groups = self._degraded_groups(self.n_devices - lost_dev)
        return self._drop_ways(idx, ways, groups)

    def _drop_ways(self, idx: int, lost_ways: int,
                   groups: Tuple[DeviceGroup, ...]) -> "ClusterSpec":
        l = self.levels[idx]
        if lost_ways >= l.ways:
            raise ValueError(
                f"losing {lost_ways} of {l.ways} spans at level "
                f"{l.name!r} leaves no survivors")
        levels = list(self.levels)
        levels[idx] = dataclasses.replace(l, ways=l.ways - lost_ways)
        # a level collapsing to ways == 1 must not strand an outer
        # ways > 1 level (the post-init invariant): fold it outward by
        # keeping it where it is only if nothing wider sits outside
        if levels[idx].ways == 1 and any(
                x.ways > 1 for x in levels[idx + 1:]):
            levels = levels[:idx] + levels[idx + 1:] + [levels[idx]]
        return dataclasses.replace(self, levels=tuple(levels),
                                   groups=groups)

    def _degraded_groups(self, n_new: int) -> Tuple[DeviceGroup, ...]:
        """Survivor groups after an anonymous (level-wise) loss: scale
        proportionally when the loss tiles every group, else collapse
        to the binding (min-HBM) group for the whole residue."""
        if not self.groups:
            return ()
        n_old = self.n_devices
        if all(g.n_devices * n_new % n_old == 0 for g in self.groups):
            return tuple(dataclasses.replace(
                g, n_devices=g.n_devices * n_new // n_old)
                for g in self.groups)
        worst = min(self.groups, key=lambda g: g.hbm_bytes)
        return (dataclasses.replace(worst, n_devices=n_new),)

    def pp_boundary_bandwidth(self, pp: int) -> float:
        """Bandwidth of the link a pipeline-stage boundary crosses when
        PP is placed across the outermost (slowest) levels: the
        innermost level the pp-way split reaches."""
        if pp <= 1:
            return self.levels[0].bandwidth
        rem = pp
        bw = self.levels[-1].bandwidth
        for l in reversed(self.levels):
            if rem <= 1:
                break
            if l.ways > 1:
                bw = l.bandwidth
            rem = max(1, rem // max(1, l.ways))
        return bw

    def pp_boundary_overlap(self, pp: int) -> float:
        """Overlap factor of the link a pipeline-stage boundary
        crosses (same walk as `pp_boundary_bandwidth`): how much of a
        stage's boundary send can hide under the next microbatch's
        compute."""
        if pp <= 1:
            return self.levels[0].overlap
        rem = pp
        ov = self.levels[-1].overlap
        for l in reversed(self.levels):
            if rem <= 1:
                break
            if l.ways > 1:
                ov = l.overlap
            rem = max(1, rem // max(1, l.ways))
        return ov

    # -- flat-model interop --------------------------------------------------

    @classmethod
    def from_flat(cls, device: DeviceInfo,
                  mesh: MeshConfig) -> "ClusterSpec":
        """The depth-2 degenerate case: the mesh's `data` axis becomes
        an inner level at `ici_bw`, its `pod` axis an outer level at
        `dci_bw`.  On single-pod meshes every hierarchical price
        collapses to the legacy flat-ring formula exactly."""
        n_local = 1
        n_pods = 1
        for s, a in zip(mesh.shape, mesh.axes):
            if a == "data":
                n_local *= s
            elif a == "pod":
                n_pods *= s
        if n_local == 1 and n_pods > 1:
            # degenerate data axis: the pod axis is the whole (dci-
            # speed) data extent — fold it inward so no ways > 1 level
            # sits outside a ways-1 level
            return cls(levels=(
                ClusterLevel("data", n_pods, device.dci_bw, device.alpha,
                             device.overlap),
                ClusterLevel("pod", 1, device.dci_bw, device.alpha,
                             device.overlap)),
                device=device)
        return cls(levels=(
            ClusterLevel("data", n_local, device.ici_bw, device.alpha,
                         device.overlap),
            ClusterLevel("pod", n_pods, device.dci_bw, device.alpha,
                         device.overlap)),
            device=device)

    @classmethod
    def from_device(cls, device: DeviceInfo,
                    n_devices: int) -> "ClusterSpec":
        """Infer a hierarchy for `n_devices` from a `DeviceInfo`: if
        the device declares `devices_per_node` and the fleet spans
        several nodes, build (node @ ici, cluster @ dci); otherwise a
        single flat level at `ici_bw` (the legacy assumption)."""
        dpn = getattr(device, "devices_per_node", 0) or 0
        if dpn and 1 <= dpn < n_devices and n_devices % dpn == 0:
            return cls(levels=(
                ClusterLevel("node", dpn, device.ici_bw, device.alpha,
                             device.overlap),
                ClusterLevel("cluster", n_devices // dpn, device.dci_bw,
                             device.alpha, device.overlap)),
                device=device)
        return cls(levels=(
            ClusterLevel("data", n_devices, device.ici_bw, device.alpha,
                         device.overlap),),
            device=device)

    def to_flat(self) -> Tuple[DeviceInfo, MeshConfig]:
        """Collapse to the legacy flat model: innermost bandwidth as
        ICI, the *slowest outer* bandwidth as DCI, all outer ways
        folded into one pod axis.  This is what a flat planner sees of
        a deep topology — `benchmarks/topology_sweep.py` quantifies
        what that collapse costs."""
        inner = self.levels[0]
        outer_ways = math.prod(l.ways for l in self.levels[1:])
        outer_bw = min((l.bandwidth for l in self.levels[1:]
                        if l.ways > 1), default=inner.bandwidth)
        device = dataclasses.replace(
            self.device, ici_bw=inner.bandwidth, dci_bw=outer_bw,
            alpha=inner.alpha)
        if outer_ways > 1:
            mesh = MeshConfig((outer_ways, inner.ways, 1),
                              ("pod", "data", "model"))
        else:
            mesh = MeshConfig((inner.ways, 1), ("data", "model"))
        return device, mesh

    def mesh_config(self, model_parallel: int = 1,
                    pipeline_parallel: int = 1) -> MeshConfig:
        """Logical mesh for this spec: one axis per (ways > 1) level,
        outermost first, then `model` / `pipe`.  Depth-2 specs emit
        the legacy ('pod', 'data', 'model') layout."""
        shape: List[int] = []
        axes: List[str] = []
        for l in reversed(self.levels):
            if l.ways > 1:
                shape.append(l.ways)
                axes.append(l.name)
        if not shape:
            shape, axes = [1], [self.levels[0].name]
        shape.append(model_parallel)
        axes.append("model")
        if pipeline_parallel > 1:
            shape.append(pipeline_parallel)
            axes.append("pipe")
        return MeshConfig(tuple(shape), tuple(axes))

    def summary(self) -> str:
        lv = " > ".join(
            f"{l.name}x{l.ways}@{l.bandwidth / 1e9:.0f}GB/s"
            for l in reversed(self.levels))
        gr = ""
        if self.groups:
            gr = " groups[" + ", ".join(
                f"{g.name}:{g.n_devices}x{g.hbm_bytes / 2**30:.0f}GiB"
                for g in self.groups) + "]"
        return f"cluster[{self.n_devices}] {lv}{gr}"


# ---------------------------------------------------------------------------
# Presets: the topologies the benchmarks sweep
# ---------------------------------------------------------------------------

def tpu_multipod(n_pods: int, pod_size: int,
                 device: Optional[DeviceInfo] = None) -> ClusterSpec:
    """TPU fleet: `pod_size` chips on ICI per pod, pods on DCI."""
    dev = device or DeviceInfo()
    return ClusterSpec(levels=(
        ClusterLevel("data", pod_size, dev.ici_bw, dev.alpha, dev.overlap),
        ClusterLevel("pod", n_pods, dev.dci_bw, dev.alpha, dev.overlap)),
        device=dev)


def gpu_cluster(n_nodes: int, gpus_per_node: int = 8,
                device: Optional[DeviceInfo] = None,
                nvlink_bw: float = 450e9, ib_bw: float = 50e9,
                spine_nodes: int = 0,
                spine_bw: float = 25e9) -> ClusterSpec:
    """GPU fleet: NVLink inside the node, InfiniBand across nodes, and
    optionally a third (oversubscribed spine) level grouping
    `spine_nodes` nodes per leaf switch."""
    dev = device or DeviceInfo.preset("a100-80g")
    dev = dataclasses.replace(dev, ici_bw=nvlink_bw, dci_bw=ib_bw)
    levels = [ClusterLevel("node", gpus_per_node, nvlink_bw, dev.alpha,
                           dev.overlap)]
    if spine_nodes and spine_nodes < n_nodes:
        if n_nodes % spine_nodes:
            raise ValueError("spine_nodes must divide n_nodes")
        levels.append(ClusterLevel("rack", spine_nodes, ib_bw, dev.alpha,
                                   dev.overlap))
        levels.append(ClusterLevel("spine", n_nodes // spine_nodes,
                                   spine_bw, dev.alpha, dev.overlap))
    else:
        levels.append(ClusterLevel("rack", n_nodes, ib_bw, dev.alpha,
                                   dev.overlap))
    return ClusterSpec(levels=tuple(levels), device=dev)


def mixed_memory_fleet(n_small: int, small_hbm_gib: float,
                       n_large: int, large_hbm_gib: float,
                       pod_size: int,
                       device: Optional[DeviceInfo] = None) -> ClusterSpec:
    """Mixed-generation fleet: `n_small` low-memory and `n_large`
    high-memory devices, pods of `pod_size` on ICI, pods on DCI.
    Groups partition at the pod boundary."""
    dev = device or DeviceInfo()
    n = n_small + n_large
    if n % pod_size:
        raise ValueError("pod_size must divide the fleet")
    return ClusterSpec(levels=(
        ClusterLevel("data", pod_size, dev.ici_bw, dev.alpha, dev.overlap),
        ClusterLevel("pod", n // pod_size, dev.dci_bw, dev.alpha,
                     dev.overlap)),
        device=dev,
        groups=(
            DeviceGroup("small", n_small, small_hbm_gib * 2**30),
            DeviceGroup("large", n_large, large_hbm_gib * 2**30)))
