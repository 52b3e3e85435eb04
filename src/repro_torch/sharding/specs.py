"""Parameter layout: OSDP segments (paper §3.3 per-slice plans) on torch.

Every model declares its parameters as `WeightSpec`s: shape, the TP
placement, the ZDP axis (which dim the OSDP plan may shard) and the OSDP
operator name the weight belongs to.  `build_param_set` turns specs + an
OSDP plan into flat parameters, each weight split into per-mode segments
along its ZDP axis when the plan mixes modes, plus the per-weight
`SegLayout` the forward pass reads.

Each segment carries its remat bit, resolved from the plan's per-slice
bits as the JAX package does, and `seg_matmul` names its outputs with
the JAX package's `checkpoint_name` tags (`kernels.ops.matmul`'s `tag`),
so `saved_activation_names` compiles a selective plan into the names a
checkpoint policy keeps.

On a data mesh (`launch.mesh.DataMesh`) a ZDP segment lives on each
rank as its shard along the weight's ZDP dimension
(`segment_placement`, the JAX module's `segment_sharding`, with its
divisibility guard), and its consumers gather it on use
(`sharding.collectives`): `seg_matmul` gathers each ZDP segment of a
mixed plan alone.  TP placements, hybrid meshes and the
`OverlapConfig` prefetch are not ported (ROADMAP section 1 items 5, 6).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.cluster.topology import parse_level_mode
from repro_torch.core.cost_model import DP, ZDP, ZDP_POD, Decision
from repro_torch.kernels import ops
from repro_torch.sharding.collectives import Gathered


@dataclass(frozen=True)
class WeightSpec:
    """Declaration of one parameter tensor."""

    path: str                       # flat path, e.g. "layers/ffn/w13"
    shape: Tuple[int, ...]
    op: str                         # OSDP operator this weight belongs to
    tp_axis: Optional[int] = None   # dim sharded over 'model' (None = no TP)
    zdp_axis: Optional[int] = None  # dim OSDP may shard (None = always DP)
    init: str = "normal"            # "normal" | "zeros" | "ones" | "fan_in"
                                    # | "ssm_a"
    init_scale: float = 0.02
    dtype: torch.dtype = torch.bfloat16
    stacked: bool = False           # leading dim is the layer axis


@dataclass
class Segment:
    """One contiguous slice of a weight along its ZDP axis."""

    mode: str
    start: int
    size: int
    key: str          # leaf name suffix ("" if single segment)
    # per-segment remat resolved from the plan's Decision.remat bits:
    # True = recompute this segment's activations, False = keep them,
    # None = inherit the run's global checkpointing default.  Segments
    # merge by sharding mode (storage), so a segment spanning slices
    # with mixed remat bits resolves to True (recompute, the
    # memory-safe direction).
    remat: Optional[bool] = None


@dataclass
class SegLayout:
    """Per-weight segmentation derived from the plan."""

    spec: WeightSpec
    segments: List[Segment]

    @property
    def is_split(self) -> bool:
        return len(self.segments) > 1


def _merge_modes(modes: Sequence[str], dim: int
                 ) -> List[Tuple[str, int, int, Tuple[int, ...]]]:
    """Merge adjacent equal-mode slices
    -> [(mode, start, size, contributing_slice_indices)].

    The slice boundaries quantize `dim` into len(modes) near-equal
    chunks, rounded to multiples of 128 where possible.  The index tuple
    records which plan slices contribute bytes to the merged segment
    (the JAX package resolves remat bits from it)."""
    g = len(modes)
    bounds = [0]
    for j in range(1, g):
        b = round(dim * j / g)
        if dim % 128 == 0 and dim // g >= 128:
            b = round(b / 128) * 128
        bounds.append(min(max(b, bounds[-1]), dim))
    bounds.append(dim)
    out: List[Tuple[str, int, int, Tuple[int, ...]]] = []
    for j, (m, s, e) in enumerate(zip(modes, bounds[:-1], bounds[1:])):
        if e <= s:
            continue
        if out and out[-1][0] == m:
            pm, ps, psz, pidx = out[-1]
            out[-1] = (pm, ps, psz + (e - s), pidx + (j,))
        else:
            out.append((m, s, e - s, (j,)))
    return out or [(modes[0], 0, dim, tuple(range(g)))]


def _segment_remat(decision: Optional[Decision],
                   idxs: Sequence[int]) -> Optional[bool]:
    """Resolve one merged segment's remat bit from the plan slices that
    contribute bytes to it: uniform -> that bit, mixed -> True
    (recompute is the memory-safe approximation), no explicit bits ->
    None (inherit)."""
    if decision is None or decision.remat is None:
        return None
    bits = set(decision.remat[j] for j in idxs)
    if bits == {True}:
        return True
    if bits == {False}:
        return False
    if bits == {None}:
        return None
    return True


def layout_for(spec: WeightSpec,
               decision: Optional[Decision]) -> SegLayout:
    """The JAX package's `layout_for`: the weight's segments, each with
    its mode and remat bit."""
    modes = decision.modes if decision is not None else (DP,)
    if spec.zdp_axis is None or len(modes) == 1:
        mode = modes[0] if spec.zdp_axis is not None else DP
        return SegLayout(spec, [Segment(
            mode, 0, spec.shape[spec.zdp_axis]
            if spec.zdp_axis is not None else 0, "",
            _segment_remat(decision, range(len(modes))))])
    dim = spec.shape[spec.zdp_axis]
    merged = _merge_modes(list(modes), dim)
    if len(merged) == 1:
        m, _, _, idxs = merged[0]
        return SegLayout(spec, [Segment(m, 0, dim, "",
                                        _segment_remat(decision, idxs))])
    return SegLayout(spec, [Segment(m, s, z, f"@{i}",
                                    _segment_remat(decision, idxs))
                            for i, (m, s, z, idxs) in enumerate(merged)])


def data_axis_names(mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the data-parallel extent (every axis that is
    not model/pipe).  The single definition of this rule;
    `core.plan.batch_axes` delegates here."""
    return tuple(a for a in mesh.axis_names if a not in ("model", "pipe"))


def _zdp_axes_names(mode: str, mesh) -> Optional[Tuple[str, ...]]:
    """Mesh axes a sharding mode spreads the weight over.  ZDP takes the
    whole data extent; level-k modes (`ZDP@k` / the depth-2 alias
    ZDP_POD) take the k innermost data axes, which on a one-axis data
    mesh is the data axis."""
    if mode == DP:
        return None
    data_axes = data_axis_names(mesh)
    if mode == ZDP:
        return data_axes
    if mode == ZDP_POD:
        return data_axes[-1:]
    k = parse_level_mode(mode)
    if k is not None:
        return data_axes[-k:]
    raise ValueError(mode)


def segment_placement(spec: WeightSpec, seg: Segment,
                      seg_shape: Tuple[int, ...], mesh) -> Optional[int]:
    """The dimension a segment's leaf is sharded on over `mesh`, or None
    (replicated: a DP segment, a weight OSDP never shards, or the
    divisibility guard: a ZDP dimension the ranks do not divide stays
    whole and is reduced like DP)."""
    names = _zdp_axes_names(seg.mode, mesh)
    if names is None or spec.zdp_axis is None:
        return None
    n = math.prod(mesh.shape[a] for a in names)
    if seg_shape[spec.zdp_axis] % n:
        return None
    return spec.zdp_axis


@dataclass
class ParamSet:
    """Segmentation metadata of a materialized (or declared) plan and,
    on a data mesh, each leaf's placement: the dimension its shard is
    cut along, or None for a replicated leaf."""

    layouts: Dict[str, SegLayout]              # weight path -> layout
    mesh: Optional[object] = None              # launch.mesh.DataMesh
    placements: Dict[str, Optional[int]] = field(default_factory=dict)
    # ZDP leaves the divisibility guard keeps replicated
    guarded: Tuple[str, ...] = ()

    def segments(self, path: str) -> List[Tuple[str, Segment]]:
        """[(leaf_key, segment)] for a declared weight path."""
        lay = self.layouts[path]
        return [(path + s.key, s) for s in lay.segments]

    def sharded(self) -> Dict[str, int]:
        """{leaf: dimension} of the leaves sharded over the mesh."""
        return {k: d for k, d in self.placements.items() if d is not None}

    def local(self, params: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """The rank's part of full parameters, keyed by leaf."""
        return {k: (self.mesh.shard(v, self.placements[k])
                    if self.placements.get(k) is not None else v)
                for k, v in params.items()}


def seg_shape(spec: WeightSpec, seg: Segment) -> Tuple[int, ...]:
    if spec.zdp_axis is None:
        return spec.shape
    shp = list(spec.shape)
    shp[spec.zdp_axis] = seg.size
    return tuple(shp)


def plan_layouts(specs: Sequence[WeightSpec],
                 decisions: Optional[Dict[str, Decision]],
                 mesh=None) -> ParamSet:
    """The plan's segmentation of every weight and, on `mesh`, every
    leaf's placement, without allocating."""
    layouts = {spec.path: layout_for(
        spec, decisions.get(spec.op) if decisions else None)
        for spec in specs}
    if mesh is None:
        return ParamSet(layouts)
    placements: Dict[str, Optional[int]] = {}
    guarded = []
    for spec in specs:
        for seg in layouts[spec.path].segments:
            leaf = spec.path + seg.key
            dim = segment_placement(spec, seg, seg_shape(spec, seg), mesh)
            placements[leaf] = dim
            if (dim is None and spec.zdp_axis is not None
                    and _zdp_axes_names(seg.mode, mesh) is not None):
                guarded.append(leaf)
    return ParamSet(layouts, mesh, placements, tuple(guarded))


def _init_tensor(spec: WeightSpec, shape: Tuple[int, ...],
                 gen: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=spec.dtype, device=device)
    if spec.init == "ssm_a":
        # Mamba2 A init: -exp(U[log 1, log 16]) stored as log(-A)
        u = torch.rand(shape, generator=gen, device=device)
        return (math.log(1.0) + (math.log(16.0) - math.log(1.0)) * u
                ).to(spec.dtype)
    scale = spec.init_scale
    if spec.init == "fan_in":
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(fan)
    out = torch.empty(shape, dtype=spec.dtype, device=device)
    # one layer at a time keeps the fp32 draw small at full width
    for sl in (out if spec.stacked and len(shape) > 1 else [out]):
        sl.copy_(torch.randn(sl.shape, generator=gen, device=device)
                 * scale)
    return out


def build_param_set(specs: Sequence[WeightSpec],
                    decisions: Optional[Dict[str, Decision]],
                    gen: torch.Generator, device, mesh=None
                    ) -> Tuple[Dict[str, torch.Tensor], ParamSet]:
    """Random parameters from `gen` on `device`, one tensor per segment,
    plus the layouts.  On `mesh` each rank draws every full tensor from
    the one generator and keeps its shard, so a world-W run starts from
    the world-1 weights.  The draws differ from `jax.random`: tests
    carry JAX parameters across with `repro_torch.convert.params_from_jax`."""
    pset = plan_layouts(specs, decisions, mesh)
    params: Dict[str, torch.Tensor] = {}
    for spec in specs:
        for seg in pset.layouts[spec.path].segments:
            leaf = spec.path + seg.key
            full = _init_tensor(spec, seg_shape(spec, seg), gen, device)
            params[leaf] = pset.local({leaf: full})[leaf] \
                if mesh is not None else full
    return params, pset


# --- selective-remat checkpoint policy ---------------------------------------

def saved_activation_names(layouts: Dict[str, SegLayout],
                           default_remat: bool
                           ) -> Tuple[Tuple[str, ...], bool]:
    """(names whose activations the checkpoint policy should save,
    whether anything remats at all) for a materialized plan.

    `seg_matmul` tags each segment's output: per-leaf names for
    output-dim (concat) segments, the bare weight path for the combined
    output (single-segment and input-dim-sum cases — where per-slice
    saving isn't representable, the whole output is saved only if every
    slice keeps its activations).  Unresolved (inherit) segments follow
    `default_remat`."""
    saved: List[str] = []
    any_remat = False
    for path, lay in layouts.items():
        kept = []
        for seg in lay.segments:
            r = bool(default_remat) if seg.remat is None else seg.remat
            if r:
                any_remat = True
                kept.append(False)
            else:
                saved.append(path + seg.key)
                kept.append(True)
        if len(lay.segments) > 1 and all(kept):
            saved.append(path)    # sum-variant tag on the whole output
    return tuple(sorted(set(saved))), any_remat


# --- helpers used by model forward passes -----------------------------------

def weight_use(params: Dict[str, torch.Tensor], pset: ParamSet, leaf: str,
               split=None) -> Tuple[object, bool]:
    """(the leaf as its consumers take it, whether it is new here): the
    tensor itself, or for a ZDP shard a new `Gathered` of it (cut into
    pieces by `split`), whose forward the caller ends after its uses.  A
    leaf already a `Gathered` (the model's head leaves over a step) is
    taken as it is.  The dimension accounts for the layer axis being
    indexed away inside the per-layer loop."""
    w = params[leaf]
    dim = pset.placements.get(leaf)
    if isinstance(w, Gathered) or dim is None:
        return w, False
    spec = pset.layouts[leaf.split("@")[0]].spec
    if spec.stacked and w.ndim == len(spec.shape) - 1:
        dim -= 1
    return Gathered(w, pset.mesh, dim, leaf, split), True


def gather_weight(params: Dict[str, torch.Tensor], pset: ParamSet,
                  path: str) -> torch.Tensor:
    """Concatenate a weight's segments back (for ops that don't exploit
    sequential slice processing), each ZDP segment gathered alone.  The
    axis accounts for the layer axis being indexed away inside the
    per-layer loop."""
    segs = pset.segments(path)
    parts = []
    for leaf, _ in segs:
        w, _ = weight_use(params, pset, leaf)
        parts.append(w.mesh.gather(w.shard, w.dim, leaf)
                     if isinstance(w, Gathered) else w)
    if len(parts) == 1:
        return parts[0]
    spec = pset.layouts[path].spec
    axis = spec.zdp_axis
    if spec.stacked and parts[0].ndim == len(spec.shape) - 1:
        axis -= 1
    return torch.cat(parts, dim=axis)


def seg_matmul(x: torch.Tensor, params: Dict[str, torch.Tensor],
               pset: ParamSet, path: str,
               in_axis_in_weight: int) -> torch.Tensor:
    """Operator splitting (§3.3) over per-mode segments.

    If the split axis is the weight's *input* (contraction) dim — the
    paper's Figure 4 case — segments are processed sequentially and
    summed: y = sum_j x[..., slice_j] @ W_j.  If it is the *output* dim,
    segment outputs are computed sequentially and concatenated.  Every
    contraction is the `split_matmul` kernel in its differentiable form.
    Outputs carry the JAX package's checkpoint tags: the weight path on
    a single segment's output and on the sum (one operator over all
    segments, so only the whole output has a name), each leaf's name on
    its part of a concatenation.  On a mesh each ZDP segment is gathered
    on use, alone (`weight_use`)."""
    segs = pset.segments(path)
    spec = pset.layouts[path].spec
    if in_axis_in_weight != 0:
        raise NotImplementedError("contractions over a weight's output "
                                  "axis come with the MoE slice")
    uses = [weight_use(params, pset, leaf) for leaf, _ in segs]
    ws = [w for w, _ in uses]
    if len(segs) == 1:
        y = _contract(x, ws[0], path)
    elif spec.zdp_axis - (1 if spec.stacked else 0) == in_axis_in_weight:
        # sum variant (input-dim split, Figure 4): x's slices times the
        # segments, summed in segment order
        y = _contract(x, ws, path)
    else:
        # concat variant (output-dim split): per-segment names, so remat
        # stays a per-slice choice
        y = torch.cat([_contract(x, w, leaf)
                       for w, (leaf, _) in zip(ws, segs)], dim=-1)
    for w, new in uses:
        if new:
            w.end_forward()
    return y


def _contract(x: torch.Tensor, w, tag: str = "") -> torch.Tensor:
    """x[..., K] @ w:(K, N), through the `split_matmul` kernel; `w` may
    be a list of (K_j, N) row blocks of the weight (sum K_j = K), whose
    products with x's matching slices are summed.  A weight may be a
    `Gathered` ZDP weight (gathered on use).  `tag` names the output for
    a selective checkpoint."""
    ws = w if isinstance(w, list) else [w]
    ts = [v.views[0] if isinstance(v, Gathered) else v for v in ws]
    pieces = [v.piece() if isinstance(v, Gathered) else None for v in ws]
    if any(t.ndim != 2 for t in ts):
        raise NotImplementedError(
            f"contraction with a {ts[0].ndim}-D weight (expert weights "
            f"come with the MoE slice)")
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    return ops.matmul(x2, ts, tag=tag,
                      pieces=pieces if any(pieces) else None).reshape(
        *x.shape[:-1], ts[0].shape[1])
