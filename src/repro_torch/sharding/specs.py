"""Parameter layout: OSDP segments (paper §3.3 per-slice plans) on torch.

Every model declares its parameters as `WeightSpec`s: shape, the TP
placement, the ZDP axis (which dim the OSDP plan may shard) and the OSDP
operator name the weight belongs to.  `build_param_set` turns specs + an
OSDP plan into flat parameters, each weight split into per-mode segments
along its ZDP axis when the plan mixes modes, plus the per-weight
`SegLayout` the forward pass reads.

This slice runs on one device, so segments carry their mode but no
placement: device sharding (the JAX module's NamedSharding helpers) and
the `OverlapConfig` prefetch come with the sharded-execution slice, and
the per-segment remat bits and `checkpoint_name` tags with selective
remat.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import DP, Decision
from repro_torch.kernels import ops


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


def layout_for(spec: WeightSpec,
               decision: Optional[Decision]) -> SegLayout:
    """The JAX package's `layout_for`, without the per-segment remat
    bits (`models.registry` reads a plan's remat axis from its
    decisions, and runs only a plan that remats all or nothing)."""
    modes = decision.modes if decision is not None else (DP,)
    if spec.zdp_axis is None or len(modes) == 1:
        mode = modes[0] if spec.zdp_axis is not None else DP
        return SegLayout(spec, [Segment(
            mode, 0, spec.shape[spec.zdp_axis]
            if spec.zdp_axis is not None else 0, "")])
    dim = spec.shape[spec.zdp_axis]
    merged = _merge_modes(list(modes), dim)
    if len(merged) == 1:
        return SegLayout(spec, [Segment(merged[0][0], 0, dim, "")])
    return SegLayout(spec, [Segment(m, s, z, f"@{i}")
                            for i, (m, s, z, _) in enumerate(merged)])


@dataclass
class ParamSet:
    """Segmentation metadata of a materialized (or declared) plan."""

    layouts: Dict[str, SegLayout]              # weight path -> layout

    def segments(self, path: str) -> List[Tuple[str, Segment]]:
        """[(leaf_key, segment)] for a declared weight path."""
        lay = self.layouts[path]
        return [(path + s.key, s) for s in lay.segments]


def seg_shape(spec: WeightSpec, seg: Segment) -> Tuple[int, ...]:
    if spec.zdp_axis is None:
        return spec.shape
    shp = list(spec.shape)
    shp[spec.zdp_axis] = seg.size
    return tuple(shp)


def plan_layouts(specs: Sequence[WeightSpec],
                 decisions: Optional[Dict[str, Decision]]) -> ParamSet:
    """The plan's segmentation of every weight, without allocating."""
    return ParamSet({spec.path: layout_for(
        spec, decisions.get(spec.op) if decisions else None)
        for spec in specs})


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
                    gen: torch.Generator, device
                    ) -> Tuple[Dict[str, torch.Tensor], ParamSet]:
    """Random parameters from `gen` on `device`, one tensor per segment,
    plus the layouts.  The draws differ from `jax.random`: tests carry
    JAX parameters across with `repro_torch.convert.params_from_jax`."""
    pset = plan_layouts(specs, decisions)
    params: Dict[str, torch.Tensor] = {}
    for spec in specs:
        for seg in pset.layouts[spec.path].segments:
            params[spec.path + seg.key] = _init_tensor(
                spec, seg_shape(spec, seg), gen, device)
    return params, pset


# --- helpers used by model forward passes -----------------------------------

def gather_weight(params: Dict[str, torch.Tensor], pset: ParamSet,
                  path: str) -> torch.Tensor:
    """Concatenate a weight's segments back (for ops that don't exploit
    sequential slice processing).  The axis accounts for the layer axis
    being indexed away inside the per-layer loop."""
    segs = pset.segments(path)
    if len(segs) == 1:
        return params[segs[0][0]]
    spec = pset.layouts[path].spec
    axis = spec.zdp_axis
    if spec.stacked and params[segs[0][0]].ndim == len(spec.shape) - 1:
        axis -= 1
    return torch.cat([params[k] for k, _ in segs], dim=axis)


def seg_matmul(x: torch.Tensor, params: Dict[str, torch.Tensor],
               pset: ParamSet, path: str,
               in_axis_in_weight: int) -> torch.Tensor:
    """Operator splitting (§3.3) over per-mode segments.

    If the split axis is the weight's *input* (contraction) dim — the
    paper's Figure 4 case — segments are processed sequentially and
    summed: y = sum_j x[..., slice_j] @ W_j.  If it is the *output* dim,
    segment outputs are computed sequentially and concatenated.  Every
    contraction is the `split_matmul` kernel in its differentiable form
    (the sum and concat carry the gradient to each segment)."""
    segs = pset.segments(path)
    spec = pset.layouts[path].spec
    if in_axis_in_weight != 0:
        raise NotImplementedError("contractions over a weight's output "
                                  "axis come with the MoE slice")
    if len(segs) == 1:
        return _contract(x, params[segs[0][0]])
    zdp_local = spec.zdp_axis - (1 if spec.stacked else 0)
    if zdp_local == in_axis_in_weight:
        # sum variant (input-dim split, Figure 4)
        y = None
        off = 0
        for leaf, seg in segs:
            part = _contract(x[..., off:off + seg.size], params[leaf])
            y = part if y is None else y + part
            off += seg.size
        return y
    # concat variant (output-dim split)
    return torch.cat([_contract(x, params[leaf]) for leaf, _ in segs],
                     dim=-1)


def _contract(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x[..., K] @ w:(K, N), through the `split_matmul` kernel."""
    if w.ndim != 2:
        raise NotImplementedError(
            f"contraction with a {w.ndim}-D weight (expert weights come "
            f"with the MoE slice)")
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    return ops.matmul(x2, w).reshape(*x.shape[:-1], w.shape[1])
