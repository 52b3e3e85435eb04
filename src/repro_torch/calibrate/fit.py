"""Fitting timed samples to the cost model's constants.

Three fits, all closed-form numpy (no scipy):

* :func:`fit_efficiency_curve` — (flops, seconds) matmul samples to a
  monotone achieved-fraction-of-peak curve (isotonic regression via
  pool-adjacent-violators).
* :func:`fit_alpha_beta` — (bytes, seconds) collective samples to the
  classic ``t = alpha + B/bw`` latency/bandwidth model (least squares
  with non-negativity clamps).
* :func:`fit_remat_factor` — plain vs remat'd step times to the
  recompute factor, clamped to the model's sane range.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from repro_torch.calibrate.profile import EfficiencyCurve, LinkCalibration


def _pava_non_decreasing(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted isotonic regression (non-decreasing), pool-adjacent-
    violators: the least-squares monotone fit to ``y``."""
    vals = list(map(float, y))
    wts = list(map(float, w))
    # each block: [value, weight, count]
    blocks = [[v, wt, 1] for v, wt in zip(vals, wts)]
    out = []
    for b in blocks:
        out.append(b)
        while len(out) > 1 and out[-2][0] > out[-1][0]:
            v2, w2, c2 = out.pop()
            v1, w1, c1 = out.pop()
            wt = w1 + w2
            out.append([(v1 * w1 + v2 * w2) / wt, wt, c1 + c2])
    fitted = []
    for v, _, c in out:
        fitted.extend([v] * c)
    return np.asarray(fitted)


def fit_efficiency_curve(samples: Iterable[Tuple[float, float]],
                         peak_flops: float) -> EfficiencyCurve:
    """Fit (total_flops, seconds) matmul timings to an
    :class:`EfficiencyCurve`.

    Achieved fraction per sample is ``flops / seconds / peak``;
    duplicate sizes are averaged, the sequence is made monotone
    non-decreasing in size (isotonic regression), and fractions are
    clipped into ``(0, 1]`` so measurement noise above peak cannot
    leak >1 efficiencies into the planner.
    """
    by_size: Dict[float, list] = {}
    for flops, seconds in samples:
        if flops <= 0 or seconds <= 0:
            raise ValueError(f"bad sample ({flops}, {seconds})")
        by_size.setdefault(float(flops), []).append(
            flops / seconds / peak_flops)
    if not by_size:
        raise ValueError("no samples")
    sizes = np.array(sorted(by_size))
    frac = np.array([np.mean(by_size[s]) for s in sizes])
    wts = np.array([len(by_size[s]) for s in sizes], dtype=float)
    frac = _pava_non_decreasing(frac, wts)
    frac = np.clip(frac, 1e-9, 1.0)
    # isotonic fit can leave equal-valued plateaus; knots only need
    # the breakpoints, but keeping every size keeps .at() exact there
    return EfficiencyCurve(tuple(map(float, np.log10(sizes))),
                           tuple(map(float, frac)))


def fit_alpha_beta(samples: Sequence[Tuple[float, float]],
                   ) -> Tuple[float, float]:
    """Least-squares fit of (bytes, seconds) to ``t = alpha + B/bw``.

    Returns ``(alpha, bandwidth)``.  If the fitted intercept is
    negative (noise at small sizes), alpha is clamped to 0 and the
    slope refit through the origin.  Needs >= 2 distinct sizes.
    """
    b = np.array([float(s[0]) for s in samples])
    t = np.array([float(s[1]) for s in samples])
    if len(b) < 2 or len(set(b.tolist())) < 2:
        raise ValueError("alpha-beta fit needs >= 2 distinct sizes")
    if (t <= 0).any() or (b < 0).any():
        raise ValueError("non-positive time or negative size sample")
    slope, alpha = np.polyfit(b, t, 1)
    if alpha < 0:
        alpha = 0.0
        slope = float(np.dot(b, t) / np.dot(b, b))
    if slope <= 0:
        # latency-dominated sweep: bandwidth unresolvable, report the
        # best single-sample bound instead of a negative slope
        slope = float(np.min(t / np.maximum(b, 1.0)))
    return float(alpha), float(1.0 / slope)


def fit_link_calibrations(sweeps: Dict[str, Sequence[Tuple[float, float]]],
                          ) -> Tuple[LinkCalibration, ...]:
    """Fit one :class:`LinkCalibration` per level from per-level
    (bytes, seconds) sweeps; levels with < 2 distinct sizes are
    skipped (span-1 axes move no bytes)."""
    out = []
    for level, samples in sweeps.items():
        sizes = {float(s[0]) for s in samples}
        if len(sizes) < 2:
            continue
        alpha, bw = fit_alpha_beta(samples)
        out.append(LinkCalibration(level, alpha, bw))
    return tuple(out)


def fit_remat_factor(plain_seconds: float, remat_seconds: float,
                     lo: float = 1.0, hi: float = 2.0) -> float:
    """Recompute factor from paired step timings: the measured
    ``remat/plain`` ratio, clamped to ``[lo, hi]`` (a factor below 1
    is measurement noise; above 2 would mean recompute cost exceeds
    the whole forward+backward, which the checkpointing scheme cannot
    produce)."""
    if plain_seconds <= 0 or remat_seconds <= 0:
        raise ValueError("non-positive step time")
    return float(min(hi, max(lo, remat_seconds / plain_seconds)))
