"""Calibrated per-device constants (ROADMAP item 3).

The cost model's three hand-set constants — the scalar
``mxu_efficiency``, the datasheet ``ClusterLevel`` alpha/bandwidth
pairs, and the 1.30 recompute factor — are exactly the quantities a
timed micro-benchmark can measure.  This module defines the fitted
replacements:

* :class:`EfficiencyCurve` — achieved fraction of peak flops as a
  piecewise-linear function of matmul size (log10 flops), replacing
  the single scalar derating.
* :class:`LinkCalibration` — a fitted (alpha, bandwidth) pair for one
  named ``ClusterLevel``, from an alpha-beta fit over message sizes.
* :class:`CalibrationProfile` — the serializable bundle attached to a
  ``CostEnv``.  ``profile=None`` everywhere keeps the legacy scalar
  path byte-identical; every committed golden is pinned on it.

Nothing here imports jax or any other repro module: the profile is a
plain value type so `configs`, `core` and `cluster` can consume it
without import cycles.  The timed benchmarks live in
:mod:`repro.calibrate.bench`; the fitting math in
:mod:`repro.calibrate.fit`.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class EfficiencyCurve:
    """Achieved fraction of peak compute vs operator size.

    Knots are ``log10(flops)`` of the measured matmuls; ``fraction``
    holds the achieved/peak ratio at each knot.  The curve is pinned
    monotone non-decreasing (bigger ops amortize launch/memory
    overheads at least as well) and clamped to its endpoint values
    outside the measured range, so an extrapolated query can never
    invent an efficiency the benchmark did not observe.
    """

    log10_flops: Tuple[float, ...]
    fraction: Tuple[float, ...]

    def __post_init__(self):
        if len(self.log10_flops) != len(self.fraction):
            raise ValueError("knot/fraction length mismatch: "
                             f"{len(self.log10_flops)} vs "
                             f"{len(self.fraction)}")
        if not self.log10_flops:
            raise ValueError("EfficiencyCurve needs at least one knot")
        for a, b in zip(self.log10_flops, self.log10_flops[1:]):
            if not b > a:
                raise ValueError("knots must be strictly increasing")
        for a, b in zip(self.fraction, self.fraction[1:]):
            if b < a:
                raise ValueError("fractions must be non-decreasing "
                                 "(fit with calibrate.fit to enforce)")
        for f in self.fraction:
            if not 0.0 < f <= 1.0:
                raise ValueError(f"fraction {f} outside (0, 1]")

    @classmethod
    def constant(cls, fraction: float) -> "EfficiencyCurve":
        """Degenerate one-knot curve: the legacy scalar efficiency."""
        return cls((0.0,), (float(fraction),))

    def at(self, flops: float) -> float:
        """Achieved fraction of peak for an operator of ``flops``
        total work, clamped to the measured range."""
        xs, ys = self.log10_flops, self.fraction
        if len(xs) == 1:
            return ys[0]
        x = math.log10(flops) if flops > 0 else xs[0]
        if x <= xs[0]:
            return ys[0]
        if x >= xs[-1]:
            return ys[-1]
        # knot count is small (benchmark sweep sizes); linear scan
        for i in range(1, len(xs)):
            if x <= xs[i]:
                t = (x - xs[i - 1]) / (xs[i] - xs[i - 1])
                return ys[i - 1] + t * (ys[i] - ys[i - 1])
        return ys[-1]   # pragma: no cover - unreachable


@dataclass(frozen=True)
class LinkCalibration:
    """Fitted alpha-beta constants for one cluster level.

    ``t(B) = alpha + B / bandwidth`` — ``alpha`` is the per-ring-step
    latency in seconds, ``bandwidth`` the achieved (not datasheet)
    bytes/s, both from a least-squares fit over a message-size sweep.
    ``level`` names the ``ClusterLevel`` this applies to ("data",
    "pod", "node", ...).
    """

    level: str
    alpha: float
    bandwidth: float

    def __post_init__(self):
        if self.alpha < 0:
            raise ValueError(f"negative alpha {self.alpha}")
        if self.bandwidth <= 0:
            raise ValueError(f"non-positive bandwidth {self.bandwidth}")


@dataclass(frozen=True)
class CalibrationProfile:
    """Measured replacements for the cost model's assumed constants.

    Attach to a ``CostEnv`` via ``CostEnv(..., profile=profile)``.
    ``device`` names the preset the numbers were measured for;
    ``peak_flops`` records what peak the efficiency fractions were
    normalized against (informational — pricing always uses the
    env's ``DeviceInfo.peak_flops``).
    """

    device: str
    efficiency: EfficiencyCurve
    links: Tuple[LinkCalibration, ...] = ()
    remat_factor: float = 1.30
    peak_flops: Optional[float] = None
    source: str = ""

    def __post_init__(self):
        if not 1.0 <= self.remat_factor <= 3.0:
            raise ValueError(
                f"remat_factor {self.remat_factor} outside [1, 3]")
        names = [ln.level for ln in self.links]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate link levels: {names}")

    # -- JSON round-trip ---------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "device": self.device,
            "efficiency": {
                "log10_flops": list(self.efficiency.log10_flops),
                "fraction": list(self.efficiency.fraction),
            },
            "links": [
                {"level": ln.level, "alpha": ln.alpha,
                 "bandwidth": ln.bandwidth}
                for ln in self.links
            ],
            "remat_factor": self.remat_factor,
            "peak_flops": self.peak_flops,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "CalibrationProfile":
        eff = d["efficiency"]
        return cls(
            device=d["device"],
            efficiency=EfficiencyCurve(tuple(eff["log10_flops"]),
                                       tuple(eff["fraction"])),
            links=tuple(LinkCalibration(ln["level"], ln["alpha"],
                                        ln["bandwidth"])
                        for ln in d.get("links", ())),
            remat_factor=d.get("remat_factor", 1.30),
            peak_flops=d.get("peak_flops"),
            source=d.get("source", ""),
        )

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "CalibrationProfile":
        with open(path) as f:
            return cls.from_json(f.read())


def default_profile(device) -> CalibrationProfile:
    """The scalar constants of a ``DeviceInfo``, expressed as a
    (degenerate) profile: constant efficiency curve at
    ``mxu_efficiency``, no fitted links, the hand-set 1.30 recompute
    factor.  Attaching it to a ``CostEnv`` reproduces the legacy
    ``profile=None`` numbers to ~1e-15 relative (the only difference
    is ``remat_factor - 1.0`` vs the literal ``0.30`` in the
    selective-remat slope, one ulp apart)."""
    return CalibrationProfile(
        device=device.name,
        efficiency=EfficiencyCurve.constant(device.mxu_efficiency),
        remat_factor=1.30,
        peak_flops=device.peak_flops,
        source="datasheet",
    )
