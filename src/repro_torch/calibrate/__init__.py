"""Calibration subsystem: measure, fit, and ship per-device constants.

`python -m repro_torch calibrate` (launch/calibrate.py) runs the timed
sweeps in :mod:`repro_torch.calibrate.bench` on the port's own kernels
and collectives, fits them with :mod:`repro_torch.calibrate.fit`, and
writes a :class:`~repro_torch.calibrate.profile.CalibrationProfile`
that plugs into ``CostEnv(..., profile=...)`` or ``osdp(...,
profile=...)``.  ``profile=None`` keeps the legacy scalar constants
byte-identical.  Fitted profiles committed for the presets live in
``profiles/`` (``profiles/h100-sxm.json``).
"""
from repro_torch.calibrate.profile import (CalibrationProfile,
                                           EfficiencyCurve, LinkCalibration,
                                           default_profile)
from repro_torch.calibrate.fit import (fit_alpha_beta, fit_efficiency_curve,
                                       fit_link_calibrations,
                                       fit_remat_factor)
from repro_torch.calibrate import store

__all__ = [
    "CalibrationProfile", "EfficiencyCurve", "LinkCalibration",
    "default_profile", "fit_alpha_beta", "fit_efficiency_curve",
    "fit_link_calibrations", "fit_remat_factor", "store",
]
