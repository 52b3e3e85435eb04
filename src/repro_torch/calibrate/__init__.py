"""Calibration profile (the planner's measured-constants input).

Only `profile` is ported so far; the measuring sweeps and the fit
come with the measurement-tooling slice."""
from repro_torch.calibrate.profile import (CalibrationProfile,  # noqa: F401
                                           EfficiencyCurve,
                                           LinkCalibration,
                                           default_profile)
