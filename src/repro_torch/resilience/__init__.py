"""Deterministic fault injection (`faults`), queried by the serving
engine's hooks.  The supervisors come with a later slice."""
from repro_torch.resilience.faults import (CheckpointCrash,  # noqa: F401
                                           DeviceGroupLoss, DeviceLost,
                                           EMPTY_SCHEDULE, FaultSchedule,
                                           MemoryPressure, SlowRequest,
                                           TransientFailures)
