"""Hierarchical cluster topology for topology-aware planning."""
from repro_torch.cluster.topology import (  # noqa: F401
    ClusterLevel, ClusterSpec, DeviceGroup, gpu_cluster, level_mode,
    mixed_memory_fleet, parse_level_mode, tpu_multipod)
