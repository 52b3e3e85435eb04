"""Achieved collective bandwidth per mesh axis: the bandwidth half of
the JAX package's `launch/perf_probe.py`.

`measure_level_bandwidth` times `DataMesh.gather` (NCCL on cards, gloo
on the CPU) of a float32 shard on each axis, `bandwidth_sweep` sweeps it
over message sizes and fits alpha-beta link constants, and
`overlap_sanity` pairs what was measured with the preset `ClusterSpec`'s
assumed level bandwidths.  `python -m repro_torch calibrate` ships the
fitted links as a profile's `LinkCalibration`s.

The probe's `main()` (lowering one combo over 512 devices with model
and pipe axes) waits for the model and pipe axes (ROADMAP section 1
items 5.2-5.4).
"""
from __future__ import annotations

import time

import torch


def measure_level_bandwidth(mesh, size_mib: float = 4.0,
                            repeats: int = 3) -> dict:
    """Timed all-gather over each axis of a `DataMesh`: achieved bytes/s
    per level.  Axes of span 1 move no bytes and report
    ``achieved_bytes_per_s: None``.  Each rank gathers a float32 shard
    of ``n_ax / ways`` elements into ``n_ax``; ``seconds`` is the mean
    of `repeats` gathers after one warm-up, each synchronised on the
    card."""
    out = {}
    n = max(1, int(size_mib * 2**20) // 4)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.backend == "nccl" else torch.device("cpu"))
    for axis in mesh.axis_names:
        ways = int(mesh.shape[axis])
        if ways < 2:
            out[axis] = {"ways": ways, "bytes_moved": 0, "seconds": 0.0,
                         "achieved_bytes_per_s": None}
            continue
        n_ax = max(ways, (n // ways) * ways)
        shard = torch.zeros(n_ax // ways, dtype=torch.float32,
                            device=device)

        def gather():
            mesh.gather(shard, 0, key=f"perf_probe/{axis}")
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        gather()                                  # warm up
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(repeats):
            gather()
        dt = (time.perf_counter() - t0) / repeats
        # ring all-gather: each device receives (ways-1)/ways of the array
        moved = 4 * n_ax * (ways - 1) // ways
        out[axis] = {"ways": ways, "bytes_moved": moved, "seconds": dt,
                     "achieved_bytes_per_s": moved / dt if dt > 0 else None}
    return out


def bandwidth_sweep(mesh, sizes_mib=(0.25, 1.0, 4.0, 16.0),
                    repeats: int = 3) -> dict:
    """`measure_level_bandwidth` swept over message sizes, with a
    per-axis alpha-beta fit: ``t(B) = alpha + B / bandwidth``.  The
    fitted constants are what `python -m repro_torch calibrate` ships as
    per-level `LinkCalibration`s; span-1 axes report ``fit: None``.
    Returns ``{axis: {"samples": [(bytes, seconds), ...], "fit":
    {"alpha": s, "bandwidth": bytes/s} | None}}``."""
    from repro_torch.calibrate.fit import fit_alpha_beta

    out = {str(a): {"samples": [], "fit": None}
           for a in mesh.axis_names}
    for mib in sizes_mib:
        rec = measure_level_bandwidth(mesh, size_mib=mib,
                                      repeats=repeats)
        for axis, row in rec.items():
            if row["bytes_moved"] > 0:
                out[str(axis)]["samples"].append(
                    (row["bytes_moved"], row["seconds"]))
    for axis, row in out.items():
        if len({b for b, _ in row["samples"]}) >= 2:
            alpha, bw = fit_alpha_beta(row["samples"])
            row["fit"] = {"alpha": alpha, "bandwidth": bw}
    return out


def overlap_sanity(measured: dict, device_name: str,
                   n_devices: int) -> list:
    """Pair measured per-axis bandwidth with the preset ClusterSpec's
    assumed level bandwidths (innermost axis <-> innermost level).
    ``achieved_over_spec`` far below 1 says the level's `overlap`
    factor is optimistic for this backend."""
    from repro_torch.cluster.topology import ClusterSpec
    from repro_torch.configs import DeviceInfo

    spec = ClusterSpec.from_device(DeviceInfo.preset(device_name),
                                   n_devices)
    rows = []
    axes = [a for a in reversed(list(measured))
            if measured[a]["ways"] > 1]
    for axis, level in zip(axes, spec.levels):
        got = measured[axis]["achieved_bytes_per_s"]
        rows.append({
            "axis": axis, "level": level.name,
            "spec_bytes_per_s": level.bandwidth,
            "spec_overlap": level.overlap,
            "achieved_bytes_per_s": got,
            "achieved_over_spec":
                round(got / level.bandwidth, 6) if got else None,
        })
    return rows
