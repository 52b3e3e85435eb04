"""`python -m repro_torch calibrate` — measure and fit the cost model's
constants on this card into a CalibrationProfile.

    python -m repro_torch calibrate --cpu --quick --out profile.json
    python -m repro_torch calibrate --device h100-sxm --peak-flops 989e12 \\
        --matmul-sizes 128,256,512,1024,2048,4096,8192,16384 \\
        --remat-depth 8 --remat-width 16384 \\
        --out src/repro_torch/calibrate/profiles/h100-sxm.json
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m repro_torch calibrate --cpu --quick --out profile.json

Three timed sweeps (`repro_torch.calibrate.bench`) feed three fits
(`repro_torch.calibrate.fit`):

  1. square bf16 products over a size ladder through the port's
     `split_matmul` -> EfficiencyCurve (achieved fraction of peak vs
     log-flops),
  2. all-gathers over a message-size ladder on the data mesh
     -> a LinkCalibration for the `data` level (alpha + bytes/bandwidth),
  3. the gradient of a matmul chain, plain vs `torch.utils.checkpoint`
     -> remat factor.

The curve is normalized against `--peak-flops` when given (fractions of
a datasheet peak; the planner multiplies them by the preset's own peak),
else against the best achieved rate.  It runs on the card unless
`--cpu` is given (the kernels' plain versions: the numbers then
calibrate the CPU); without a card and without `--cpu` it raises, and
never falls back.  Under `torchrun` with W > 1 ranks it opens a data
mesh (NCCL on cards, gloo with `--cpu`), sweeps the all-gather over it
and fits the link; a lone process fits none.  Only rank 0 prints the
record (`profile`, `measured`, `elapsed_s`, `out`) and writes the
profile, whose JSON round-trips through `CalibrationProfile.load` and
plugs into `osdp(..., profile=)` or `repro_torch.calibrate.store`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from repro_torch.calibrate import bench, fit
from repro_torch.calibrate.profile import CalibrationProfile
from repro_torch.launch.mesh import init_data_mesh, make_host_mesh
from repro_torch.models.registry import resolve_device


def _csv_ints(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def _csv_floats(text: str):
    return tuple(float(x) for x in text.split(",") if x)


def card_name() -> str:
    """The card's name and power limit as `nvidia-smi` gives them, or
    its name alone where `nvidia-smi` cannot be run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        out = None
    if out is not None and out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name()}, power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch calibrate")
    ap.add_argument("--device", default="host",
                    help="profile name: a DeviceInfo preset to "
                         "calibrate against, or a free name for this "
                         "backend (default: host)")
    ap.add_argument("--out", default=None, metavar="PROFILE_JSON",
                    help="write the fitted CalibrationProfile here")
    ap.add_argument("--matmul-sizes", type=_csv_ints,
                    default=bench.DEFAULT_MATMUL_SIZES)
    ap.add_argument("--bw-mib", type=_csv_floats,
                    default=bench.DEFAULT_BW_MIB)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--peak-flops", type=float, default=0.0,
                    help="normalize the efficiency curve against this "
                         "peak instead of the best achieved rate")
    ap.add_argument("--remat-depth", type=int, default=8)
    ap.add_argument("--remat-width", type=int, default=256)
    ap.add_argument("--quick", action="store_true",
                    help="small sweeps (CI / smoke): 3 matmul sizes, "
                         "2 message sizes, 1 repeat")
    ap.add_argument("--cpu", action="store_true",
                    help="measure the CPU (the kernels' plain versions) "
                         "instead of the card")
    args = ap.parse_args(argv)
    if args.quick:
        args.matmul_sizes = args.matmul_sizes[:3]
        args.bw_mib = args.bw_mib[:2]
        args.repeats = 1

    dev = resolve_device("cpu" if args.cpu else None)
    world = int(os.environ.get("WORLD_SIZE", 1)) \
        if "RANK" in os.environ else 1
    if world > 1:
        mesh = init_data_mesh("gloo" if args.cpu else "nccl")
        if not args.cpu:
            dev = torch.device("cuda", torch.cuda.current_device())
    else:
        mesh = make_host_mesh()
    try:
        t0 = time.perf_counter()
        # 1. compute: the split_matmul ladder -> efficiency curve
        mm = bench.matmul_sweep(args.matmul_sizes, repeats=args.repeats,
                                device=dev)
        peak = args.peak_flops or bench.measured_peak_flops(mm)
        curve = fit.fit_efficiency_curve(mm, peak_flops=peak)
        # 2. collectives: all-gathers on the data axis -> link fit (axis
        # names match ClusterSpec.from_flat's, so the link binds by name)
        sweeps = (bench.collective_sweep(mesh, args.bw_mib,
                                         repeats=args.repeats)
                  if mesh.world > 1 else {})
        links = fit.fit_link_calibrations(sweeps)
        # 3. remat: plain vs checkpointed chain gradient -> recompute
        t_plain, t_remat = bench.remat_sweep(
            depth=args.remat_depth, width=args.remat_width,
            repeats=args.repeats, device=dev)
        remat = fit.fit_remat_factor(t_plain, t_remat)
        elapsed = time.perf_counter() - t0
    finally:
        mesh.destroy()
    if mesh.rank != 0:
        return 0

    card = card_name() if dev.type == "cuda" else "no card"
    source = (f"python -m repro_torch calibrate ({dev.type}, {card}, world "
              f"{mesh.world}{f' {mesh.backend}' if mesh.backend else ''}; "
              f"bf16 split_matmul ladder "
              f"{','.join(map(str, args.matmul_sizes))}; remat chain depth "
              f"{args.remat_depth} width {args.remat_width}; repeats "
              f"{args.repeats})")
    profile = CalibrationProfile(
        device=args.device, efficiency=curve, links=links,
        remat_factor=remat, peak_flops=peak, source=source)
    # the round-trip guarantee the planner relies on
    if CalibrationProfile.from_json(profile.to_json()) != profile:
        raise RuntimeError("the fitted profile does not round-trip JSON")

    rec = {
        "profile": profile.to_dict(),
        "measured": {
            "matmul": [{"flops": f, "seconds": s} for f, s in mm],
            "peak_flops": peak,
            "collectives": {a: [{"bytes": b, "seconds": s} for b, s in rows]
                            for a, rows in sweeps.items()},
            "remat_plain_s": t_plain,
            "remat_remat_s": t_remat,
        },
        "elapsed_s": elapsed,
    }
    if args.out:
        profile.save(args.out)
        rec["out"] = args.out
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
