"""The port's calibration subsystem against the JAX package's, on the CPU.

- `repro_torch.calibrate.fit` gives exactly `repro.calibrate.fit`'s
  outputs on the same samples (drawn with numpy from a seed): the same
  numpy arithmetic, so equality, not a tolerance.
- `repro_torch.calibrate.store` behaves as `repro.calibrate.store`.
- The committed `profiles/h100-sxm.json` (fitted on the card by
  `python -m repro_torch calibrate`) loads in both packages, and both
  planners give the same decisions and estimates from it; its knots
  span the operator sizes those plans read.
- `bench` on the CPU at tiny sizes: the ladder goes through
  `ops.split_matmul`, the checkpointed chain's gradients equal the plain
  chain's bit for bit; `split_matmul.plan_launch` takes a new design at
  every ladder and remat-chain shape.
- The launcher: one process writes a profile the JAX package reads; a
  2-rank gloo world under `torch.distributed.run` fits one `data` link
  from `DataMesh.gather`; the command's exit codes.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.calibrate import fit as ref_fit
from repro.calibrate import store as ref_store
from repro.calibrate.profile import CalibrationProfile as RefProfile
from repro.configs import DeviceInfo as RefDeviceInfo
from repro.configs import MeshConfig as RefMeshConfig
from repro.configs import get_arch as ref_get_arch
from repro.configs import get_shape as ref_get_shape
from repro.core.api import osdp as ref_osdp
from repro.core.api import search_serve as ref_search_serve
from repro.launch.perf_probe import overlap_sanity as ref_overlap_sanity

from repro_torch import __main__ as cli
from repro_torch.calibrate import bench, fit, store
from repro_torch.calibrate.profile import (CalibrationProfile,
                                           EfficiencyCurve)
from repro_torch.configs import (DEVICE_PRESETS, DeviceInfo, MeshConfig,
                                 ShapeConfig, get_arch, get_shape)
from repro_torch.core.api import osdp, search_serve
from repro_torch.core.descriptions import describe
from repro_torch.kernels import ops
from repro_torch.kernels.split_matmul import BWD_KSLICE, plan_launch
from repro_torch.launch import calibrate as launcher
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.perf_probe import (bandwidth_sweep,
                                           measure_level_bandwidth,
                                           overlap_sanity)

ROOT = Path(__file__).resolve().parent.parent
PROFILE = ROOT / "src/repro_torch/calibrate/profiles/h100-sxm.json"
PEAK = 989e12
LADDER = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
REMAT_DEPTH, REMAT_WIDTH, REMAT_BATCH = 8, 16384, 64   # the card's run


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                OMP_NUM_THREADS="1")


# --- fits: exact parity with the JAX package --------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_pava_matches_reference(seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=12)
    w = rng.integers(1, 4, size=12).astype(float)
    got = fit._pava_non_decreasing(y, w)
    want = ref_fit._pava_non_decreasing(y, w)
    assert np.array_equal(got, want)
    assert (np.diff(got) >= 0).all()


def _curve_samples(kind, rng):
    sizes = 2.0 * np.array([32, 64, 128, 256, 512, 1024, 2048]) ** 3
    frac = np.sort(rng.uniform(0.01, 0.8, sizes.size))
    if kind == "noisy":            # not monotone: PAVA merges blocks
        frac = rng.uniform(0.01, 0.8, sizes.size)
    if kind == "above_peak":       # clipped into (0, 1]
        frac[-2:] = [1.3, 1.7]
    samples = [(float(s), float(s / (f * PEAK))) for s, f in
               zip(sizes, frac)]
    if kind == "duplicates":       # a size measured twice is averaged
        samples += [(s, t * rng.uniform(0.5, 2.0)) for s, t in samples[::2]]
    return samples


@pytest.mark.parametrize("kind", ["monotone", "noisy", "above_peak",
                                  "duplicates"])
def test_efficiency_curve_matches_reference(kind):
    samples = _curve_samples(kind, np.random.default_rng(7))
    got = fit.fit_efficiency_curve(samples, peak_flops=PEAK)
    want = ref_fit.fit_efficiency_curve(samples, peak_flops=PEAK)
    assert (got.log10_flops, got.fraction) == (want.log10_flops,
                                               want.fraction)
    assert all(0.0 < f <= 1.0 for f in got.fraction)
    assert list(got.fraction) == sorted(got.fraction)
    if kind == "above_peak":
        assert got.fraction[-1] == 1.0


def _ab_samples(kind, rng):
    b = np.array([2.5e5, 1e6, 4e6, 1.6e7])
    if kind == "clean":
        t = 3e-5 + b / 2e9 * rng.uniform(0.98, 1.02, b.size)
    elif kind == "negative_intercept":   # alpha clamped, slope refit
        t = b / 1e9 * np.array([0.5, 0.9, 1.0, 1.01])
    else:                                # latency-dominated: slope <= 0
        t = np.array([2e-3, 1.9e-3, 1.8e-3, 1.7e-3])
    return [(float(x), float(y)) for x, y in zip(b, t)]


@pytest.mark.parametrize("kind", ["clean", "negative_intercept",
                                  "latency_dominated"])
def test_alpha_beta_matches_reference(kind):
    samples = _ab_samples(kind, np.random.default_rng(3))
    got = fit.fit_alpha_beta(samples)
    assert got == ref_fit.fit_alpha_beta(samples)
    assert got[0] >= 0.0 and got[1] > 0.0
    if kind == "negative_intercept":
        assert got[0] == 0.0


@pytest.mark.parametrize("bad", [[(1e6, 1e-3)], [(1e6, 1e-3), (1e6, 2e-3)],
                                 [(1e6, 1e-3), (1e7, -1.0)]])
def test_alpha_beta_refuses_what_the_reference_refuses(bad):
    for f in (fit.fit_alpha_beta, ref_fit.fit_alpha_beta):
        with pytest.raises(ValueError):
            f(bad)


@pytest.mark.parametrize("plain,remat", [(1.0, 1.276), (2.0, 1.5),
                                         (1.0, 2.8), (3e-3, 4e-3)])
def test_remat_factor_matches_reference(plain, remat):
    got = fit.fit_remat_factor(plain, remat)
    assert got == ref_fit.fit_remat_factor(plain, remat)
    assert 1.0 <= got <= 2.0


def test_remat_factor_refuses_non_positive_times():
    for f in (fit.fit_remat_factor, ref_fit.fit_remat_factor):
        with pytest.raises(ValueError):
            f(0.0, 1.0)


def test_link_fit_matches_reference_and_skips_span_one_levels():
    rng = np.random.default_rng(11)
    sweeps = {"data": _ab_samples("clean", rng),
              "pod": [(1e6, 2e-3), (1e6, 2.1e-3)],   # one distinct size
              "model": []}                            # span 1
    got = fit.fit_link_calibrations(sweeps)
    want = ref_fit.fit_link_calibrations(sweeps)
    assert [(ln.level, ln.alpha, ln.bandwidth) for ln in got] == \
        [(ln.level, ln.alpha, ln.bandwidth) for ln in want]
    assert [ln.level for ln in got] == ["data"]


# --- store ------------------------------------------------------------------

@pytest.mark.parametrize("name", DEVICE_PRESETS)
def test_catalog_default_matches_reference(name):
    assert store.catalog_default(name).to_dict() == \
        ref_store.catalog_default(name).to_dict()
    assert store.resolve(name).to_dict() == ref_store.resolve(
        name).to_dict()


def test_store_behaves_as_reference(tmp_path):
    prof = CalibrationProfile(device="h100-sxm",
                              efficiency=EfficiencyCurve((6.0, 9.0),
                                                         (0.1, 0.6)),
                              remat_factor=1.2, source="fitted")
    path = tmp_path / "p.json"
    prof.save(path)
    seen = []
    for st in (store, ref_store):
        st.clear()
        try:
            before = st.resolve("h100-sxm").to_dict()
            loaded = st.load_and_register(path)
            seen.append((before, st.registered("h100-sxm").to_dict(),
                         st.registered("tpu-v4"), st.registered_names(),
                         st.resolve("h100-sxm").to_dict(),
                         loaded.to_dict()))
            st.register(dataclasses.replace(loaded, device="other"))
            assert st.registered_names() == ("h100-sxm", "other")
        finally:
            st.clear()
        assert st.registered_names() == ()
        with pytest.raises(KeyError):
            st.catalog_default("not-a-device")
    assert seen[0] == seen[1]
    assert seen[0][1] == prof.to_dict()


# --- the committed h100-sxm profile -----------------------------------------

def test_committed_profile_loads_in_both_packages():
    got = CalibrationProfile.load(PROFILE)
    want = RefProfile.load(PROFILE)
    assert got.to_dict() == want.to_dict()
    store.clear()
    try:
        assert store.load_and_register(PROFILE) == got
        assert store.resolve("h100-sxm") == got
    finally:
        store.clear()


def _op_sizes():
    """Every nonzero size `op_peak_compute` is asked for by the plans
    below: an operator's flops for one batch element (tp 1)."""
    train = dataclasses.replace(get_shape("train_4k"), global_batch=8)
    descs = [describe(get_arch("qwen1.5-0.5b"), train)]
    phi = get_arch("phi4-mini-3.8b")
    descs += [describe(phi, ShapeConfig("serve_prefill", 512, 1,
                                        "prefill")),
              describe(phi, ShapeConfig("serve_decode", 1, 1, "decode"))]
    return [op.flops_per_token * d.shape.seq_len for d in descs
            for op in d.operators if op.flops_per_token > 0]


def test_committed_profile_contents():
    prof = CalibrationProfile.load(PROFILE)
    assert prof.device == "h100-sxm"
    assert prof.peak_flops == PEAK
    assert prof.links == ()
    assert "NVIDIA H100" in prof.source and " W" in prof.source
    assert "world 1" in prof.source
    knots = prof.efficiency.log10_flops
    assert knots == pytest.approx([np.log10(2.0 * n ** 3) for n in LADDER])
    sizes = _op_sizes()
    assert 10 ** knots[0] <= min(sizes) and max(sizes) <= 10 ** knots[-1]
    assert 1.0 <= prof.remat_factor <= 2.0


def _plans(profile_port, profile_ref):
    shape = dataclasses.replace(get_shape("train_4k"), global_batch=8)
    rshape = dataclasses.replace(ref_get_shape("train_4k"), global_batch=8)
    mesh, rmesh = (MeshConfig((1, 1), ("data", "model")),
                   RefMeshConfig((1, 1), ("data", "model")))
    out = {}
    for gib in (64.0, 20.0):
        out[f"osdp {gib:g} GiB"] = (
            osdp(get_arch("qwen1.5-0.5b"), shape, mesh,
                 memory_limit_gib=gib, device=DeviceInfo.preset("h100-sxm"),
                 checkpointing="selective", profile=profile_port),
            ref_osdp(ref_get_arch("qwen1.5-0.5b"), rshape, rmesh,
                     memory_limit_gib=gib,
                     device=RefDeviceInfo.preset("h100-sxm"),
                     checkpointing="selective", profile=profile_ref))
    kw = dict(prompt_len=512, decode_len=32, n_devices=1,
              memory_limit_gib=64.0)
    out["serve phi4"] = (
        search_serve(get_arch("phi4-mini-3.8b"),
                     device=DeviceInfo.preset("h100-sxm"),
                     profile=profile_port, **kw),
        ref_search_serve(ref_get_arch("phi4-mini-3.8b"),
                         device=RefDeviceInfo.preset("h100-sxm"),
                         profile=profile_ref, **kw))
    return out


def _decisions(plan):
    return {k: (d.modes, d.remat) for k, d in plan.decisions.items()}


@pytest.mark.parametrize("which", ["osdp 64 GiB", "osdp 20 GiB",
                                   "serve phi4"])
def test_planners_agree_from_the_committed_profile(which):
    got, want = _plans(CalibrationProfile.load(PROFILE),
                       RefProfile.load(PROFILE))[which]
    assert _decisions(got) == _decisions(want)
    assert got.cost.memory == want.cost.memory
    if which.startswith("serve"):
        assert dataclasses.asdict(got.cost) == dataclasses.asdict(want.cost)
        assert got.max_slots_per_device == want.max_slots_per_device
    else:
        assert got.cost.time == want.cost.time


# --- bench on the CPU ---------------------------------------------------------

def test_matmul_sweep_goes_through_split_matmul(monkeypatch):
    calls = []
    inner = ops.split_matmul

    def counted(x, w, **kw):
        calls.append((tuple(x.shape), tuple(w.shape), x.dtype))
        return inner(x, w, **kw)

    monkeypatch.setattr(ops, "split_matmul", counted)
    rows = bench.matmul_sweep((8, 16, 32), repeats=2, device="cpu")
    assert [f for f, _ in rows] == [2.0 * n ** 3 for n in (8, 16, 32)]
    assert all(s > 0 for _, s in rows)
    assert calls == [((n, n), (n, n), torch.bfloat16)
                     for n in (8, 16, 32) for _ in range(3)]
    assert bench.measured_peak_flops(rows) == max(f / s for f, s in rows)


def test_remat_chain_gradients_bit_identical_and_timed():
    ws, x = bench.remat_chain(4, 32, 8, "cpu")
    plain = bench.chain_grads(ws, x, remat=False)
    remat = bench.chain_grads(ws, x, remat=True)
    assert len(plain) == 4 and all(g.dtype == torch.bfloat16 for g in plain)
    assert all(torch.isfinite(g.float()).all() for g in plain)
    assert all(torch.equal(a, b) for a, b in zip(plain, remat))
    t_plain, t_remat = bench.remat_sweep(4, 32, 8, repeats=1, device="cpu")
    assert t_plain > 0 and t_remat > 0


def test_remat_chain_recomputes_every_layer(monkeypatch):
    """The checkpointed chain runs each layer's product twice, the plain
    chain once; dgrad skips the input's gradient."""
    counts = {}
    for name in ("split_matmul", "split_matmul_dgrad", "split_matmul_wgrad"):
        inner = getattr(ops, name)

        def counted(*a, _inner=inner, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _inner(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    ws, x = bench.remat_chain(3, 16, 8, "cpu")
    for remat, fwd in ((False, 3), (True, 6)):
        counts.clear()
        bench.chain_grads(ws, x, remat)
        assert counts == {"split_matmul": fwd, "split_matmul_dgrad": 2,
                          "split_matmul_wgrad": 3}


@pytest.mark.parametrize("n", LADDER)
def test_ladder_plans_take_a_new_design(n):
    plan = plan_launch(n, n, n, 512)
    assert plan.variant == ("stream" if n <= 64 else "wgmma"), plan
    ranges = plan.k_ranges(n)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a < b for a, b in ranges)
    assert not plan.workspace or plan.workspace == (plan.splits, n, n)


@pytest.mark.parametrize("layout", ["nn", "nt", "tn"])
def test_remat_chain_plans_take_a_new_design(layout):
    M, N, K = {"nn": (REMAT_BATCH, REMAT_WIDTH, REMAT_WIDTH),
               "nt": (REMAT_BATCH, REMAT_WIDTH, REMAT_WIDTH),
               "tn": (REMAT_WIDTH, REMAT_WIDTH, REMAT_BATCH)}[layout]
    bk = 512 if layout == "nn" else BWD_KSLICE
    role, design = {"nn": ("fwd", "stream"), "nt": ("dgrad", "persistent"),
                    "tn": ("wgrad", "persistent")}[layout]
    plan = plan_launch(M, N, K, bk, layout=layout, role=role)
    assert plan.variant == design, plan
    assert plan.k_ranges(K)[-1][1] == K


# --- the probe ----------------------------------------------------------------

def test_probe_on_a_host_mesh_moves_nothing():
    mesh = make_host_mesh()
    rec = measure_level_bandwidth(mesh, size_mib=0.25, repeats=1)
    assert rec == {a: {"ways": 1, "bytes_moved": 0, "seconds": 0.0,
                       "achieved_bytes_per_s": None}
                   for a in ("data", "model")}
    assert bench.collective_sweep(mesh, (0.25, 1.0), 1) == {"data": [],
                                                            "model": []}
    assert bandwidth_sweep(mesh, (0.25, 1.0), 1) == {
        a: {"samples": [], "fit": None} for a in ("data", "model")}
    assert mesh.calls == {}


@pytest.mark.parametrize("device", ["a100-80g", "h100-sxm"])
def test_overlap_sanity_matches_reference(device):
    measured = {"data": {"ways": 4, "bytes_moved": 3 << 20, "seconds": 1e-3,
                         "achieved_bytes_per_s": (3 << 20) / 1e-3},
                "model": {"ways": 1, "bytes_moved": 0, "seconds": 0.0,
                          "achieved_bytes_per_s": None}}
    got = overlap_sanity(measured, device, 4)
    assert got == ref_overlap_sanity(measured, device, 4)
    # the one axis that moves bytes pairs with the innermost level
    assert [r["axis"] for r in got] == ["data"]
    assert got[0]["achieved_over_spec"] is not None


# --- the launcher -------------------------------------------------------------

def test_calibrate_cpu_writes_a_profile_the_reference_reads(tmp_path,
                                                             capsys):
    out = tmp_path / "p.json"
    assert launcher.main(["--cpu", "--quick", "--out", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert set(rec) == {"profile", "measured", "elapsed_s", "out"}
    got = CalibrationProfile.load(out)
    assert RefProfile.load(out).to_dict() == got.to_dict() == rec["profile"]
    assert got.links == () and "(cpu, no card, world 1" in got.source
    assert len(rec["measured"]["matmul"]) == 3
    assert len(got.efficiency.log10_flops) == 3


def test_calibrate_two_rank_gloo_fits_the_data_link(tmp_path):
    out = tmp_path / "p.json"
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch", "calibrate", "--cpu",
         "--quick", "--out", str(out)], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    start = run.stdout.index("{")
    rec, end = json.JSONDecoder().raw_decode(run.stdout, start)
    assert "{" not in run.stdout[end:], "only rank 0 prints"
    prof = CalibrationProfile.load(out)
    assert RefProfile.load(out).to_dict() == prof.to_dict() == rec["profile"]
    assert [ln.level for ln in prof.links] == ["data"]
    assert "world 2 gloo" in prof.source
    want = []
    for mib in bench.DEFAULT_BW_MIB[:2]:       # --quick: two sizes
        n = max(1, int(mib * 2**20) // 4)
        n_ax = max(2, (n // 2) * 2)
        want.append(4 * n_ax * (2 - 1) // 2)
    coll = rec["measured"]["collectives"]
    assert [r["bytes"] for r in coll["data"]] == want
    assert coll["model"] == []
    assert all(r["seconds"] > 0 for r in coll["data"])


@pytest.mark.parametrize("argv,rc", [([], 2), (["-h"], 0), (["--help"], 0),
                                     (["bogus"], 2), (["dryrun"], 2),
                                     (["perf-probe"], 2)])
def test_cli_exit_codes(argv, rc):
    assert cli.main(argv) == rc


def test_cli_module_and_calibrate_without_a_card():
    bare = subprocess.run([sys.executable, "-m", "repro_torch"], cwd=ROOT,
                          env=_env(), capture_output=True, text=True,
                          timeout=60)
    assert bare.returncode == 2 and "commands: calibrate" in bare.stdout
    run = subprocess.run([sys.executable, "-m", "repro_torch", "calibrate"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=60)
    assert run.returncode != 0
    assert "no CUDA device: pass device='cpu' (or --cpu)" in run.stderr
