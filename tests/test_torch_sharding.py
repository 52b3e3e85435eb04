"""Placements of the sharded slice, without a process group, and the
train launcher under torchrun on the CPU.

- `data_axis_names`, `_zdp_axes_names` and `segment_placement` against
  the JAX package's `data_axis_names`, `_zdp_axes_names` and
  `segment_sharding` on an abstract mesh of the same data extent, for
  every leaf of reduced qwen1.5-0.5b under a ZDP, a DP and a mixed plan,
  at 2 ranks and at 3 (where the divisibility guard keeps every ZDP
  leaf whole: each is counted in `ParamSet.guarded`);
- `data_sharding` / `replicated` / `input_shardings`: rank r's rows, and
  the refusals;
- `build_param_set` on a mesh: every rank's shards put together are the
  world-1 draws, bit for bit;
- `DataMesh.gather` / `reduce_scatter` at world 1 without a group: the
  identity on both layouts (row and column shards), counted;
- `python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  repro_torch.launch.train --reduced --cpu --force-mode ZDP`: the plan
  for W = 2, the loss lines, and only rank 0 prints.

Rank-r views of a W-rank mesh are `DataMesh(None, r, W, None)`: no
collective is called on them.  Everything is bitwise but the launcher's
losses, which are only checked to be finite and printed once.
"""
import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.core.cost_model import Decision as JDecision
from repro.models.transformer import build_specs as jbuild_specs
from repro.sharding.specs import _zdp_axes_names as jzdp_axes
from repro.sharding.specs import data_axis_names as jdata_axes
from repro.sharding.specs import layout_for as jlayout_for
from repro.sharding.specs import seg_shape as jseg_shape
from repro.sharding.specs import segment_sharding as jsegment_sharding
from repro_torch.configs import (MeshConfig, OSDPConfig, RunConfig, get_arch,
                                 get_shape, reduced)
from repro_torch.core.cost_model import Decision
from repro_torch.core.plan import batch_axes, data_sharding, replicated
from repro_torch.launch.mesh import DataMesh, make_host_mesh
from repro_torch.models.registry import (build_model, input_shardings,
                                         train_inputs)
from repro_torch.models.transformer import build_specs
from repro_torch.sharding.specs import (_zdp_axes_names, build_param_set,
                                        data_axis_names, plan_layouts,
                                        segment_placement, seg_shape)

ROOT = Path(__file__).resolve().parents[1]
OPS = ("embed.tok", "layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
       "layers.ffn_w2")
PLANS = {"zdp": ("ZDP",), "dp": ("DP",), "mixed": ("DP", "ZDP", "DP", "ZDP")}


def _mesh(world, rank=0):
    return DataMesh(None, rank, world, None)


@pytest.mark.parametrize("mode", ["DP", "ZDP", "ZDP_POD", "ZDP@1"])
def test_zdp_axes_match_jax(mode):
    """On a one-axis data mesh every ZDP mode spreads over the data axis,
    as the JAX package resolves it."""
    jm = AbstractMesh((2, 1), ("data", "model"))
    assert data_axis_names(_mesh(2)) == jdata_axes(jm) == ("data",)
    assert batch_axes(_mesh(2)) == ("data",)
    assert _zdp_axes_names(mode, _mesh(2)) == jzdp_axes(mode, jm)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("plan", list(PLANS))
def test_segment_placement_matches_jax(plan, world):
    """Every leaf's shard dimension is the JAX package's data-axis entry of
    `segment_sharding` (its `model` entry aside, TP being 1 here); a ZDP
    dimension the ranks do not divide stays whole (the guard) and is
    counted."""
    cfg, jcfg = reduced(get_arch("qwen1.5-0.5b")), \
        jreduced(jget_arch("qwen1.5-0.5b"))
    modes = PLANS[plan]
    tdec = {op: Decision(op, modes) for op in OPS}
    jdec = {op: JDecision(op, modes) for op in OPS}
    jm = AbstractMesh((world, 1), ("data", "model"))
    pset = plan_layouts(build_specs(cfg, 1), tdec, _mesh(world))
    want_guarded = []
    for jspec in jbuild_specs(jcfg, 1):
        for seg in jlayout_for(jspec, jdec.get(jspec.op)).segments:
            leaf = jspec.path + seg.key
            parts = tuple(jsegment_sharding(jspec, seg,
                                            jseg_shape(jspec, seg),
                                            jm).spec)
            want = next((i for i, p in enumerate(parts) if p == "data"),
                        None)
            assert pset.placements[leaf] == want, leaf
            if want is None and seg.mode != "DP" and \
                    jspec.zdp_axis is not None:
                want_guarded.append(leaf)
    assert sorted(pset.guarded) == sorted(want_guarded)
    if world == 3 and plan != "dp":
        assert pset.guarded and not pset.sharded()
    if world == 2 and plan != "dp":
        assert not pset.guarded and pset.sharded()


def test_segment_placement_guard_on_one_spec():
    spec = build_specs(reduced(get_arch("qwen1.5-0.5b")), 1)[0]
    seg = plan_layouts([spec], {spec.op: Decision(spec.op, ("ZDP",))}
                       ).layouts[spec.path].segments[0]
    assert spec.path == "embed/tok" and spec.zdp_axis == 1
    d = spec.shape[1]
    assert segment_placement(spec, seg, seg_shape(spec, seg), _mesh(2)) == 1
    odd = next(w for w in range(3, 9) if d % w)
    assert segment_placement(spec, seg, seg_shape(spec, seg),
                             _mesh(odd)) is None
    dp = dataclasses.replace(seg, mode="DP")
    assert segment_placement(spec, dp, seg_shape(spec, dp), _mesh(2)) is None


def test_data_sharding_takes_rank_rows():
    x = torch.arange(4 * 3).reshape(4, 3)
    for r in range(2):
        got = data_sharding(_mesh(2, r)).local(x)
        assert torch.equal(got, x[2 * r:2 * r + 2])
    assert replicated(_mesh(2, 1)).local(x) is x
    assert torch.equal(data_sharding(_mesh(2, 1), 2, 1).local(x[:, :2]),
                       x[:, 1:2])
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        data_sharding(_mesh(3)).local(x)
    with pytest.raises(ValueError, match="batch axis"):
        data_sharding(_mesh(2), 2, 2)


def test_input_shardings_are_rows():
    cfg = reduced(get_arch("qwen1.5-0.5b"))
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=16,
                                global_batch=4)
    run = RunConfig(model=cfg, shape=shape,
                    mesh=MeshConfig((2, 1), ("data", "model")),
                    osdp=OSDPConfig(force_mode="ZDP"))
    inputs = train_inputs(cfg, 4, 16)
    got = input_shardings(run, _mesh(2), inputs)
    assert sorted(got) == ["labels", "tokens"]
    assert all(p.dim == 0 for p in got.values())
    with pytest.raises(NotImplementedError, match="caches"):
        input_shardings(run, _mesh(2), dict(inputs, caches=inputs["tokens"]))


@pytest.mark.parametrize("plan", ["zdp", "mixed"])
def test_rank_shards_put_together_are_the_world1_draws(plan):
    """Each rank draws every full tensor from the one generator and keeps
    its shard, so the shards of all ranks, concatenated along each leaf's
    placement, are the world-1 parameters bit for bit."""
    cfg = reduced(get_arch("qwen1.5-0.5b"))
    specs = build_specs(cfg, 1)
    dec = {op: Decision(op, PLANS[plan]) for op in OPS}
    full, _ = build_param_set(specs, dec, torch.Generator().manual_seed(3),
                              "cpu")
    shards = []
    for r in range(2):
        p, pset = build_param_set(specs, dec,
                                  torch.Generator().manual_seed(3), "cpu",
                                  _mesh(2, r))
        shards.append(p)
    assert pset.sharded()
    for k, v in full.items():
        dim = pset.placements[k]
        got = shards[0][k] if dim is None else torch.cat(
            [s[k] for s in shards], dim)
        if dim is not None:
            assert shards[0][k].shape[dim] * 2 == v.shape[dim]
        assert torch.equal(got, v), k


@pytest.mark.parametrize("dim", [0, 1])
def test_host_mesh_collectives_are_identities(dim):
    mesh = make_host_mesh()
    x = torch.randn(4, 6)
    assert torch.equal(mesh.gather(x, dim, "w"), x)
    assert torch.equal(mesh.reduce_scatter(x, dim, "w"), x)
    got = mesh.all_reduce_mean({"a": x, "b": x[:, :2].contiguous()})
    assert torch.equal(got["a"], x) and torch.equal(got["b"], x[:, :2])
    assert mesh.calls == {("all_gather", "w"): 1, ("reduce_scatter", "w"): 1,
                          ("all_reduce", "dp"): 1}
    assert mesh.nbytes["all_gather", "w"] == x.numel() * 4


def test_sharded_serving_is_refused():
    cfg = reduced(get_arch("qwen1.5-0.5b"))
    run = RunConfig(model=cfg, shape=dataclasses.replace(
        get_shape("train_4k"), seq_len=16, global_batch=2),
        mesh=MeshConfig((1, 1), ("data", "model")),
        osdp=OSDPConfig(force_mode="ZDP"))
    b = build_model(run, SimpleNamespace(decisions={
        op: Decision(op, ("ZDP",)) for op in OPS}), make_host_mesh())
    params = b.init(0, "cpu")
    tokens = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sharded serving"):
        b.model.prefill(params, {"tokens": tokens})
    with pytest.raises(NotImplementedError, match="sharded serving"):
        b.model.decode_step(params, {}, tokens[:, :1], 0)


def test_launcher_under_torchrun_trains_two_ranks():
    """torchrun's two ranks plan for W = 2, shard the ZDP leaves over a
    gloo group and train 2 steps; only rank 0 prints."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "qwen1.5-0.5b", "--reduced", "--cpu", "--steps", "2",
         "--force-mode", "ZDP"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    mesh = [ln for ln in lines if ln.startswith("data mesh:")]
    assert len(mesh) == 1 and "W = 2 (gloo)" in mesh[0], out.stdout
    assert "0 ZDP leaves kept whole" in mesh[0]
    assert sum(ln.startswith("plan[") for ln in lines) == 1
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2, out.stdout
    done = [ln for ln in lines if ln.startswith("done: 2 steps")]
    assert len(done) == 1, out.stdout
    first, last = map(float, re.findall(r"loss (\S+) -> (\S+),",
                                        done[0])[0])
    assert math.isfinite(first) and math.isfinite(last)
