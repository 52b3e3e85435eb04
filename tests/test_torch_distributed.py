"""Sharded OSDP training (`launch/mesh.py`, `sharding/collectives.py`,
the mesh branches of `train/loop.py`, `optim/adamw.py` and
`checkpoint/io.py`) on a 2-rank gloo world, against the JAX package.

One world per module: two child processes (`python -c CHILD`, each
importing only `repro_torch`, one thread, a `file://` store under the
test's temporary directory: no fixed TCP port, as gloo's own links take
ephemeral loopback ports; no process group in the pytest worker) train
every case 3 steps on reduced qwen1.5-0.5b at seq 64 and
global batch 4 in float32, and write `.npz` / `.json` results.  Meanwhile
the parent runs the JAX package's `make_train_step` on one device under
the same plan's segments, the same weights and the full batch, and the
port at world 1 (`make_host_mesh`, no group).  The cases: DP; ZDP at
remat off and on; ZDP at operator split 2 (`chunked_ffn`); the mixed
DP/ZDP plan of tests/test_torch_train.py (`MIXED`: segments alternating
DP and ZDP) at microbatch 2 within each rank's 2 rows; and a selective
plan (every op ZDP at split 2, the checkpoint policy keeping the
attention products and recomputing the rest).

Checked:
- losses, grad norms and the final gathered parameters against the JAX
  package and against the port's world 1;
- `tests/test_distributed.py`'s invariants, which fail here on the
  reference side: DP, ZDP and split-ZDP losses agree at rtol 2e-2, and
  ZDP moves more collective bytes than DP;
- the executed collectives: for every sharded leaf 2 all-gathers and 1
  reduce-scatter a step (+1 gather in a recomputed layer), so the ring
  passes over a leaf's bytes are the cost model's k: ZDP / DP = 1.5 at
  remat off and 2.0 at remat on for the layer ops;
- the bytes each rank holds in parameters and AdamW state: each ZDP
  leaf exactly halved, against the cost model's M_model_i / N_shard;
- checkpoints across world sizes and packages, and a bit-identical
  resume at world 2;
- the refusals: out-of-scope meshes, a batch the world does not divide.

Tolerances, float32 (tests/test_torch_train.py's): losses within 1e-4
relative; grad norms within 1e-5 at step 1 and 1e-2 at every step
(AdamW's first updates move each weight by about lr whatever its
gradient, so entries near 0 whose sign the summation order flips grow
the difference).  Final parameters within 1e-4 of the leaf's norm
(||got - want|| / ||want||; measured at most 5.6e-6 but for the two
exceptions below), with two exceptions measured before the bounds were
set: the key bias `layers/attn/bk` within 1e-3 (its gradient is nearly
zero: a bias shared by all keys shifts a query's scores by one constant,
which softmax cancels, and only RoPE's rotation of it by position
leaves a gradient, whose rounding AdamW's normalised step magnifies;
measured 1.5e-4 to 1.8e-4 against JAX, 4.2e-5 to 1.7e-4 world 2
against world 1); and the mixed plan at microbatch 2 against JAX within
1e-2, the every-step grad-norm bound, since the port differs from JAX
there at world 1 already (the step-3 grad norm by 1.8e-3, as
tests/test_torch_train.py measured; parameters by up to 4.5e-3), while
its world 2 stays within 2.4e-5 of its world 1 (the key bias aside).
That gap is float32 rounding grown by AdamW's normalised step: with
every float32 of both packages lifted to float64 the same plan at
microbatch 2 agrees with JAX to 6.6e-9 of a leaf's norm and its step-3
grad norm to 1.2e-12 (tests/test_torch_train.py::
test_mixed_plan_gap_is_float32_rounding); the bound stays.
Restores are bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import MeshConfig as JMesh
from repro.configs import OSDPConfig as JOSDP
from repro.configs import RunConfig as JRun
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.configs import reduced as jreduced
from repro.core.cost_model import Decision as JDecision
from repro.core.plan import make_plan as jmake_plan
from repro.data.synthetic import Dataset as JDataset
from repro.models.registry import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_state as jinit_state
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.checkpoint import io as tio
from repro_torch.configs import (DeviceInfo, MeshConfig, OSDPConfig,
                                 RunConfig, get_arch, get_shape, reduced)
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import CostEnv, Decision, op_cost
from repro_torch.core.descriptions import describe
from repro_torch.core.plan import make_plan
from repro_torch.launch.mesh import (DataMesh, init_data_mesh,
                                     make_host_mesh, make_mesh_from_config)
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, init_state
from repro_torch.train.loop import train

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
STEPS = 3
SEQ, BATCH = 64, 4
LR = 1e-3
SCHED = dict(warmup=2, total_steps=10)
LOSS_RTOL = 1e-4                 # tests/test_torch_train.py, float32
GNORM_RTOL = (1e-5, 1e-2)        # (step 1, every step)
PARAM_RTOL = 1e-4                # of the leaf's norm
NEAR_ZERO_GRAD = {"layers/attn/bk": 1e-3}   # see the module note
MIXED_VS_JAX_RTOL = 1e-2
JOIN_TIMEOUT_S = 600           # a guard against a hung world only
MIXED_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
             "layers.ffn_w2", "head.out")
MIXED = ("DP", "ZDP", "DP", "ZDP")
# name -> (force mode, "mixed" or "selective"; remat; operator split;
# microbatch)
CASES = {"dp": ("DP", False, 1, 0),
         "zdp": ("ZDP", False, 1, 0),
         "zdp_remat": ("ZDP", True, 1, 0),
         "zdp_split2": ("ZDP", False, 2, 0),
         "mixed_mb2": ("mixed", False, 1, 2),
         "selective": ("selective", True, 2, 0)}
LAYER_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
             "layers.ffn_w2")


def _decisions(Decision_, mode, split):
    """A hand-made plan: "mixed" is tests/test_torch_train.py's `MIXED`;
    "selective" every op ZDP, split in `split`, the attention products
    kept and the rest recomputed (a selective checkpoint policy)."""
    if mode == "mixed":
        return {op: Decision_(op, MIXED) for op in MIXED_OPS}
    return {op: Decision_(op, ("ZDP",) * (split if op in LAYER_OPS else 1),
                          (op in LAYER_OPS[2:],)
                          * (split if op in LAYER_OPS else 1))
            for op in ("embed.tok",) + LAYER_OPS}


def _runs(case, world=1):
    """(the JAX package's run config on one device, the port's on a
    `world`-rank data mesh, the port's plan) of a case."""
    mode, remat, split, micro = case
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=SEQ,
                                global_batch=BATCH)
    out = []
    for Run, Mesh, OSDP, ga, gs, red, w in (
            (JRun, JMesh, JOSDP, jget_arch, jget_shape, jreduced, 1),
            (RunConfig, MeshConfig, OSDPConfig, get_arch, get_shape, reduced,
             world)):
        osdp = (OSDP(enabled=False, checkpointing=remat) if mode == "mixed"
                else OSDP(enabled=False, checkpointing="selective")
                if mode == "selective"
                else OSDP(force_mode=mode, operator_splitting=split > 1,
                          default_slice_granularity=max(split, 1),
                          checkpointing=remat))
        out.append(Run(model=red(ga("qwen1.5-0.5b")),
                       shape=dataclasses.replace(gs("train_4k"), seq_len=SEQ,
                                                 global_batch=BATCH),
                       mesh=Mesh((w, 1), ("data", "model")), osdp=osdp,
                       microbatch=micro))
    jr, tr = out
    if mode in ("mixed", "selective"):
        jplan = SimpleNamespace(decisions=_decisions(JDecision, mode, split))
        tplan = SimpleNamespace(decisions=_decisions(Decision, mode, split))
    else:
        jplan, tplan = jmake_plan(jr), make_plan(tr)
    assert {k: d.modes for k, d in jplan.decisions.items()} == \
        {k: d.modes for k, d in tplan.decisions.items()}
    assert shape == tr.shape
    return jr, jplan, tr, tplan


# --- the child world ---------------------------------------------------------

CHILD = textwrap.dedent("""
    import dataclasses, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    spec = json.load(open(os.path.join(work, "spec.json")))
    from types import SimpleNamespace
    from repro_torch.configs import (MeshConfig, OSDPConfig, RunConfig,
                                     get_arch, get_shape, reduced)
    from repro_torch.core.cost_model import Decision
    from repro_torch.core.plan import make_plan
    from repro_torch.launch.mesh import init_data_mesh, make_mesh_from_config
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import make_train_step, restore_or_init, train
    W = spec["world"]
    init_data_mesh("gloo", "file://" + os.path.join(work, "store"), W, rank,
                   timeout_s=120)
    mcfg = MeshConfig((W, 1), ("data", "model"))
    mesh = make_mesh_from_config(mcfg)

    def built_for(name):
        mode, remat, split, micro = spec["cases"][name]
        osdp = (OSDPConfig(enabled=False, checkpointing=remat)
                if mode == "mixed" else
                OSDPConfig(enabled=False, checkpointing="selective")
                if mode == "selective" else
                OSDPConfig(force_mode=mode, operator_splitting=split > 1,
                           default_slice_granularity=max(split, 1),
                           checkpointing=remat))
        run = RunConfig(model=reduced(get_arch("qwen1.5-0.5b")),
                        shape=dataclasses.replace(
                            get_shape("train_4k"), seq_len=spec["seq"],
                            global_batch=spec["batch"]),
                        mesh=mcfg, osdp=osdp, microbatch=micro)
        plan = make_plan(run)
        if name in spec["plans"]:
            plan = SimpleNamespace(decisions={
                op: Decision(op, tuple(m), None if r is None else tuple(r))
                for op, (m, r) in spec["plans"][name].items()})
        return build_model(run, plan, mesh)

    def full(built, tree):
        # the full leaves of a dict of the rank's shards
        return {k: (mesh.gather(v, built.pset.placements[k], "test")
                    if built.pset.placements[k] is not None else v
                    ).detach().numpy()
                for k, v in tree.items()}

    opt = AdamWConfig(lr=spec["lr"])
    report = {"held": {}, "calls": {}}
    for name in spec["cases"]:
        built = built_for(name)
        start = {k: torch.from_numpy(v) for k, v in
                 np.load(os.path.join(work, "init_" + name + ".npz")).items()}
        mesh.reset_counts()
        res = train(built, spec["steps"], opt_cfg=opt, device="cpu",
                    params=start, log_every=0, **spec["sched"])
        report["calls"][name] = [[k, c, mesh.nbytes[k]]
                                 for k, c in mesh.calls.items()]
        final = full(built, res.params)
        _, init_fn = make_train_step(built, opt)
        p, st = init_fn(0, "cpu")
        report["held"][name] = {k: [p[k].numel(), st.master[k].numel(),
                                    st.m[k].numel(), st.v[k].numel()]
                                for k in p}
        report["guarded_" + name] = list(built.pset.guarded)
        if rank == 0:
            np.savez(os.path.join(work, "w2_" + name + ".npz"),
                     losses=np.array(res.losses),
                     grad_norms=np.array(res.grad_norms), **final)
    # checkpoints: 2 steps saving each step, then a fresh resume to 3
    built = built_for("zdp")
    start = {k: torch.from_numpy(v) for k, v in
             np.load(os.path.join(work, "init_zdp.npz")).items()}
    ck = os.path.join(work, "ckpt_w2")
    train(built, 2, opt_cfg=opt, device="cpu", params=start, log_every=0,
          ckpt_dir=ck, ckpt_every=1, **spec["sched"])
    res = train(built, spec["steps"], opt_cfg=opt, device="cpu",
                params=start, log_every=0, ckpt_dir=ck, ckpt_every=1,
                resume=True, **spec["sched"])
    report["resumed_losses"] = res.losses
    # a world-1 checkpoint written by the JAX package, restored at world 2
    _, p, st, step = restore_or_init(built, os.path.join(work, "ckpt_w1"),
                                     device="cpu", print_fn=lambda *a: None)
    restored = {**{"p/" + k: v for k, v in full(built, p).items()},
                **{"m/" + k: v for k, v in full(built, st.m).items()}}
    if rank == 0:
        np.savez(os.path.join(work, "w2_restored_w1.npz"), step=step,
                 **restored)
    # this process's own peak (ru_maxrss keeps the parent's from the fork)
    hwm = [l for l in open("/proc/self/status") if l.startswith("VmHWM")]
    report["peak_mib"] = int(hwm[0].split()[1]) / 1024
    json.dump(report, open(os.path.join(work, f"rank{rank}.json"), "w"))
    mesh.destroy()
""")


def _spawn(work: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        err = open(work / f"rank{r}.err", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", CHILD, str(r), str(work)], env=env,
            stdout=subprocess.DEVNULL, stderr=err), err))
    return procs


def _join(procs, work: Path) -> None:
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    bad = [(r, p.returncode) for r, (p, _) in enumerate(procs)
           if p.returncode != 0]
    if bad:
        logs = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                         + (work / f"rank{r}.err").read_text()[-4000:]
                         for r, rc in bad)
        raise AssertionError(f"world of {WORLD} failed:\n{logs}")


def _jax_steps(jr, jplan, jp):
    jb = jbuild(jr, jplan)
    step, _ = jmake_train_step(jb, JAdamWConfig(lr=LR), donate=False,
                               **SCHED)
    st = jinit_state(jp)
    ds = JDataset(jr.model, jr.shape, seed=0)
    losses, norms = [], []
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in ds.global_batch(s).items()}
        jp, st, m = step(jp, st, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, grad_norms=norms,
                params={k: np.asarray(v) for k, v in jp.items()})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything the module checks: the children's results (rank 0's
    npz, both ranks' json), the JAX package's steps and the port's world
    1, each case from the JAX package's initial float32 weights."""
    work = tmp_path_factory.mktemp("world")
    inits, plans = {}, {}
    for name, case in CASES.items():
        jr, jplan, _, _ = _runs(case)
        jp = {k: v.astype(jnp.float32) for k, v in
              jbuild(jr, jplan).init(jax.random.PRNGKey(0)).items()}
        np.savez(work / f"init_{name}.npz",
                 **{k: np.asarray(v) for k, v in jp.items()})
        inits[name], plans[name] = jp, (jr, jplan)
    jp = inits["zdp"]
    jio.save(str(work / "ckpt_w1"), 0, (jp, jinit_state(jp)))
    hand = {name: {op: (d.modes, d.remat) for op, d in
                   _runs(case)[3].decisions.items()}
            for name, case in CASES.items()
            if case[0] in ("mixed", "selective")}
    (work / "spec.json").write_text(json.dumps(dict(
        world=WORLD, cases=CASES, plans=hand, seq=SEQ, batch=BATCH,
        steps=STEPS, lr=LR, sched=SCHED)))
    procs = _spawn(work)
    try:
        ref = {name: _jax_steps(*plans[name], inits[name]) for name in CASES}
        w1 = {}
        for name, case in CASES.items():
            _, _, tr, tplan = _runs(case)
            mesh = make_host_mesh()
            res = train(build_model(tr, tplan, mesh), STEPS,
                        opt_cfg=AdamWConfig(lr=LR), device="cpu",
                        params=params_from_jax(
                            {k: np.asarray(v) for k, v in inits[name].items()},
                            device="cpu"), log_every=0, **SCHED)
            w1[name] = dict(losses=res.losses, grad_norms=res.grad_norms,
                            params={k: v.detach().numpy()
                                    for k, v in res.params.items()},
                            calls=dict(mesh.calls))
    finally:
        _join(procs, work)
    w2 = {name: dict(np.load(work / f"w2_{name}.npz")) for name in CASES}
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return SimpleNamespace(work=work, ref=ref, w1=w1, w2=w2, ranks=ranks,
                           inits=inits)


def _close(got, want, what, param_rtol=PARAM_RTOL):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL,
                               err_msg=what)
    first, every = GNORM_RTOL
    np.testing.assert_allclose(got["grad_norms"][0], want["grad_norms"][0],
                               rtol=first, err_msg=what)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=every, err_msg=what)
    for k, w in want["params"].items():
        g = got["params"][k] if "params" in got else got[k]
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= max(param_rtol, NEAR_ZERO_GRAD.get(k, 0.0)), \
            (what, k, rel)


def _vs_jax_rtol(name):
    return MIXED_VS_JAX_RTOL if CASES[name][0] == "mixed" else PARAM_RTOL


@pytest.mark.parametrize("name", list(CASES))
def test_world2_matches_jax_make_train_step(world, name):
    got = dict(world.w2[name])
    got["params"] = {k: v for k, v in got.items()
                     if k not in ("losses", "grad_norms")}
    assert sorted(got["params"]) == sorted(world.ref[name]["params"])
    _close(got, world.ref[name], f"{name}: world 2 vs JAX",
           _vs_jax_rtol(name))


@pytest.mark.parametrize("name", list(CASES))
def test_world2_matches_port_world1(world, name):
    got = dict(world.w2[name])
    _close(got, world.w1[name], f"{name}: world 2 vs world 1")
    _close(world.w1[name], world.ref[name], f"{name}: world 1 vs JAX",
           _vs_jax_rtol(name))


def test_reference_invariants_dp_zdp_split_agree(world):
    """tests/test_distributed.py:84-97 (it fails here on the reference
    side): DP, ZDP and split-ZDP train the same trajectory."""
    l_dp = world.w2["dp"]["losses"]
    for other in ("zdp", "zdp_split2"):
        np.testing.assert_allclose(l_dp, world.w2[other]["losses"],
                                   rtol=2e-2, atol=2e-2)


# --- the collectives against the cost model ---------------------------------

def _passes(calls):
    """{leaf: (gathers, reduce-scatters)} and the bytes of each kind, from
    a mesh's [key, calls, bytes] list."""
    out, nbytes = {}, {}
    for (kind, key), n, b in ((tuple(k), n, b) for k, n, b in calls):
        g, r = out.get(key, (0, 0))
        out[key] = (g + n, r) if kind == "all_gather" else (
            (g, r + n) if kind == "reduce_scatter" else (g, r))
        nbytes[kind, key] = b
    return out, nbytes


@pytest.mark.parametrize("name", ["zdp", "zdp_remat", "zdp_split2",
                                  "mixed_mb2", "selective"])
def test_each_sharded_leaf_gathers_twice_and_scatters_once(world, name):
    """Per step and use: 2 all-gathers and 1 reduce-scatter of every
    sharded leaf, +1 all-gather in a recomputed layer; one all-reduce of
    the DP leaves and one of the norm (with the loss) a step."""
    _, remat, _, micro = CASES[name]
    n = max(1, micro)
    calls = world.ranks[0]["calls"][name]
    per_leaf, _ = _passes(calls)
    layers = reduced(get_arch("qwen1.5-0.5b")).n_layers
    _, _, tr, tplan = _runs(CASES[name], WORLD)
    sharded = build_model(tr, tplan, DataMesh(None, 0, WORLD, None)
                          ).pset.sharded()
    assert sharded and set(k for k in per_leaf if k not in (
        "dp", "grad_norm")) == set(sharded)
    for leaf in sharded:
        uses = STEPS * n * (layers if leaf.startswith("layers/") else 1)
        extra = remat and leaf.startswith("layers/")
        assert per_leaf[leaf] == (uses * (3 if extra else 2), uses), leaf
    ar = {tuple(k)[1]: c for k, c, _ in calls if k[0] == "all_reduce"}
    assert ar == {"dp": STEPS, "grad_norm": STEPS}
    # the same counts at world 1 (the host mesh: no group, same calls)
    assert world.w1[name]["calls"] == {tuple(k): c for k, c, _ in calls}


def _op_of(leaf, specs):
    return next(s.op for s in specs if s.path == leaf.split("@")[0])


def _k_model(op, ckpt: bool, run) -> float:
    """The cost model's ring passes a step for `op` under ZDP: twice its
    ZDP over its DP collective time (`op_cost`; DP all-reduces in 2
    passes) with the latency term zeroed, on the run's flat mesh."""
    env = CostEnv(dataclasses.replace(DeviceInfo(), alpha=0.0), run.mesh,
                  checkpointing=ckpt, train=True)
    t = {m: op_cost(op, Decision(op.name, (m,)), BATCH // WORLD, SEQ,
                    env).comm_time for m in ("DP", "ZDP")}
    return 2 * t["ZDP"] / t["DP"]


def test_ring_passes_are_the_cost_models_k(world):
    """Bytes each sharded leaf moves, in ring passes over its own bytes (a
    gather or a reduce-scatter is one pass, an all-reduce two): 3 a step
    under ZDP, 4 in a recomputed layer, 2 under DP; so ZDP / DP = 1.5 at
    remat off and 2.0 at remat on for the layer ops, against the
    reference's > 1.2.  The cost model's k agrees for every op but the
    embedding under remat: `op_cost` charges every ZDP op a fourth
    gather under checkpointing, which the embedding, outside the
    checkpointed layers, never needs."""
    _, _, tr, tplan = _runs(CASES["zdp"], WORLD)
    b = build_model(tr, tplan, DataMesh(None, 0, WORLD, None))
    full_bytes = {s.path: 4 * int(np.prod(s.shape)) for s in b.specs}
    ops = {op.name: op for op in describe(tr.model, tr.shape).operators}
    dp_bytes = {n: _passes(world.ranks[0]["calls"][n])[1]["all_reduce", "dp"]
                for n in ("dp", "zdp", "zdp_remat")}
    for name, ckpt in (("zdp", False), ("zdp_remat", True)):
        per_leaf, nbytes = _passes(world.ranks[0]["calls"][name])
        moved, own = {}, {}
        for leaf in per_leaf:
            if leaf in ("dp", "grad_norm"):
                continue
            op = _op_of(leaf, b.specs)
            moved[op] = moved.get(op, 0) + nbytes["all_gather", leaf] \
                + nbytes["reduce_scatter", leaf]
            own[op] = own.get(op, 0) + STEPS * full_bytes[leaf]
        # the DP plan all-reduces the same leaves' bytes, 2 passes a step
        assert dp_bytes["dp"] - dp_bytes[name] == sum(own.values())
        layer = sum(moved[o] for o in LAYER_OPS)
        layer_dp = 2 * sum(own[o] for o in LAYER_OPS)
        assert layer / layer_dp == (2.0 if ckpt else 1.5)
        assert moved["embed.tok"] / (2 * own["embed.tok"]) == 1.5
        assert sum(moved.values()) / (2 * sum(own.values())) > 1.2
        for op in moved:
            k_exec = moved[op] / own[op]
            k_model = _k_model(ops[op], ckpt, tr)
            if op == "embed.tok" and ckpt:
                assert (k_exec, k_model) == (3, pytest.approx(4)), op
            else:
                assert k_exec == pytest.approx(k_model), (name, op)


def test_each_rank_holds_half_of_every_zdp_leaf(world):
    """Parameters and AdamW's master, m and v: each ZDP leaf exactly 1/W on
    every rank (no leaf is kept whole by the divisibility guard here),
    every other leaf whole; per op, 16 bytes a held parameter (the cost
    model's STATE_BYTES_PER_PARAM) against its M_model_i / N_shard: equal
    for every op whose leaves all shard, and above it by the QKV biases,
    which OSDP cannot shard (no ZDP axis) but the cost model divides."""
    _, _, tr, tplan = _runs(CASES["zdp"], WORLD)
    b = build_model(tr, tplan, DataMesh(None, 0, WORLD, None))
    numel = {s.path: int(np.prod(s.shape)) for s in b.specs}
    desc = describe(tr.model, tr.shape)
    for rank in world.ranks:
        assert rank["guarded_zdp"] == []
        held = rank["held"]["zdp"]
        per_op = {}
        for leaf, counts in held.items():
            want = numel[leaf] // WORLD if leaf in b.pset.sharded() \
                else numel[leaf]
            assert counts == [want] * 4, leaf
            op = _op_of(leaf, b.specs)
            per_op[op] = per_op.get(op, 0) + 16 * counts[0]
        for op in desc.operators:
            if op.name not in per_op:
                continue
            model = op.state_bytes / (WORLD if op.decidable else 1)
            unsharded = sum(16 * numel[s.path] for s in b.specs
                            if s.op == op.name and s.zdp_axis is None)
            if op.decidable:
                assert per_op[op.name] == model + unsharded / 2, op.name
            else:
                assert per_op[op.name] == model, op.name


# --- checkpoints -------------------------------------------------------------

def test_world2_checkpoint_restores_at_world1_and_in_jax(world):
    """The world-2 run's last step (saved by rank 0 after a resume) reads
    back in the JAX package and in the port at world 1, leaf for leaf,
    and equals the gathered final parameters of the uninterrupted run:
    the resume was bit-identical."""
    ck = str(world.work / "ckpt_w2")
    assert tio.latest_step(ck) == STEPS
    jp = world.inits["zdp"]
    jlike = (jp, jinit_state(jp))
    (jgot, jst), step = jio.restore(ck, jlike)
    assert step == STEPS and int(jst.step) == STEPS
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    (tgot, tst), tstep = tio.restore(ck, (tp, init_state(tp)))
    assert tstep == STEPS and tst.step == STEPS
    w2 = world.w2["zdp"]
    for k in jp:
        assert np.array_equal(np.asarray(jgot[k]), tgot[k].numpy()), k
        assert np.array_equal(tgot[k].numpy(), w2[k]), k
        for name in ("master", "m", "v"):
            assert np.array_equal(np.asarray(getattr(jst, name)[k]),
                                  getattr(tst, name)[k].numpy()), (name, k)
    np.testing.assert_array_equal(world.ranks[0]["resumed_losses"],
                                  w2["losses"][2:])


def test_world1_checkpoint_restores_at_world2(world):
    """A step the JAX package wrote on one device restores on 2 ranks: the
    gathered shards are the stored leaves, bit for bit."""
    got = np.load(world.work / "w2_restored_w1.npz")
    assert int(got["step"]) == 0
    for k, v in world.inits["zdp"].items():
        assert np.array_equal(got["p/" + k], np.asarray(v)), k
        assert np.array_equal(got["m/" + k], np.zeros(v.shape, np.float32))


def test_world_fits_its_memory(world):
    """Each child stays under 600 MiB (its own peak, `VmHWM`): with the
    parent's peak, about 1 GiB run alone, the file stays within 2 GiB."""
    peaks = [r["peak_mib"] for r in world.ranks]
    assert max(peaks) < 600, peaks


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,what", [
    ((2, 2), ("data", "model"), "tensor parallelism"),
    ((2, 1, 2), ("data", "model", "pipe"), "pipe axis"),
    ((2, 2, 1), ("pod", "data", "model"), "more than one data axis"),
])
def test_out_of_scope_meshes_raise(shape, axes, what):
    with pytest.raises(NotImplementedError, match=what):
        make_mesh_from_config(MeshConfig(shape, axes))


def test_backends_refuse_the_other_device():
    """gloo carries CPU tensors and nccl CUDA ones; nccl without a card
    and an unknown backend raise before any group opens."""
    cuda_like = SimpleNamespace(is_cuda=True)
    with pytest.raises(ValueError, match="gloo carries CPU tensors only"):
        DataMesh(None, 0, 2, "gloo")._check(cuda_like)
    with pytest.raises(ValueError, match="nccl carries CUDA tensors only"):
        DataMesh(None, 0, 2, "nccl").gather(torch.zeros(2), 0)
    with pytest.raises(ValueError, match="backend"):
        init_data_mesh("mpi", "file:///nonexistent")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl needs a CUDA device"):
            init_data_mesh("nccl", "file:///nonexistent", 1, 0)
    with pytest.raises(RuntimeError, match="needs an open process group"):
        make_mesh_from_config(MeshConfig((2, 1), ("data", "model")))


def test_a_batch_the_world_does_not_divide_raises():
    _, _, tr, tplan = _runs(CASES["zdp"], 3)
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        build_model(tr, tplan, DataMesh(None, 0, 3, None))
