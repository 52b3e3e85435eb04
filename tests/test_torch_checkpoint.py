"""The port's checkpoints (`checkpoint/io.py`, `train`'s checkpoint
arguments, the launcher's flags) against the JAX package's.

- One on-disk format: a step the JAX package writes restores in the
  port, and one the port writes restores in the JAX package, bit for
  bit (bf16 parameters, fp32 master, m and v, the step), with the same
  leaf paths and file names.
- Both packages refuse a truncated, a corrupt and a missing leaf
  (`CheckpointCorruptError`), whoever wrote the step; the port also
  refuses a leaf absent from the manifest or of another shape.
- The write protocol: a save killed by `crash_after_leaves` leaves only
  `.tmp` debris that `latest_step` skips and the next save clears;
  `prune` keeps the newest N.
- `train`: `resume` makes `n_steps` the total target; a run cut after
  2 steps and resumed to 4 gives the uninterrupted run's losses bit for
  bit; the JAX package trains 2 steps and saves, the port restores and
  trains 2 more, and its losses match the JAX package's 4-step run;
  a corrupt latest step stops `train` instead of restoring garbage.
- The launcher's `--ckpt-dir`, `--ckpt-every`, `--keep-last` and
  `--resume` at `--reduced` on the CPU.

Every tensor is small: reduced qwen1.5-0.5b (2 layers, d 256, vocab
512), seq 64 and batch 4 (the launcher: seq 128, batch 4).  No test
builds or loads the CUDA library.

Tolerances: restores are bitwise.  Port steps after a JAX checkpoint
against the JAX package's own steps, bf16 weights: losses within 5e-3
relative, as tests/test_torch_train.py (the frameworks round
activations and gradients at different places; measured below 1e-4).
"""
import dataclasses
import os
import shutil

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
from repro.data.synthetic import Dataset as JDataset
from repro.models.registry import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_state as jinit_state
from repro.train.loop import make_train_step as jmake_train_step
from repro.train.loop import train as jtrain
from repro_torch.checkpoint import io as tio
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import Dataset as TDataset
from repro_torch.launch import train as tlaunch
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import init_state
from repro_torch.resilience.faults import (CheckpointCrash, DeviceGroupLoss,
                                           DeviceLost, FaultSchedule)
from repro_torch.train.loop import make_train_step
from repro_torch.train.loop import train as ttrain

QUIET = dict(log_every=0)


def _runs(seq=64, batch=4):
    out = []
    for Run, Mesh, OSDP, get_arch, get_shape, reduced in (
            (JRun, JMesh, JOSDP, jget_arch, jget_shape, jreduced),
            (TRun, TMesh, TOSDP, tget_arch, tget_shape, treduced)):
        shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                    global_batch=batch)
        out.append(Run(model=reduced(get_arch("qwen1.5-0.5b")), shape=shape,
                       mesh=Mesh((1, 1), ("data", "model")),
                       osdp=OSDP(enabled=False, checkpointing=False)))
    return out


@pytest.fixture(scope="module")
def builts():
    jr, tr = _runs()
    return jbuild(jr), tbuild(tr)


def _bits(a) -> np.ndarray:
    """The stored bits of a JAX array or a tensor (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(jtree, ttree, what):
    jp, js = jtree
    tp, ts = ttree
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert _bits(tp[k]).dtype == _bits(jp[k]).dtype, (what, k)
        assert np.array_equal(_bits(tp[k]), _bits(jp[k])), (what, k)
        for name in ("master", "m", "v"):
            assert np.array_equal(_bits(getattr(ts, name)[k]),
                                  _bits(getattr(js, name)[k])), (what, name, k)
    assert isinstance(ts.step, int) and ts.step == int(js.step), what


def _jax_state_after_one_step(jb):
    step, _ = jmake_train_step(jb, JAdamWConfig(lr=1e-3), donate=False,
                               warmup=2, total_steps=10)
    jp = jb.init(jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in
             JDataset(jb.run.model, jb.run.shape, seed=0).global_batch(
                 0).items()}
    jp, jst, _ = step(jp, jinit_state(jp), batch)
    return jp, jst


def _port_like(tb):
    params = tb.init(1, "cpu")
    return params, init_state(params)


# --- one on-disk format ----------------------------------------------------------

def test_jax_checkpoint_restores_in_the_port(builts, tmp_path):
    jb, tb = builts
    jtree = _jax_state_after_one_step(jb)
    jio.save(str(tmp_path), 1, jtree)
    ttree, step = tio.restore(str(tmp_path), _port_like(tb))
    assert step == 1
    _same(jtree, ttree, "jax -> port")
    assert ttree[0]["embed/tok"].dtype == torch.bfloat16
    assert tio.verify(str(tmp_path)) == jio.verify(str(tmp_path))


def test_port_checkpoint_restores_in_jax(builts, tmp_path):
    jb, tb = builts
    jp0 = jb.init(jax.random.PRNGKey(0))
    params = params_from_jax({k: np.asarray(v) for k, v in jp0.items()},
                             device="cpu")
    step_fn, _ = make_train_step(tb, warmup=2, total_steps=10)
    batch = {k: torch.from_numpy(v) for k, v in TDataset(
        tb.run.model, tb.run.shape, seed=0).global_batch(0).items()}
    params, st, _ = step_fn(params, init_state(params), batch)
    tio.save(str(tmp_path), 1, (params, st))
    manifest = jio.verify(str(tmp_path))
    assert manifest == 1 + 4 * len(params)      # params, step, master, m, v
    names = set(os.listdir(tmp_path / "step_00000001"))
    assert {"__0__embed__tok.npy", "__1__0.npy", "__1__1__embed__tok.npy",
            "__1__3__layers__ffn__w2.npy", "manifest.json"} <= names
    jtree, step = jio.restore(str(tmp_path), (jp0, jinit_state(jp0)))
    assert step == 1
    assert jtree[1].step.dtype == jnp.int32 and jtree[1].step.shape == ()
    _same(jtree, (params, st), "port -> jax")


# --- refusals --------------------------------------------------------------------

def _damage(path, kind):
    if kind == "truncated":
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])
    elif kind == "corrupt":
        data = bytearray(path.read_bytes())
        data[-3] ^= 0xFF
        path.write_bytes(bytes(data))
    else:
        path.unlink()


@pytest.mark.parametrize("kind", ["truncated", "corrupt", "missing"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_packages_refuse_a_damaged_leaf(builts, tmp_path, writer, kind):
    jb, tb = builts
    jtree = _jax_state_after_one_step(jb)
    ttree = _port_like(tb)
    if writer == "jax":
        jio.save(str(tmp_path), 1, jtree)
    else:
        tio.save(str(tmp_path), 1, ttree)
    _damage(tmp_path / "step_00000001" / "__1__2__embed__tok.npy", kind)
    for verify, restore, like, err in (
            (jio.verify, jio.restore, jtree, jio.CheckpointCorruptError),
            (tio.verify, tio.restore, _port_like(tb),
             tio.CheckpointCorruptError)):
        with pytest.raises(err, match="/1/2/embed/tok"):
            verify(str(tmp_path))
        with pytest.raises(err, match="/1/2/embed/tok"):
            restore(str(tmp_path), like)


def test_port_refuses_absent_and_misshapen_leaves(builts, tmp_path):
    _, tb = builts
    params, st = _port_like(tb)
    tio.save(str(tmp_path), 3, (params, st))
    extra = dict(params, **{"layers/extra": torch.zeros(2)})
    with pytest.raises(tio.CheckpointCorruptError, match="absent"):
        tio.restore(str(tmp_path), (extra, init_state(extra)))
    bad = dict(params, **{"final_norm/scale": torch.zeros(7)})
    with pytest.raises(tio.CheckpointCorruptError, match="shape"):
        tio.restore(str(tmp_path), (bad, init_state(bad)))
    with pytest.raises(FileNotFoundError):
        tio.restore(str(tmp_path / "none"), (params, st))


# --- the write protocol ----------------------------------------------------------

def test_crash_mid_save_leaves_only_debris(tmp_path):
    tree = ({"a": torch.ones(3), "b": torch.zeros(2, 2).bfloat16()},
            {"c": torch.arange(4.0)})
    d = str(tmp_path)
    tio.save(d, 1, tree)
    with pytest.raises(tio.CheckpointCrashError) as e:
        tio.save(d, 2, tree, crash_after_leaves=2)
    assert e.value.step == 2
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002.tmp"]
    assert len(os.listdir(tmp_path / "step_00000002.tmp")) == 2
    assert tio.completed_steps(d) == [1] and tio.latest_step(d) == 1
    assert jio.latest_step(d) == 1
    got, step = tio.restore(d, tree)
    assert step == 1 and torch.equal(got[0]["b"], tree[0]["b"])
    tio.save(d, 2, tree)                       # clears the debris
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002"]


def test_prune_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    tree = {"w": torch.ones(2)}
    for s in range(1, 6):
        tio.save(d, s, tree)
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert tio.prune(d, 2) == [1, 2, 3]
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]
    tio.save(d, 6, tree, keep_last=1)
    assert tio.completed_steps(d) == [6]
    assert tio.latest_step(str(tmp_path / "nothing")) is None


# --- train ------------------------------------------------------------------------

def test_resume_targets_the_total_and_equals_an_uninterrupted_run(
        builts, tmp_path):
    _, tb = builts
    d = str(tmp_path)
    full = ttrain(tb, 4, seed=0, device="cpu", **QUIET)
    first = ttrain(tb, 2, seed=0, device="cpu", ckpt_dir=d, ckpt_every=1,
                   **QUIET)
    assert tio.completed_steps(d) == [1, 2] and first.start_step == 0
    rest = ttrain(tb, 4, seed=0, device="cpu", ckpt_dir=d, resume=True,
                  keep_last=2, **QUIET)
    assert rest.start_step == 2 and rest.steps == 2
    assert first.losses + rest.losses == full.losses      # bit for bit
    assert tio.completed_steps(d) == [2, 4]
    done = ttrain(tb, 3, seed=0, device="cpu", ckpt_dir=d, resume=True,
                  **QUIET)
    assert (done.steps, done.losses, done.start_step) == (0, [], 4)
    more = ttrain(tb, 1, seed=0, device="cpu", ckpt_dir=d, **QUIET)
    assert (more.start_step, more.steps) == (4, 1)       # n_steps more
    assert tio.latest_step(d) == 5


def test_train_faults(builts, tmp_path):
    """A device loss raises at its step with progress since the last
    checkpoint lost; a checkpoint crash leaves the step unwritten."""
    _, tb = builts
    d = str(tmp_path)
    with pytest.raises(DeviceLost):
        ttrain(tb, 3, device="cpu", ckpt_dir=d, ckpt_every=1,
               faults=FaultSchedule(device_losses=(DeviceGroupLoss(1),)),
               **QUIET)
    assert tio.completed_steps(d) == [1]
    crash = CheckpointCrash(at_step=2, after_leaves=1)
    with pytest.raises(tio.CheckpointCrashError):
        ttrain(tb, 3, device="cpu", ckpt_dir=d, ckpt_every=1, resume=True,
               faults=FaultSchedule(ckpt_crashes=(crash,)), **QUIET)
    assert tio.completed_steps(d) == [1]
    assert os.path.isdir(tmp_path / "step_00000002.tmp")


def test_jax_two_steps_then_port_two_more(builts, tmp_path):
    """The JAX package's `train` runs 4 steps, saving every 2; from its
    step-2 checkpoint the port's `train(resume=True)` runs steps 2 and
    3, whose losses match the JAX package's own."""
    jb, tb = builts
    d = str(tmp_path)
    want = jtrain(jb, 4, seed=0, ckpt_dir=d, ckpt_every=2, log_every=0,
                  print_fn=lambda *a: None)
    shutil.rmtree(tmp_path / "step_00000004")
    res = ttrain(tb, 4, seed=0, device="cpu", ckpt_dir=d, resume=True,
                 print_fn=lambda *a: None, **QUIET)
    assert res.start_step == 2 and res.steps == 2
    np.testing.assert_allclose(res.losses, want.losses[2:], rtol=5e-3)


def test_train_refuses_a_corrupt_latest_step(builts, tmp_path):
    _, tb = builts
    ttrain(tb, 1, device="cpu", ckpt_dir=str(tmp_path), **QUIET)
    _damage(tmp_path / "step_00000001" / "__1__1__final_norm__scale.npy",
            "corrupt")
    with pytest.raises(tio.CheckpointCorruptError, match="CRC32"):
        ttrain(tb, 2, device="cpu", ckpt_dir=str(tmp_path), resume=True,
               **QUIET)


# --- the launcher ------------------------------------------------------------------

def test_launcher_checkpoints_and_resumes(tmp_path, capsys):
    base = ["--arch", "qwen1.5-0.5b", "--reduced", "--cpu",
            "--ckpt-dir", str(tmp_path)]
    assert tlaunch.main(base + ["--steps", "2", "--ckpt-every", "1"]) == 0
    assert "done: 2 steps" in capsys.readouterr().out
    assert tio.completed_steps(str(tmp_path)) == [1, 2]
    assert tlaunch.main(base + ["--steps", "3", "--resume",
                                "--keep-last", "1"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint at step 2" in out
    assert "done: 1 steps" in out
    assert tio.completed_steps(str(tmp_path)) == [3]
    assert tlaunch.main(base + ["--steps", "3", "--resume"]) == 0
    assert "nothing to train: checkpoint already at step 3 >= target 3" \
        in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--cpu",
                      "--resume"])
    assert "--resume requires --ckpt-dir" in capsys.readouterr().err
