"""The port's serving engines against the JAX package's, and the CLI.

Schedules (admission and finishing steps, terminal states, step counts)
are host-side bookkeeping and must equal the reference's exactly, fault
injection included.  Tokens are model outputs: each request's tokens
must equal the port model's own greedy decode of that request alone,
and each first token must equal the JAX model's wherever the JAX top-1
logit leads the top-2 by more than the model tolerance (5e-2, see
`test_torch_model.py`) on both sides.
"""
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MeshConfig as JMesh
from repro.configs import OSDPConfig as JOSDP
from repro.configs import RunConfig as JRun
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.configs import reduced as jreduced
from repro.models.registry import build_model as jbuild
from repro.resilience.faults import FaultSchedule as JFaults
from repro.resilience.faults import SlowRequest as JSlow
from repro.resilience.faults import TransientFailures as JTransient
from repro.serving import engine as jeng
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model as tbuild
from repro_torch.resilience.faults import FaultSchedule as TFaults
from repro_torch.resilience.faults import SlowRequest as TSlow
from repro_torch.resilience.faults import TransientFailures as TTransient
from repro_torch.serving import engine as teng

ROOT = Path(__file__).resolve().parent.parent
TOL = 5e-2
ARCH = "phi4-mini-3.8b"


@lru_cache(maxsize=None)
def _pair():
    kw = dict(n_kv_heads=2)
    jr = JRun(model=jreduced(jget_arch(ARCH), **kw),
              shape=jget_shape("decode_32k"),
              mesh=JMesh((1, 1), ("data", "model")),
              osdp=JOSDP(enabled=False))
    tr = TRun(model=treduced(tget_arch(ARCH), **kw),
              shape=tget_shape("decode_32k"),
              mesh=TMesh((1, 1), ("data", "model")),
              osdp=TOSDP(enabled=False))
    jb, tb = jbuild(jr), tbuild(tr)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    return jb, jp, tb, tp


def _requests(mod, cfg, n=5, seed=0, deadline=None):
    rng = np.random.default_rng(seed)
    lens = [9, 16, 12, 9, 16, 12][:n]   # few lengths: few JAX compiles
    news = [4, 7, 2, 6, 3, 5][:n]
    return [mod.Request(i, rng.integers(0, cfg.vocab_size, lens[i])
                        .astype(np.int32), news[i],
                        deadline_steps=deadline) for i in range(n)]


def _schedule(results):
    return sorted((r.rid, r.admitted_at_step, r.finished_at_step, r.status,
                   r.attempts, r.n_generated) for r in results)


def _counters(stats):
    return (stats.prefill_steps, stats.decode_steps, stats.slots,
            stats.useful_tokens, stats.completed, stats.wasted_tokens,
            stats.retries, stats.rejected, stats.invalid, stats.timed_out,
            stats.failed)


def _both(max_slots=2, cache_len=24, jfaults=None, tfaults=None, **kw):
    jb, jp, tb, tp = _pair()
    cfg = tb.model.cfg
    jres, jst = jeng.ContinuousEngine(jb, jp, max_slots, cache_len,
                                      **kw).run(
        _requests(jeng, cfg), faults=jfaults)
    tres, tst = teng.ContinuousEngine(tb, tp, max_slots, cache_len,
                                      **kw).run(
        _requests(teng, cfg), faults=tfaults)
    return jres, jst, tres, tst


@pytest.mark.parametrize("max_slots", [1, 2, 3])
def test_schedule_matches_jax(max_slots):
    jres, jst, tres, tst = _both(max_slots=max_slots)
    assert _schedule(tres) == _schedule(jres)
    assert _counters(tst) == _counters(jst)
    assert all(r.status == teng.OK for r in tres)


def test_fault_schedule_matches_jax():
    """Seeded transient failures and a stalled request play out the
    same way in both engines (the port's copy of `resilience.faults`)."""
    jf = JFaults(seed=5, transient=JTransient(0.4),
                 slow=(JSlow(rid=1, stall_steps=3),))
    tf = TFaults(seed=5, transient=TTransient(0.4),
                 slow=(TSlow(rid=1, stall_steps=3),))
    jres, jst, tres, tst = _both(jfaults=jf, tfaults=tf, max_retries=1)
    assert _schedule(tres) == _schedule(jres)
    assert _counters(tst) == _counters(jst)


def test_tokens_equal_own_greedy_decode():
    """Continuous batching changes the schedule, not the outputs: each
    request's tokens equal the port's static engine on that request
    alone (same cache length)."""
    _, _, tb, tp = _pair()
    cfg = tb.model.cfg
    reqs = _requests(teng, cfg)
    res, _ = teng.ContinuousEngine(tb, tp, max_slots=2, cache_len=24).run(
        reqs)
    static = teng.Engine(tb, tp, cache_len=24)
    for r in res:
        req = reqs[r.rid]
        want = static.generate(req.prompt[None], req.max_new_tokens).tokens
        np.testing.assert_array_equal(r.tokens, want[0])


def test_first_tokens_match_jax_where_decisive():
    jb, jp, tb, tp = _pair()
    cfg = tb.model.cfg
    reqs = _requests(teng, cfg)
    res, _ = teng.ContinuousEngine(tb, tp, max_slots=2, cache_len=24).run(
        reqs)
    first = {r.rid: int(r.tokens[0]) for r in res}
    checked = 0
    for req in reqs:
        jl, _ = jb.model.prefill(jp, {"tokens": jnp.asarray(req.prompt)[None]})
        tl, _ = tb.model.prefill(tp, {"tokens": torch.from_numpy(
            req.prompt)[None]})
        jtop = np.sort(np.asarray(jl[0, -1, :cfg.vocab_size], np.float32))
        ttop = np.sort(tl[0, -1, :cfg.vocab_size].float().numpy())
        if jtop[-1] - jtop[-2] > TOL and ttop[-1] - ttop[-2] > TOL:
            want = int(np.argmax(np.asarray(jl[0, -1, :cfg.vocab_size],
                                            np.float32)))
            assert first[req.rid] == want, req.rid
            checked += 1
    assert checked >= 3


def test_sampling_is_seeded():
    _, _, tb, tp = _pair()
    reqs = _requests(teng, tb.model.cfg, n=3)
    eng = teng.ContinuousEngine(tb, tp, max_slots=2, cache_len=24,
                                temperature=1.0)
    a, _ = eng.run(reqs, seed=7)
    b, _ = eng.run(reqs, seed=7)
    for x, y in zip(sorted(a, key=lambda r: r.rid),
                    sorted(b, key=lambda r: r.rid)):
        np.testing.assert_array_equal(x.tokens, y.tokens)


def test_invalid_and_backpressure_terminals():
    _, _, tb, tp = _pair()
    cfg = tb.model.cfg
    eng = teng.ContinuousEngine(tb, tp, max_slots=1, cache_len=8,
                                max_queue=0)
    reqs = [teng.Request(0, np.arange(20, dtype=np.int32), 2),
            teng.Request(1, np.arange(4, dtype=np.int32), 2),
            teng.Request(2, np.arange(4, dtype=np.int32), 2),
            teng.Request(3, np.arange(4, dtype=np.int32), 0)]
    res, stats = eng.run(reqs)
    by = {r.rid: r.status for r in res}
    assert by == {0: teng.INVALID, 1: teng.OK, 2: teng.REJECTED,
                  3: teng.INVALID}
    assert stats.terminal == 4 and cfg.is_decoder


@pytest.mark.parametrize("extra", [[], ["--no-plan"],
                                   ["--engine", "static"]],
                         ids=["planned", "no-plan", "static"])
def test_serve_cli_on_cpu(extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--reduced", "--cpu", "--new-tokens", "8",
         "--prompt-len", "16", *extra],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("served 8 requests" in out.stdout
            or "decoded 8 tokens/seq" in out.stdout), out.stdout
