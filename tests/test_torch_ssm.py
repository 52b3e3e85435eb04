"""The port's SSM (Mamba2 / SSD) slice against the JAX package's.

On the CPU `repro_torch.kernels.ops.ssd_scan` runs the plain version
(`ref.ssd_scan_ref`); `chip_smoke.py` holds the CUDA kernel against that
same plain version on the card.  Here the plain version is held against
the Pallas kernel (interpret mode, as `tests/test_kernels.py` runs it),
the JAX model path's `ssd_chunk_scan` and its sequential oracle
`ssd_ref`; then the block (`ssm_forward`, `ssm_decode`), the reduced
mamba2-2.7b model and its serving against the JAX package's.  Inputs
come from numpy; JAX parameters are carried across with
`params_from_jax`.

Tolerances:
- scan against the Pallas kernel: as `tests/test_kernels.py`, f32
  atol 1e-4, bf16 atol 5e-2 (the Pallas output is rounded to bf16),
  rtol 2e-2;
- scan against the JAX model path and the oracles, y and final state:
  atol = rtol = 1e-4.  Both sides take the inputs to fp32 first and
  run the same algorithm in fp32, so only summation order differs;
- block outputs (bf16): 5e-2 absolute and relative, as the whole
  model (`test_torch_model.py`): the two frameworks round bf16 at
  different places; the fp32 SSD state and conv cache against 2% of
  their largest entry;
- whole model: logits 5e-2 (`test_torch_model.py`'s), caches as the
  block's.
"""
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import MeshConfig as JMesh
from repro.configs import OSDPConfig as JOSDP
from repro.configs import RunConfig as JRun
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.configs import reduced as jreduced
from repro.core.cost_model import Decision as JDecision
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.registry import build_model as jbuild
from repro.serving import engine as jeng
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.cost_model import Decision as TDecision
from repro_torch.kernels import ref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import engine as teng

ROOT = Path(__file__).resolve().parent.parent
ARCH = "mamba2-2.7b"
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
TOL = dict(atol=5e-2, rtol=5e-2)
CACHE_ATOL = 2e-2
MIXED_OPS = ("layers.ssm_in", "layers.ssm_out", "head.out")
MIXED = ("DP", "ZDP", "DP", "ZDP")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _scan_inputs(seed, B, S, nh, hd, ns, dtype="float32", init=False):
    """x, dt, a_log, b, c (and an initial state) as numpy arrays: dt a
    softplus, a_log in [0, 1.5) as in `tests/test_kernels.py`."""
    rng = np.random.default_rng(seed)
    cast = ((lambda a: a.astype(ml_dtypes.bfloat16))
            if dtype == "bfloat16" else (lambda a: a))
    x = cast((rng.standard_normal((B, S, nh, hd)) * 0.5).astype(np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)))).astype(np.float32)
    a_log = rng.uniform(0.0, 1.5, nh).astype(np.float32)
    b = cast((rng.standard_normal((B, S, ns)) * 0.5).astype(np.float32))
    c = cast((rng.standard_normal((B, S, ns)) * 0.5).astype(np.float32))
    s0 = (rng.standard_normal((B, nh, hd, ns)).astype(np.float32)
          if init else None)
    return (x, dt, a_log, b, c), s0


def _torch(arrays):
    return [to_torch(a, "cpu") for a in arrays]


# --- 1. the plain scan against the Pallas kernel -----------------------------

@pytest.mark.parametrize("shape", [
    # B, S, nh, hd, ns, chunk, bh  (tests/test_kernels.py's sweep)
    (1, 32, 2, 8, 4, 8, 2),
    (2, 64, 4, 16, 8, 16, 2),
    (1, 128, 8, 32, 16, 32, 4),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_ref_matches_pallas(shape, dtype):
    B, S, nh, hd, ns, chunk, bh = shape
    args, _ = _scan_inputs(sum(shape), B, S, nh, hd, ns, dtype)
    want = jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk, bh=bh,
                         interpret=True)
    y, fin = ref.ssd_scan_ref(*_torch(args), chunk=chunk)
    assert y.dtype == fin.dtype == torch.float32
    assert tuple(fin.shape) == (B, nh, hd, ns)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(want, np.float32),
        atol=5e-2 if dtype == "bfloat16" else 1e-4, rtol=2e-2)


# --- 2. the plain scan against the JAX model path and the oracles ------------

@pytest.mark.parametrize("case", [
    # B, S, nh, hd, ns, chunk, init, dtype
    (2, 45, 4, 16, 8, 32, False, "float32"),      # ragged S
    (2, 77, 4, 16, 8, 32, True, "float32"),       # ragged S, init state
    (1, 20, 2, 8, 4, 32, True, "float32"),        # S shorter than a chunk
    (1, 64, 2, 8, 4, 16, False, "bfloat16"),
    (2, 77, 3, 32, 16, 32, True, "bfloat16"),
], ids=["S45", "S77-init", "S20-init", "bf16", "bf16-S77-init"])
def test_ssd_scan_ref_matches_jax_model_path(case):
    B, S, nh, hd, ns, chunk, init, dtype = case
    args, s0 = _scan_inputs(S * 31 + nh, B, S, nh, hd, ns, dtype, init)
    jargs = list(map(jnp.asarray, args))
    js0 = None if s0 is None else jnp.asarray(s0)
    targs = _torch(args)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    got = ref.ssd_scan_ref(*targs, chunk=chunk, init_state=ts0)
    for want in (jssm.ssd_chunk_scan(*jargs, chunk, init_state=js0),
                 jssm.ssd_ref(*jargs, init_state=js0)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                       **SCAN_TOL)
    # the port's sequential oracle is the JAX one
    seq = ref.ssd_sequential_ref(*targs, init_state=ts0)
    for g, w in zip(seq, jssm.ssd_ref(*jargs, init_state=js0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **SCAN_TOL)


def test_ssd_scan_ref_is_chunk_invariant():
    """y and the final state do not depend on the chunk (the state is
    carried right), ragged S included."""
    args, s0 = _scan_inputs(3, 1, 96, 2, 8, 4, init=True)
    targs = _torch(args)
    ts0 = torch.from_numpy(s0)
    outs = [ref.ssd_scan_ref(*targs, chunk=q, init_state=ts0)
            for q in (8, 16, 32, 96, 40)]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **SCAN_TOL)


# --- 3. the block against JAX's ----------------------------------------------

def _runs():
    jr = JRun(model=jreduced(jget_arch(ARCH)),
              shape=jget_shape("decode_32k"),
              mesh=JMesh((1, 1), ("data", "model")),
              osdp=JOSDP(enabled=False))
    tr = TRun(model=treduced(tget_arch(ARCH)),
              shape=tget_shape("decode_32k"),
              mesh=TMesh((1, 1), ("data", "model")),
              osdp=TOSDP(enabled=False))
    return jr, tr


@lru_cache(maxsize=None)
def _pair(mixed=False):
    jr, tr = _runs()
    jplan = tplan = None
    if mixed:
        jplan = SimpleNamespace(decisions={
            op: JDecision(op, MIXED) for op in MIXED_OPS})
        tplan = SimpleNamespace(decisions={
            op: TDecision(op, MIXED) for op in MIXED_OPS})
    jb, tb = jbuild(jr, jplan), tbuild(tr, tplan)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    return jb, jp, tb, tp


def _layer0(params):
    return {k: v[0] for k, v in params.items() if k.startswith("layers/")}


def _close_cache(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=5e-2,
                               atol=CACHE_ATOL * np.abs(want).max())


def test_causal_conv_and_decode_step_match_jax():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((tssm.CONV_K, 12)).astype(np.float32)
    st = rng.standard_normal((2, tssm.CONV_K - 1, 12)).astype(np.float32)
    for state in (None, st):
        want = jssm.causal_conv(jnp.asarray(u), jnp.asarray(w),
                                None if state is None else jnp.asarray(state))
        got = tssm.causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                               None if state is None
                               else torch.from_numpy(state))
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5,
                                       rtol=1e-5)
    (x, dt, a_log, b, c), s0 = _scan_inputs(6, 2, 1, 3, 8, 4, init=True)
    want = jssm.ssd_decode_step(jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
                                jnp.asarray(a_log), jnp.asarray(b[:, 0]),
                                jnp.asarray(c[:, 0]), jnp.asarray(s0))
    got = tssm.ssd_decode_step(*(torch.from_numpy(a) for a in (
        x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], s0)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **SCAN_TOL)


def test_ssm_block_prefill_then_decode_matches_jax():
    """`ssm_forward` and the prefill caches on layer 0's weights, then
    two `ssm_decode` steps from those caches (the conv state carries
    from prefill into decode)."""
    jb, jp, tb, tp = _pair()
    cfg = tb.model.cfg
    jlp, tlp = _layer0(jp), _layer0(tp)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 37, cfg.d_model)) * 0.5).astype(
        ml_dtypes.bfloat16)
    jy = jssm.ssm_forward(jb.model.cfg, jb.model.pset, jlp, jnp.asarray(x))
    ty = tssm.ssm_forward(cfg, tb.model.pset, tlp, to_torch(x, "cpu"))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)

    _, jc = jtransformer._ssm_with_state(jb.model, jlp, jnp.asarray(x))
    _, tc = ttransformer._ssm_with_state(tb.model, tlp, to_torch(x, "cpu"))
    for k in ("state", "conv"):
        assert tc[k].dtype == torch.float32
        _close_cache(tc[k], jc[k])
    for step in range(2):
        xs = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(
            ml_dtypes.bfloat16)
        jo, jc = jssm.ssm_decode(jb.model.cfg, jb.model.pset, jlp,
                                 jnp.asarray(xs), jc)
        to, tc = tssm.ssm_decode(cfg, tb.model.pset, tlp, to_torch(xs, "cpu"),
                                 tc)
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
        for k in ("state", "conv"):
            _close_cache(tc[k], jc[k])


# --- 4. the reduced model against JAX's --------------------------------------

def _prompts(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("mixed", [False, True], ids=["plain", "mixed"])
def test_prefill_matches_jax(mixed):
    jb, jp, tb, tp = _pair(mixed)
    assert set(tp) == set(jp)
    assert tb.model.geom is None
    if mixed:
        assert tb.model.pset.layouts["layers/ssm/wo"].is_split
        assert "layers/ssm/w_zx@1" in tp and "head/out@1" in tp
    cfg = tb.model.cfg
    toks = _prompts(cfg, 2, 45)                   # ragged: chunk is 32
    jl, jc = jax.jit(lambda p, b: jb.model.prefill(p, b, cache_len=64))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tb.model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              cache_len=64)
    assert set(tc) == set(jc) == {"ssm"}
    assert tuple(tl.shape) == tuple(jl.shape) == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_np(tl)[..., :cfg.vocab_size],
                               _np(jl)[..., :cfg.vocab_size], **TOL)
    for k in ("state", "conv"):
        assert tuple(tc["ssm"][k].shape) == tuple(jc["ssm"][k].shape)
        _close_cache(tc["ssm"][k], jc["ssm"][k])


@pytest.mark.parametrize("vector_t", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("mixed", [False, True], ids=["plain", "mixed"])
def test_decode_matches_jax(mixed, vector_t):
    jb, jp, tb, tp = _pair(mixed)
    cfg = tb.model.cfg
    B, S = 3, 16
    toks = _prompts(cfg, B, S, seed=1)
    jl, jc = jax.jit(lambda p, b: jb.model.prefill(p, b, cache_len=24))(
        jp, {"tokens": jnp.asarray(toks)})
    _, tc = tb.model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                             cache_len=24)
    jstep = jax.jit(jb.model.decode_step)
    tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    for i in range(3):
        t = S + i
        jt = jnp.full((B,), t, jnp.int32) if vector_t else jnp.int32(t)
        tt = torch.full((B,), t, dtype=torch.int32) if vector_t else t
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jt)
        tl, tc = tb.model.decode_step(tp, tc, torch.from_numpy(tok), tt)
        np.testing.assert_allclose(_np(tl)[..., :cfg.vocab_size],
                                   _np(jl)[..., :cfg.vocab_size], **TOL)
        # teacher-force the reference's greedy token into both
        tok = np.array(jnp.argmax(jl[:, 0, :cfg.vocab_size], -1),
                       np.int32)[:, None]
    for k in ("state", "conv"):
        _close_cache(tc["ssm"][k], jc["ssm"][k])


def test_init_draws_ssm_a_and_refuses_other_families():
    _, tr = _runs()
    params = tbuild(tr).init(0, "cpu")
    a_log = params["layers/ssm/A_log"].float()
    assert tuple(a_log.shape) == (
        tr.model.n_layers, tr.model.ssm_n_heads)
    # U[log 1, log 16], rounded to bf16
    assert 0.0 <= a_log.min() and a_log.max() <= np.log(16.0) + 1e-2
    assert a_log.std() > 0.3
    for arch in ("hymba-1.5b", "dbrx-132b", "qwen2-vl-2b", "hubert-xlarge"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            ttransformer.build_specs(treduced(tget_arch(arch)), 1)


# --- 5. serving --------------------------------------------------------------

def _requests(mod, cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    lens = [9, 40, 12, 9, 40, 20, 33, 17, 25, 11][:n]   # 40: two chunks
    news = [4, 7, 2, 6, 3, 5, 2, 4, 3, 6][:n]
    return [mod.Request(i, rng.integers(0, cfg.vocab_size, lens[i])
                        .astype(np.int32), news[i]) for i in range(n)]


def _schedule(results):
    return sorted((r.rid, r.admitted_at_step, r.finished_at_step, r.status,
                   r.attempts, r.n_generated) for r in results)


@pytest.mark.parametrize("max_slots", [1, 3])
def test_schedule_matches_jax(max_slots):
    jb, jp, tb, tp = _pair()
    cfg = tb.model.cfg
    jres, jst = jeng.ContinuousEngine(jb, jp, max_slots, 48).run(
        _requests(jeng, cfg))
    tres, tst = teng.ContinuousEngine(tb, tp, max_slots, 48).run(
        _requests(teng, cfg))
    assert _schedule(tres) == _schedule(jres)
    assert (tst.prefill_steps, tst.decode_steps, tst.useful_tokens,
            tst.completed) == (jst.prefill_steps, jst.decode_steps,
                               jst.useful_tokens, jst.completed)
    assert all(r.status == teng.OK for r in tres)


def test_tokens_equal_own_greedy_decode():
    """Each request's tokens from 2 shared slots equal the port's static
    engine on that request alone: slots do not leak state."""
    _, _, tb, tp = _pair()
    reqs = _requests(teng, tb.model.cfg)
    res, _ = teng.ContinuousEngine(tb, tp, max_slots=2, cache_len=48).run(
        reqs)
    static = teng.Engine(tb, tp, cache_len=48)
    for r in res:
        req = reqs[r.rid]
        want = static.generate(req.prompt[None], req.max_new_tokens).tokens
        np.testing.assert_array_equal(r.tokens, want[0])


def test_first_tokens_match_jax_where_decisive():
    jb, jp, tb, tp = _pair()
    cfg = tb.model.cfg
    reqs = _requests(teng, cfg, n=10)
    res, _ = teng.ContinuousEngine(tb, tp, max_slots=2, cache_len=48).run(
        reqs)
    first = {r.rid: int(r.tokens[0]) for r in res}
    checked = 0
    for req in reqs:
        jl, _ = jb.model.prefill(jp, {"tokens": jnp.asarray(req.prompt)[None]})
        tl, _ = tb.model.prefill(tp, {"tokens": torch.from_numpy(
            req.prompt)[None]})
        jtop = np.sort(_np(jl[0, -1, :cfg.vocab_size]))
        ttop = np.sort(_np(tl[0, -1, :cfg.vocab_size]))
        if jtop[-1] - jtop[-2] > TOL["atol"] and \
                ttop[-1] - ttop[-2] > TOL["atol"]:
            assert first[req.rid] == int(np.argmax(
                _np(jl[0, -1, :cfg.vocab_size]))), req.rid
            checked += 1
    assert checked >= 3


def test_serve_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--cpu", "--new-tokens", "8", "--prompt-len", "40"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 8 requests" in out.stdout, out.stdout
