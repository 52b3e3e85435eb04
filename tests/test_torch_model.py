"""The port's dense model against the JAX package's, on the same weights.

JAX parameters (reduced configs, `built.init(PRNGKey(0))`) are carried
across with `params_from_jax`; prompts come from numpy.  Compared:
prefill last-position logits and KV caches, and decode logits over a
few steps with scalar and vector positions, the reference's greedy
tokens teacher-forced into both.  Also a forced mixed DP/ZDP plan, so
`seg_matmul` runs both its sum (input-dim) and concat (output-dim)
variants.

Tolerance: atol = rtol = 5e-2 on bf16 logits.  Both models keep
activations in bf16 between layers but round at different places (the
port's matmuls accumulate in fp32 and round once; XLA's CPU dot and
its fused rope/norm round elsewhere), so logits of O(1) differ by a few
bf16 ulps; the JAX package's own decode-vs-prefill check, which compares
two programs of one framework, needs 0.15.
"""
from functools import lru_cache
from types import SimpleNamespace

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
from repro.core.cost_model import Decision as JDecision
from repro.models.registry import build_model as jbuild
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.core.cost_model import Decision as TDecision
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model as tbuild
from repro_torch.sharding.specs import gather_weight

TOL = dict(atol=5e-2, rtol=5e-2)
# k/v caches are compared against their own scale: 2% of the largest
# entry is about two bf16 ulps there (the mixed plan's segment-wise
# fan-in init makes its activations ~4x larger, in both packages)
CACHE_ATOL = 2e-2
# (arch, reduced overrides): phi4 keeps GQA (4 q heads on 2 kv heads);
# qwen1.5 brings the QKV bias and tied embeddings
ARCHS = {"phi4": ("phi4-mini-3.8b", dict(n_kv_heads=2)),
         "qwen": ("qwen1.5-0.5b", {})}
MIXED_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
             "layers.ffn_w2", "head.out")
MIXED = ("DP", "ZDP", "DP", "ZDP")


def _runs(name):
    arch, kw = ARCHS[name]
    jr = JRun(model=jreduced(jget_arch(arch), **kw),
              shape=jget_shape("decode_32k"),
              mesh=JMesh((1, 1), ("data", "model")),
              osdp=JOSDP(enabled=False))
    tr = TRun(model=treduced(tget_arch(arch), **kw),
              shape=tget_shape("decode_32k"),
              mesh=TMesh((1, 1), ("data", "model")),
              osdp=TOSDP(enabled=False))
    return jr, tr


@lru_cache(maxsize=None)
def _pair(name, mixed=False):
    jr, tr = _runs(name)
    jplan = tplan = None
    if mixed:
        jplan = SimpleNamespace(decisions={
            op: JDecision(op, MIXED) for op in MIXED_OPS})
        tplan = SimpleNamespace(decisions={
            op: TDecision(op, MIXED) for op in MIXED_OPS})
    jb, tb = jbuild(jr, jplan), tbuild(tr, tplan)
    jparams = jb.init(jax.random.PRNGKey(0))
    tparams = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                              device="cpu")
    return jb, jparams, tb, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _prompts(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("mixed", [False, True], ids=["plain", "mixed"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_prefill_matches_jax(name, mixed):
    jb, jp, tb, tp = _pair(name, mixed)
    assert set(tp) == set(jp)
    if mixed:
        assert tb.model.pset.layouts["layers/attn/wo"].is_split
        assert "layers/ffn/w13@1" in tp
    cfg = tb.model.cfg
    toks = _prompts(cfg, 2, 24)
    jl, jc = jax.jit(lambda p, b: jb.model.prefill(p, b, cache_len=32))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tb.model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                              cache_len=32)
    assert tuple(tl.shape) == tuple(jl.shape) == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_np(tl)[..., :cfg.vocab_size],
                               _np(jl)[..., :cfg.vocab_size], **TOL)
    # padded vocab entries are masked in both
    np.testing.assert_array_equal(_np(tl)[..., cfg.vocab_size:] < -1e29,
                                  True)
    for key in ("k", "v"):
        want = _np(jc["attn"][key])
        np.testing.assert_allclose(_np(tc["attn"][key]), want, rtol=5e-2,
                                   atol=CACHE_ATOL * np.abs(want).max())
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))


@pytest.mark.parametrize("vector_t", [False, True], ids=["scalar", "vector"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_matches_jax(name, vector_t):
    jb, jp, tb, tp = _pair(name)
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
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(jc["attn"]["pos"]))


@pytest.mark.parametrize("name", list(ARCHS))
def test_decode_past_a_rolling_cache_matches_jax(name):
    """Decode past a prompt-length cache: an 8-token prompt prefilled
    with the default cache_len (8 slots), then 12 teacher-forced steps,
    each overwriting the oldest slot; logits and the slots' positions
    against JAX."""
    jb, jp, tb, tp = _pair(name)
    cfg = tb.model.cfg
    B, S = 2, 8
    toks = _prompts(cfg, B, S, seed=6)
    jl, jc = jax.jit(lambda p, b: jb.model.prefill(p, b))(
        jp, {"tokens": jnp.asarray(toks)})
    _, tc = tb.model.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tc["attn"]["k"].shape[2] == jc["attn"]["k"].shape[2] == S
    jstep = jax.jit(jb.model.decode_step)
    tok = np.array(jnp.argmax(jl[:, -1, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    for i in range(12):
        t = S + i
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(t))
        tl, tc = tb.model.decode_step(tp, tc, torch.from_numpy(tok), t)
        np.testing.assert_allclose(_np(tl)[..., :cfg.vocab_size],
                                   _np(jl)[..., :cfg.vocab_size], **TOL)
        np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                      np.asarray(jc["attn"]["pos"]))
        tok = np.array(jnp.argmax(jl[:, 0, :cfg.vocab_size], -1),
                       np.int32)[:, None]
    # the last 8 positions, each in slot t % 8
    assert sorted(tc["attn"]["pos"][0, 0].tolist()) == list(range(12, 20))


def test_mixed_plan_decode_matches_jax():
    jb, jp, tb, tp = _pair("phi4", True)
    cfg = tb.model.cfg
    toks = _prompts(cfg, 2, 12, seed=2)
    _, jc = jax.jit(lambda p, b: jb.model.prefill(p, b, cache_len=16))(
        jp, {"tokens": jnp.asarray(toks)})
    _, tc = tb.model.prefill(tp, {"tokens": torch.from_numpy(toks)},
                             cache_len=16)
    step = _prompts(cfg, 2, 1, seed=3)
    jl, _ = jax.jit(jb.model.decode_step)(jp, jc, jnp.asarray(step),
                                          jnp.int32(12))
    tl, _ = tb.model.decode_step(tp, tc, torch.from_numpy(step), 12)
    np.testing.assert_allclose(_np(tl)[..., :cfg.vocab_size],
                               _np(jl)[..., :cfg.vocab_size], **TOL)


def test_mixed_segments_equal_gathered_weights():
    """Operator splitting is exact up to summation order: the plain
    model's weights cut into the mixed plan's segments give the same
    logits as the unsplit weights; `gather_weight` puts the segments
    back together exactly."""
    _, _, tb_mix, _ = _pair("phi4", True)
    _, _, tb, tp = _pair("phi4")
    cut = {}
    for path, lay in tb_mix.model.pset.layouts.items():
        for seg in lay.segments:
            w = tp[path]
            if lay.is_split:
                w = w.narrow(lay.spec.zdp_axis, seg.start, seg.size)
            cut[path + seg.key] = w.contiguous()
    for path, lay in tb_mix.model.pset.layouts.items():
        torch.testing.assert_close(
            gather_weight(cut, tb_mix.model.pset, path), tp[path],
            rtol=0, atol=0)
    toks = torch.from_numpy(_prompts(tb.model.cfg, 1, 10, seed=4))
    a, _ = tb_mix.model.prefill(cut, {"tokens": toks})
    b, _ = tb.model.prefill(tp, {"tokens": toks})
    np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_cpu_model_path_launches_no_kernel():
    _, _, tb, tp = _pair("qwen")
    ops.reset_launch_counts()
    tb.model.prefill(tp, {"tokens": torch.from_numpy(
        _prompts(tb.model.cfg, 1, 8))})
    counts = ops.launch_counts()
    assert {"split_matmul", "flash_attention", "ssd_scan"} <= set(counts)
    assert set(counts.values()) == {0}


def test_init_is_seeded_and_segmented(monkeypatch):
    _, tr = _runs("phi4")
    plan = SimpleNamespace(decisions={
        op: TDecision(op, MIXED) for op in MIXED_OPS})
    built = tbuild(tr, plan)
    a = built.init(3, "cpu")
    b = built.init(3, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert a["layers/attn/wq@0"].shape == (tr.model.n_layers, 64,
                                           tr.model.d_model)
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    # the default device is the card; without one, init raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        built.init(0)
