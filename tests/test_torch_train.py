"""The port's training path against the JAX package's.

- AdamW (`optim/adamw.py`) and the warmup-cosine scale: one and three
  updates from the same parameters and gradients (numpy) against
  `repro.optim`; the decay mask on every leaf name of qwen1.5-0.5b.
- `Dataset.global_batch` byte-identical to the JAX package's.
- Three training steps of reduced qwen1.5-0.5b, reduced phi4-mini and
  reduced mamba2-2.7b (remat off and on) through the port's `train()` against the JAX package's
  `make_train_step` on the same weights (`params_from_jax` of
  `built.init(PRNGKey(0))`) and the same synthetic batches: DP-only and
  mixed DP/ZDP plans, remat on and off, microbatch 1 and 2.
- Microbatching, the chunked cross-entropy (its chunk rule lowered on
  the port's side), what remat recomputes, a plan's remat bits against
  the JAX package's policy, the refusals (hybrid training, a corrupt
  checkpoint) and `launch/train.py`.

Every tensor is small: reduced configs (2 layers, d <= 256, vocab
<= 512), seq <= 128, batch <= 4.  Full-width facts are checked without
tensors.  No test forks or builds the CUDA library.

Tolerances.  AdamW: the gradient norm, fp32 master, m and v within 1e-5
relative, plus 1e-6 of the array's largest entry for entries that
cancel near 0 (the same float32 arithmetic; the sum of squares is
reduced in another order, measured 1.2e-6); bf16 parameters within one
bf16 ulp.  Schedule: 1e-6 relative (float32 on both sides).  Three
steps in float32: losses within 1e-4 relative (measured at most
5.6e-6), the step-1 grad norm within 1e-5 (measured 8.7e-7) and every
step's within 1e-2: AdamW's first updates move each weight by about lr
whatever its gradient's size, so gradient entries near 0, whose sign
the two packages' summation orders can flip, grow the difference about
a hundredfold a step (measured 8.7e-7, 1.7e-5, 1.8e-3 under the mixed
plan, whose segment-wise init makes activations about 4x larger).  That
is rounding, not a different function: float64 parameters alone do not
remove it, since both packages compute attention scores, norms, RoPE,
SwiGLU, the cross-entropy and AdamW's state in float32 whatever the
parameters' type; with every float32 of both lifted to float64
(`test_mixed_plan_gap_is_float32_rounding`) the mixed plan at
microbatch 2 agrees with JAX to float64 rounding (losses 4.2e-16, the
step-3 grad norm 1.2e-12, parameters 6.6e-9 of a leaf's norm).  In
bfloat16 the frameworks round activations and gradients at different
places (see tests/test_torch_backward.py): losses within 5e-3 and grad
norms within 3e-2 (measured 4.9e-5 and 7.8e-4).
Chunked cross-entropy: the loss within 1e-6 relative of the unchunked
branch (only the order of the sum over chunks differs), each gradient
leaf within 1e-6 (float32) or 1e-2 (bfloat16) of its norm, and against
JAX the bounds of tests/test_torch_backward.py.
"""
import dataclasses
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
from repro.data.synthetic import Dataset as JDataset
from repro.models.registry import build_model as jbuild
from repro.models.registry import train_inputs as jtrain_inputs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_update as japply
from repro.optim import init_state as jinit_state
from repro.optim import warmup_cosine as jwarmup_cosine
from repro.optim.adamw import _decay_mask as jmask
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.checkpoint.io import CheckpointCorruptError
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.cost_model import Decision as TDecision
from repro_torch.data.synthetic import Dataset as TDataset
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tmodel
from repro_torch.models.registry import build_model as tbuild
from repro_torch.models.registry import train_inputs as ttrain_inputs
from repro_torch.optim import AdamWConfig, apply_update, init_state
from repro_torch.optim import warmup_cosine
from repro_torch.optim.adamw import _decay_mask as tmask
from repro_torch.train.loop import loss_and_grads
from repro_torch.train.loop import train as ttrain

ARCHS = {"phi4": ("phi4-mini-3.8b", dict(n_kv_heads=2)),
         "qwen": ("qwen1.5-0.5b", {}),
         # chunk 32: two chunks of the scan at seq 64
         "mamba": ("mamba2-2.7b", dict(ssm_chunk=32))}
MIXED_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
             "layers.ffn_w2", "head.out")
MIXED = ("DP", "ZDP", "DP", "ZDP")
LOSS_RTOL = {"float32": 1e-4, "bfloat16": 5e-3}
# grad norms: (step 1, every step)
GNORM_RTOL = {"float32": (1e-5, 1e-2), "bfloat16": (3e-2, 3e-2)}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
F32_LEAF_TOL = 1e-3
BF16_NOISE_FACTOR = 2.0


def _runs(name, plan="dp", remat=True, microbatch=0, seq=64, batch=4):
    """Both packages' reduced run configs at a small training shape, OSDP
    off (a plan's decisions come from `_plans`); `remat` is the global
    checkpointing flag."""
    arch, kw = ARCHS[name]
    out = []
    for Run, Mesh, OSDP, get_arch, get_shape, reduced in (
            (JRun, JMesh, JOSDP, jget_arch, jget_shape, jreduced),
            (TRun, TMesh, TOSDP, tget_arch, tget_shape, treduced)):
        shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                    global_batch=batch)
        out.append(Run(model=reduced(get_arch(arch), **kw), shape=shape,
                       mesh=Mesh((1, 1), ("data", "model")),
                       osdp=OSDP(enabled=False, checkpointing=remat),
                       microbatch=microbatch))
    return out


def _plans(plan, bits=None):
    if plan == "dp":
        return None, None
    return (SimpleNamespace(decisions={op: JDecision(op, MIXED, bits)
                                       for op in MIXED_OPS}),
            SimpleNamespace(decisions={op: TDecision(op, MIXED, bits)
                                       for op in MIXED_OPS}))


def _tparams(jp):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")


# --- optimizer and schedule ----------------------------------------------------

SHAPES = {"embed/tok": (64, 32), "layers/attn/wq@1": (2, 32, 16),
          "layers/attn/bq": (2, 16), "layers/ffn/norm_scale": (2, 32),
          "final_norm/scale": (32,), "head/out": (32, 64)}


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(s) * 0.05).astype(ml_dtypes.bfloat16)
         for k, s in SHAPES.items()}
    gs = [{k: (rng.standard_normal(s) * 0.3).astype(ml_dtypes.bfloat16)
           for k, s in SHAPES.items()} for _ in range(3)]
    return p, gs


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_jax(steps):
    p, gs = _params_and_grads(steps)
    cfg = dict(lr=1e-2, grad_clip=1.0, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jst = jinit_state(jp)
    tp = {k: to_torch(v, "cpu") for k, v in p.items()}
    tst = init_state(tp)
    for i in range(steps):
        scale = warmup_cosine(i + 1, 2, 10)
        assert scale == pytest.approx(float(jwarmup_cosine(
            jnp.int32(i + 1), 2, 10)), rel=1e-7)
        jp, jst, jm = japply(JAdamWConfig(**cfg), jp,
                             {k: jnp.asarray(v) for k, v in gs[i].items()},
                             jst, jnp.float32(scale))
        tp, tst, tm = apply_update(
            AdamWConfig(**cfg), tp,
            {k: to_torch(v, "cpu") for k, v in gs[i].items()}, tst, scale)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
    assert tst.step == int(jst.step) == steps
    for k in SHAPES:
        for name in ("master", "m", "v"):
            want = np.asarray(getattr(jst, name)[k])
            np.testing.assert_allclose(
                getattr(tst, name)[k].numpy(), want, rtol=1e-5,
                atol=1e-6 * np.abs(want).max(), err_msg=f"{name} {k}")
        got = tp[k].float().numpy()
        want = np.asarray(jp[k], np.float32)
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0,
                                   err_msg=k)


def test_adamw_clips_the_global_norm():
    """A gradient of norm 100 is clipped to 1: the first update is lr
    times sign(g) at most (Adam's normalized step), decay aside."""
    tp = {"w": torch.zeros(4, 25)}
    st = init_state(tp)
    _, _, m = apply_update(AdamWConfig(lr=0.1, weight_decay=0.0), tp,
                           {"w": torch.full((4, 25), 10.0)}, st, 1.0)
    assert float(m["grad_norm"]) == pytest.approx(100.0)
    torch.testing.assert_close(tp["w"], torch.full((4, 25), -0.1),
                               rtol=1e-5, atol=0)


def test_adamw_slices_are_bit_identical(monkeypatch):
    """`apply_update` walks a leaf in flat slices of `UPDATE_SLICE`
    elements (so a 1.68 B-element stacked leaf needs no 6.7 GB fp32
    temporaries): the update is elementwise, so three steps with slices
    of 7 elements, ragged against every leaf, equal whole-leaf updates
    bit for bit."""
    from repro_torch.optim import adamw as tadamw
    p, gs = _params_and_grads(3)
    runs = []
    for sl in (tadamw.UPDATE_SLICE, 7):
        monkeypatch.setattr(tadamw, "UPDATE_SLICE", sl)
        tp = {k: to_torch(v, "cpu") for k, v in p.items()}
        st = init_state(tp)
        for g in gs:
            apply_update(AdamWConfig(), tp, {k: to_torch(v, "cpu")
                                             for k, v in g.items()}, st, 1.0)
        runs.append((tp, st))
    (a, sa), (b, sb) = runs
    for k in a:
        assert torch.equal(a[k], b[k])
        assert torch.equal(sa.master[k], sb.master[k])
        assert torch.equal(sa.m[k], sb.m[k]) and torch.equal(sa.v[k],
                                                             sb.v[k])


def test_decay_mask_on_every_qwen_leaf():
    """Every leaf name of qwen1.5-0.5b at full width (read from the plan
    layouts, no tensor built), plain and under a mixed plan's segments,
    and the SSM's small vectors: the same mask as the JAX package's."""
    _, tr = _runs("qwen")
    names = set()
    for tplan in (None, _plans("mixed")[1]):
        full = dataclasses.replace(tr, model=tget_arch("qwen1.5-0.5b"))
        pset = tbuild(full, tplan).model.pset
        names |= {leaf for path in pset.layouts
                  for leaf, _ in pset.segments(path)}
    assert {"embed/tok", "layers/attn/bq", "layers/ffn/w13@3"} <= names
    assert "head/out" not in names                    # tied embeddings
    for k in sorted(names) + ["layers/ssm/A_log", "layers/ssm/D",
                              "layers/ssm/dt_bias", "embed/mask"]:
        assert tmask(k) == jmask(k), k
    # only the norms skip decay: the QKV biases are named bq/bk/bv, not
    # "bias", so both packages decay them
    assert {k for k in names if not tmask(k)} == {
        "final_norm/scale", "layers/attn/norm_scale",
        "layers/ffn/norm_scale"}


@pytest.mark.parametrize("step", [0, 1, 2, 50, 99, 100, 101, 5000, 10_000,
                                  20_000])
def test_warmup_cosine_matches_jax(step):
    want = float(jwarmup_cosine(jnp.int32(step), 100, 10_000))
    assert warmup_cosine(step, 100, 10_000) == pytest.approx(want,
                                                             rel=1e-6)


# --- data ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "phi4-mini-3.8b",
                                  "mamba2-2.7b"])
def test_dataset_batches_are_byte_identical(arch):
    shape = dataclasses.replace(jget_shape("train_4k"), seq_len=96,
                                global_batch=3)
    jd = JDataset(jreduced(jget_arch(arch)), shape, seed=7)
    td = TDataset(treduced(tget_arch(arch)), tget_shape("train_4k"), seed=7)
    for step in range(3):
        want = jd.global_batch(step)
        got = td.global_batch(step, batch=3, seq=96)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes(), (arch, step, k)
    hb = td.host_batch(1, 1, 3, batch=3, seq=96)
    np.testing.assert_array_equal(hb["tokens"],
                                  jd.global_batch(1)["tokens"][1:2])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "phi4-mini-3.8b"])
def test_train_inputs_match_jax_at_full_width(arch):
    """The training batch of the chip's cell (batch 8 x seq 4096) at full
    width: the same names, shapes and dtypes as the JAX package's
    ShapeDtypeStructs, on the meta device (nothing allocated); the
    synthetic batch at a reduced size has the same names and dtypes."""
    want = jtrain_inputs(jget_arch(arch), 8, 4096)
    got = ttrain_inputs(tget_arch(arch), 8, 4096)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape)
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype)
    small = TDataset(treduced(tget_arch(arch)), tget_shape("train_4k"),
                     seed=0).global_batch(0, batch=2, seq=16)
    assert {k: str(v.dtype) for k, v in small.items()} == {
        k: str(t.dtype).removeprefix("torch.") for k, t in got.items()}
    with pytest.raises(NotImplementedError, match="not ported"):
        ttrain_inputs(tget_arch("hubert-xlarge"), 2, 16)


# --- three training steps against make_train_step --------------------------------

# (arch, plan, remat, microbatch, dtype): each arch under both plans,
# remat on and off and microbatch 1 and 2 in float32, where the two
# packages do the same arithmetic; and once in bfloat16, the models'
# own dtype
TRAIN_CASES = [("qwen", "dp", True, 0, "float32"),
               ("qwen", "mixed", False, 2, "float32"),
               ("phi4", "dp", False, 2, "float32"),
               ("phi4", "mixed", True, 0, "float32"),
               ("qwen", "dp", False, 0, "bfloat16"),
               ("mamba", "dp", False, 0, "float32"),
               ("mamba", "dp", True, 0, "float32")]


@pytest.mark.parametrize("name,plan,remat,microbatch,dtype", TRAIN_CASES,
                         ids=lambda v: str(v))
def test_three_steps_match_jax_make_train_step(name, plan, remat,
                                               microbatch, dtype):
    jr, tr = _runs(name, plan, remat, microbatch)
    jplan, tplan = _plans(plan)
    jb, tb = jbuild(jr, jplan), tbuild(tr, tplan)
    assert tb.model.remat is remat
    if plan == "mixed":
        assert tb.model.pset.layouts["layers/ffn/w13"].is_split
    opt = dict(lr=1e-3)
    sched = dict(warmup=2, total_steps=10)
    # no donation: a float32 master aliases its float32 parameter
    jstep, _ = jmake_train_step(jb, JAdamWConfig(**opt), donate=False,
                                **sched)
    jp = {k: v.astype(dtype) for k, v in
          jb.init(jax.random.PRNGKey(0)).items()}
    jst = jinit_state(jp)
    start = _tparams(jp)
    ds = JDataset(jr.model, jr.shape, seed=0)
    jlosses, jnorms = [], []
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in ds.global_batch(s).items()}
        jp, jst, m = jstep(jp, jst, batch)
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    res = ttrain(tb, 3, opt_cfg=AdamWConfig(**opt), device="cpu",
                 params=start, log_every=0, **sched)
    assert res.steps == 3 and len(res.step_ms) == 3
    assert res.tokens_per_s > 0
    np.testing.assert_allclose(res.losses, jlosses, rtol=LOSS_RTOL[dtype])
    first, every = GNORM_RTOL[dtype]
    np.testing.assert_allclose(res.grad_norms[0], jnorms[0], rtol=first)
    np.testing.assert_allclose(res.grad_norms, jnorms, rtol=every)
    assert res.final_metrics["tokens"] == 4 * 64 / max(1, microbatch)


def test_mixed_plan_gap_is_float32_rounding(monkeypatch):
    """The mixed plan at microbatch 2, the float32 case whose step-3 grad
    norm differs from JAX by 1.8e-3, run again with every float32 of
    both packages lifted to float64: the parameters, and the attention
    scores, norms, RoPE, SwiGLU, cross-entropy, gradient accumulators and
    AdamW state that both packages compute in float32 whatever the
    parameters' type (`jnp.float32`, `torch.float32` and `Tensor.float`
    read as float64, `jax_enable_x64` on).  The gap then falls to float64
    rounding (measured: losses 4.2e-16, grad norms 2.6e-15 at step 1 and
    1.2e-12 at step 3, parameters 6.6e-9 of a leaf's norm, the QKV
    biases), so the float32 gap is rounding that AdamW's normalised step
    grows, not a difference in what the port computes."""
    monkeypatch.setattr(jnp, "float32", jnp.float64)
    monkeypatch.setattr(torch, "float32", torch.float64)
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda self, *a, **k: self.to(torch.float64))
    with jax.enable_x64(True):
        jr, tr = _runs("qwen", "mixed", False, 2)
        jplan, tplan = _plans("mixed")
        jb, tb = jbuild(jr, jplan), tbuild(tr, tplan)
        opt = dict(lr=1e-3)
        sched = dict(warmup=2, total_steps=10)
        jstep, _ = jmake_train_step(jb, JAdamWConfig(**opt), donate=False,
                                    **sched)
        jp = {k: v.astype(jnp.float64) for k, v in
              jb.init(jax.random.PRNGKey(0)).items()}
        jst = jinit_state(jp)
        assert {str(v.dtype) for v in jax.tree.leaves(jst)} == {"float64",
                                                                "int32"}
        start = _tparams(jp)
        ds = JDataset(jr.model, jr.shape, seed=0)
        jlosses, jnorms = [], []
        for s in range(3):
            batch = {k: jnp.asarray(v) for k, v in
                     ds.global_batch(s).items()}
            jp, jst, m = jstep(jp, jst, batch)
            jlosses.append(float(m["loss"]))
            jnorms.append(float(m["grad_norm"]))
        jp = {k: np.asarray(v) for k, v in jp.items()}
    res = ttrain(tb, 3, opt_cfg=AdamWConfig(**opt), device="cpu",
                 params=start, log_every=0, **sched)
    assert {t.dtype for t in res.params.values()} == {torch.float64}
    np.testing.assert_allclose(res.losses, jlosses, rtol=1e-13)
    np.testing.assert_allclose(res.grad_norms, jnorms, rtol=1e-10)
    for k, want in jp.items():
        got = res.params[k].detach().numpy()
        assert np.linalg.norm(got - want) <= 1e-7 * np.linalg.norm(want), k


def test_microbatched_grads_average_the_halves():
    """microbatch 2: gradients accumulated in fp32 and averaged equal
    the mean of the two halves' gradients (the JAX scan's arithmetic)."""
    _, tr = _runs("qwen")
    tb = tbuild(tr)
    tp = {k: v.float() for k, v in tb.init(0, "cpu").items()}
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 512, (4, 33)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _, grads = loss_and_grads(tb.model, tp, batch, microbatch=2)
    halves = [loss_and_grads(tb.model, tp, {k: v[i:i + 2]
                                            for k, v in batch.items()})
              for i in (0, 2)]
    assert abs(float(loss) - float(halves[0][0] + halves[1][0]) / 2) < 1e-6
    for k, g in grads.items():
        assert g.dtype == torch.float32
        want = (halves[0][2][k].float() + halves[1][2][k].float()) / 2
        torch.testing.assert_close(g, want, rtol=0, atol=1e-7)


# --- the chunked cross-entropy ---------------------------------------------------

@pytest.fixture
def small_chunks(monkeypatch):
    """Chunk 32 and no size threshold: the chunked branch at S 128."""
    monkeypatch.setattr(tmodel, "CE_CHUNK", 32)
    monkeypatch.setattr(tmodel, "CE_MIN_ELEMS", 0)


def _counting_products(monkeypatch):
    """Record the x shape of every forward product (`ops.split_matmul`,
    which the differentiable `ops.matmul` calls; the backward's products
    go through `ops.split_matmul_dgrad` / `_wgrad`)."""
    calls = []
    plain = ops.split_matmul

    def counting(x, w, **kw):
        calls.append(tuple(x.shape))
        return plain(x, w, **kw)
    monkeypatch.setattr(ops, "split_matmul", counting)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_loss_matches_unchunked(small_chunks, monkeypatch, dtype):
    """The port's chunked cross-entropy (4 chunks of 32, each under a
    checkpoint) against its own unchunked branch: the same loss up to
    summation order and the same gradients; and against JAX's loss and
    gradients (unchunked at this size: chunking does not change the
    value)."""
    jr, tr = _runs("qwen", seq=128, batch=2)
    jb, tb = jbuild(jr), tbuild(tr)
    jp = jb.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    model, B, d = tb.model, 2, tb.model.cfg.d_model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (B, 129)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
              "labels": torch.from_numpy(toks[:, 1:].copy())}
    calls = _counting_products(monkeypatch)
    loss_c, _, g_c = loss_and_grads(model, _tparams(jp), tbatch)
    # four head chunks of B x 32 rows, each run again in the backward
    assert calls.count((B * 32, d)) == 8
    monkeypatch.setattr(tmodel, "CE_CHUNK", 256)   # S % chunk: unchunked
    del calls[:]
    loss_u, _, g_u = loss_and_grads(model, _tparams(jp), tbatch)
    assert (B * 32, d) not in calls
    assert abs(float(loss_c) - float(loss_u)) <= 1e-6 * float(loss_u)
    for k in g_u:
        rel = np.linalg.norm((g_c[k] - g_u[k]).float().numpy()) \
            / np.linalg.norm(g_u[k].float().numpy())
        assert rel <= (1e-6 if dtype == "float32" else 1e-2), k
    grads_of = lambda p: jax.jit(jax.value_and_grad(
        jb.model.loss_fn, has_aux=True))(p, jbatch)
    (jloss, _), jgrads = grads_of(jp)
    _, exact = grads_of({k: v.astype(jnp.float32) for k, v in jp.items()})
    assert abs(float(loss_c) - float(jloss)) <= LOSS_TOL[dtype] * float(jloss)
    for k, g in jgrads.items():
        g, e = np.asarray(g, np.float32), np.asarray(exact[k], np.float32)
        tol = (F32_LEAF_TOL if dtype == "float32" else
               BF16_NOISE_FACTOR * np.linalg.norm(g - e) / np.linalg.norm(e))
        got = g_c[k].float().numpy()
        assert np.linalg.norm(got - g) / np.linalg.norm(g) <= tol, k


def test_chunk_rule_follows_the_jax_package():
    """The branch condition of the JAX package's inline rule, at the
    module's constants (no tensor): qwen's full vocabulary at S 4096
    chunks, S 512 and the reduced vocabulary do not."""
    Vp = tget_arch("qwen1.5-0.5b").padded_vocab
    take = lambda S, V: (S % tmodel.CE_CHUNK == 0 and S > tmodel.CE_CHUNK
                         and S * V >= tmodel.CE_MIN_ELEMS)
    assert (tmodel.CE_CHUNK, tmodel.CE_MIN_ELEMS) == (512, 2 ** 27)
    assert Vp == 152064
    assert take(4096, Vp) and not take(512, Vp) and not take(4096, 512)


# --- remat ---------------------------------------------------------------------

def test_remat_recomputes_each_layer_once(monkeypatch):
    """Forward products of one step on reduced phi4 under the mixed plan
    (2 layers, 6 weights a layer, each in 4 segments, plus the head):
    without remat each runs once; with it each layer runs again in the
    backward, the head does not."""
    counts = {}
    for remat in (False, True):
        _, tr = _runs("phi4", "mixed", remat, seq=32, batch=2)
        tb = tbuild(tr, _plans("mixed")[1])
        assert tb.model.remat is remat
        calls = _counting_products(monkeypatch)
        params = tb.init(0, "cpu")
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, 512, (2, 33)).astype(
            np.int32))
        loss_and_grads(tb.model, params, {"tokens": toks[:, :-1],
                                          "labels": toks[:, 1:]})
        counts[remat] = len(calls)
        monkeypatch.undo()
    layout = tb.model.pset.layouts
    per_layer = sum(len(layout[p].segments) for p in (
        "layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
        "layers/attn/wo", "layers/ffn/w13", "layers/ffn/w2"))
    head = len(layout["head/out"].segments)
    assert per_layer == 24 and head == 4
    assert counts[False] == 2 * per_layer + head
    assert counts[True] == 2 * 2 * per_layer + head


def test_plan_remat_bits_and_selective_refusal():
    """A plan's per-slice remat bits: all recompute gives remat True,
    all keep False, and a mix (a selective plan) compiles to the names
    to keep, as the JAX package's `_remat_policy` (no longer refused:
    tests/test_torch_remat.py runs them)."""
    jr, tr = _runs("phi4", "mixed", remat=False)
    jr_on, tr_on = _runs("phi4", "mixed", remat=True)
    # the ops outside the plan inherit the global flag
    assert tbuild(tr_on, _plans("mixed", (True,) * 4)[1]).model.remat is True
    assert tbuild(tr, _plans("mixed", (False,) * 4)[1]).model.remat is False
    for (jrun, trun), bits in (((jr, tr), (True, False, True, False)),
                               ((jr, tr), (True,) * 4),
                               ((jr_on, tr_on), (False,) * 4)):
        jplan, tplan = _plans("mixed", bits)
        got = tbuild(trun, tplan).model.remat
        assert isinstance(got, tuple) and got
        assert got == jbuild(jrun, jplan).model.remat


# --- the loop and the launcher -------------------------------------------------

def test_cpu_training_step_launches_no_kernel():
    _, tr = _runs("qwen", seq=32, batch=2)
    tb = tbuild(tr)
    toks = torch.zeros((2, 33), dtype=torch.int32)
    ops.reset_launch_counts()
    loss_and_grads(tb.model, tb.init(0, "cpu"), {"tokens": toks[:, :-1],
                                                 "labels": toks[:, 1:]})
    assert set(ops.launch_counts().values()) == {0}


def test_hybrid_training_is_refused():
    """The SSM family trains; the hybrid family (hymba) is refused with
    its family named, when the model is built."""
    _, tr = _runs("qwen", seq=32, batch=2)
    run = dataclasses.replace(tr, model=treduced(tget_arch("hymba-1.5b")))
    with pytest.raises(NotImplementedError, match="family 'hybrid'"):
        tbuild(run)


def test_train_refuses_checkpoints(tmp_path):
    """`train` refuses to restore a checkpoint it cannot trust (the
    whole checkpoint path is tests/test_torch_checkpoint.py): a leaf
    whose bytes fail the manifest's CRC32 stops the run."""
    _, tr = _runs("qwen")
    built = tbuild(tr)
    ttrain(built, 1, device="cpu", ckpt_dir=str(tmp_path), log_every=0)
    leaf = tmp_path / "step_00000001" / "__0__embed__tok.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0x01
    leaf.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorruptError, match="CRC32"):
        ttrain(built, 1, device="cpu", ckpt_dir=str(tmp_path))


def test_launcher_trains_on_cpu(capsys):
    rc = tlaunch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--cpu",
                       "--steps", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "plan[qwen1.5-0.5b-smoke x train_4k]" in out
    assert "device cpu" in out and "done: 3 steps" in out


def test_launcher_trains_mamba_on_cpu(capsys):
    """The SSM family through the same launcher (`python -m
    repro_torch.launch.train --arch mamba2-2.7b`)."""
    rc = tlaunch.main(["--arch", "mamba2-2.7b", "--reduced", "--cpu",
                       "--steps", "3"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "plan[mamba2-2.7b-smoke x train_4k]" in out
    assert "device cpu" in out and "done: 3 steps" in out


def test_launcher_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps",
                      "1"])
