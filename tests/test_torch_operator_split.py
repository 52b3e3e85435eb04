"""The port's operator splitting (`core/operator_split.py`) against the
JAX package's.

- `chunked_matmul` and `chunked_ffn` against `repro.core.operator_split`
  on the same numpy inputs, in float32 and bfloat16, at g = 1, at a g
  that divides the split dimension and at one that does not (both
  packages then take the plain product / FFN);
- the accumulating product `ops.matmul_acc` (the plain version of
  `split_matmul(..., acc=)`), its gradients, and `chunked_ffn`'s
  gradients against `jax.grad` of the JAX `chunked_ffn`; the cotangent
  that reaches the fp32 accumulator is exactly a bf16 value;
- the model path: a plan's uniform split of the FFN runs `chunked_ffn`
  with the plan's g (as the JAX package's `Model._split_g`), and three
  training steps of reduced qwen1.5-0.5b under a uniform split-4 plan
  against the JAX package's `make_train_step`, which runs its
  `chunked_ffn`.

Every tensor is small: x at most (2, 16, 48), reduced configs (2
layers, d 256, d_ff 256, vocab 512), seq 64, batch 4.  No test builds
or loads the CUDA library.

Tolerances.  float32: outputs within 1e-5 of the largest entry (the
same fp32 products summed in other orders, measured below 1e-6), and
gradients within 1e-4 of the largest entry, as
tests/test_torch_backward.py.  bfloat16: both sides round each
chunk's hidden to bf16 and sum the chunks in fp32, so outputs are held
to one bf16 ulp, 2e-2 of the largest entry plus 2e-2 relative (as
tests/test_torch_kernels.py), and gradients, which the two frameworks
round at different places, to twice the reference's own rounding noise,
||port - jax_bf16|| <= 2 ||jax_bf16 - jax_f32|| (as the whole-model
bfloat16 checks of tests/test_torch_backward.py).  Training steps: the
bounds of tests/test_torch_train.py (losses within 1e-4 relative in
float32, 5e-3 in bfloat16; grad norms 1e-5 at step 1 and 1e-2 at every
step in float32, 3e-2 in bfloat16).
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
from repro.core import operator_split as jsplit
from repro.core.cost_model import Decision as JDecision
from repro.data.synthetic import Dataset as JDataset
from repro.models.registry import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_state as jinit_state
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch import core as tcore
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import operator_split as tsplit
from repro_torch.core.cost_model import Decision as TDecision
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import train as ttrain

NP_DTYPE = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
SPLIT_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
             "layers.ffn_w2")


def _rand(rng, shape, dtype, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(NP_DTYPE[dtype])


def _f32(a):
    return np.asarray(a, np.float32)


def _np(t):
    return t.detach().float().numpy()


def _close_out(got, want, dtype):
    got, want = _f32(got), _f32(want)
    top = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)
    else:
        assert (np.abs(got - want) <= 2e-2 * top + 2e-2 * np.abs(want)).all()


def _ffn_inputs(act, dtype, seed=0, d=32, ff=48):
    rng = np.random.default_rng(seed)
    two = 2 if act == "swiglu" else 1
    return (_rand(rng, (2, 16, d), dtype),
            _rand(rng, (d, two * ff), dtype, d ** -0.5),
            _rand(rng, (ff, d), dtype, ff ** -0.5))


# --- forward against the JAX package ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4, 5], ids=["g1", "g4", "g5_ragged"])
def test_chunked_matmul_matches_jax(g, dtype):
    """K = 48: g 4 slices it, g 5 does not divide it (one product)."""
    rng = np.random.default_rng(g)
    x, w = _rand(rng, (2, 12, 48), dtype), _rand(rng, (48, 40), dtype,
                                                 48 ** -0.5)
    want = jsplit.chunked_matmul(jnp.asarray(x), jnp.asarray(w), g)
    got = tsplit.chunked_matmul(to_torch(x, "cpu"), to_torch(w, "cpu"), g)
    assert str(got.dtype).removeprefix("torch.") == dtype
    assert tuple(got.shape) == want.shape == (2, 12, 40)
    _close_out(_np(got), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("g", [1, 4, 5], ids=["g1", "g4", "g5_ragged"])
def test_chunked_ffn_matches_jax(g, act, dtype):
    """ff = 48: g 4 chunks it (c = 12), g 5 does not divide it."""
    x, w13, w2 = _ffn_inputs(act, dtype, seed=g)
    want = jsplit.chunked_ffn(jnp.asarray(x), jnp.asarray(w13),
                              jnp.asarray(w2), g, act)
    got = tsplit.chunked_ffn(*(to_torch(a, "cpu") for a in (x, w13, w2)),
                             g, act)
    assert str(got.dtype).removeprefix("torch.") == dtype
    assert tuple(got.shape) == want.shape == x.shape
    _close_out(_np(got), want, dtype)


def test_core_exports_the_split_ops():
    assert tcore.chunked_ffn is tsplit.chunked_ffn
    assert tcore.chunked_matmul is tsplit.chunked_matmul


# --- the accumulating product -------------------------------------------------

@pytest.mark.parametrize("k", [40, 1100], ids=["one_slice", "k_slices"])
def test_matmul_acc_is_acc_plus_the_fp32_product(k):
    """On the CPU `ops.matmul_acc` is the plain version: acc + the fp32
    sum over 512-wide K slices (the kernel's schedule), not cast; it
    launches nothing."""
    rng = np.random.default_rng(k)
    x = to_torch(_rand(rng, (24, k), "bfloat16"), "cpu")
    w = to_torch(_rand(rng, (k, 16), "bfloat16", k ** -0.5), "cpu")
    acc = torch.from_numpy(_rand(rng, (24, 16), "float32"))
    ops.reset_launch_counts()
    got = ops.matmul_acc(x, w, acc)
    assert got.dtype == torch.float32
    xf, wf = x.float(), w.float()
    prod = sum(xf[:, s:s + 512] @ wf[s:s + 512] for s in range(0, k, 512))
    assert torch.equal(got, acc + prod)
    assert torch.equal(got, ref.split_matmul_ref(x, w, bk=512, acc=acc))
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_acc_grads(dtype):
    """acc's gradient is the cotangent itself; x's and w's are the plain
    product's gradients of the cotangent cast to x's dtype."""
    rng = np.random.default_rng(7)
    x = to_torch(_rand(rng, (20, 36), dtype), "cpu").requires_grad_()
    w = to_torch(_rand(rng, (36, 24), dtype, 36 ** -0.5),
                 "cpu").requires_grad_()
    acc = torch.from_numpy(_rand(rng, (20, 24), "float32")).requires_grad_()
    dy = torch.from_numpy(_rand(rng, (20, 24), dtype).astype(np.float32))
    ops.matmul_acc(x, w, acc).backward(dy)
    assert torch.equal(acc.grad, dy)
    dyc = dy.to(x.dtype)
    assert torch.equal(x.grad, ref.split_matmul_dgrad_ref(dyc, w.detach()))
    assert torch.equal(w.grad, ref.split_matmul_wgrad_ref(x.detach(), dyc))


def _jax_ffn_grads(x, w13, w2, dy, g, act):
    def f(x, w13, w2):
        y = jsplit.chunked_ffn(x, w13, w2, g, act)
        return jnp.sum(y.astype(jnp.float32) * dy)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w13, w2)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("g", [1, 4], ids=["g1", "g4"])
def test_chunked_ffn_grads_match_jax_grad(g, act, dtype):
    x, w13, w2 = _ffn_inputs(act, dtype, seed=10 + g)
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)
    want = _jax_ffn_grads(x, w13, w2, dy, g, act)
    ts = [to_torch(a, "cpu").requires_grad_() for a in (x, w13, w2)]
    y = tsplit.chunked_ffn(*ts, g, act)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    if dtype == "float32":
        for t, wnt, name in zip(ts, want, ("x", "w13", "w2")):
            top = np.abs(_f32(wnt)).max()
            np.testing.assert_allclose(_np(t.grad), _f32(wnt), rtol=0,
                                       atol=1e-4 * top, err_msg=name)
        return
    exact = _jax_ffn_grads(*(a.astype(np.float32) for a in (x, w13, w2)),
                           dy, g, act)
    for t, wnt, e, name in zip(ts, want, exact, ("x", "w13", "w2")):
        noise = np.linalg.norm(_f32(wnt) - _f32(e))
        assert np.linalg.norm(_np(t.grad) - _f32(wnt)) <= 2 * noise, name


def test_acc_cotangent_is_exactly_bf16(monkeypatch):
    """In a bf16 `chunked_ffn` the fp32 cotangent reaching each
    accumulating product is the image of the bf16 output's cotangent,
    so its cast to bf16 for the dgrad / wgrad kernels is exact."""
    seen = []
    backward = ops._MatmulAcc.backward

    def recording(ctx, dy):
        seen.append(dy.clone())
        return backward(ctx, dy)
    monkeypatch.setattr(ops._MatmulAcc, "backward", staticmethod(recording))
    x, w13, w2 = _ffn_inputs("swiglu", "bfloat16", seed=4)
    ts = [to_torch(a, "cpu").requires_grad_() for a in (x, w13, w2)]
    y = tsplit.chunked_ffn(*ts, 4)
    y.backward(torch.randn(y.shape, generator=torch.Generator().manual_seed(
        0)).to(torch.bfloat16))
    assert len(seen) == 4
    for dy in seen:
        assert dy.dtype == torch.float32
        assert torch.equal(dy.to(torch.bfloat16).float(), dy)


# --- the model path -----------------------------------------------------------

def _split_runs(seq=64, batch=4):
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


def _split_plans(g=4):
    """A uniform split of g over the layer ops, every slice DP: the
    plan the searcher returns for qwen1.5-0.5b on one H100."""
    return tuple(SimpleNamespace(decisions={
        op: D(op, ("DP",) * g) for op in SPLIT_OPS})
        for D in (JDecision, TDecision))


def _counting_acc(monkeypatch):
    shapes = []
    plain = ops.split_matmul

    def counting(x, w, **kw):
        if kw.get("acc") is not None:
            shapes.append((tuple(x.shape), tuple(w.shape)))
        return plain(x, w, **kw)
    monkeypatch.setattr(ops, "split_matmul", counting)
    return shapes


def test_uniform_split_runs_the_chunked_ffn(monkeypatch):
    """Under the split-4 plan each layer's FFN adds four chunks of the
    hidden (ff / 4 = 64 wide) into its fp32 accumulator; the weights
    stay one segment each; an unsplit plan runs no accumulating product,
    and neither does serving's prefill under the split plan."""
    jp, tp = _split_plans()
    _, tr = _split_runs()
    tb = tbuild(tr, tp)
    model = tb.model
    assert model._split_g("layers.ffn_w13") == 4
    assert not model.pset.layouts["layers/ffn/w13"].is_split
    jb = jbuild(_split_runs()[0], jp)
    assert jb.model._split_g("layers.ffn_w13") == 4
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 17)).astype(np.int32))
    params = tb.init(0, "cpu")
    for built, want in ((tb, 4 * 2), (tbuild(tr), 0)):
        shapes = _counting_acc(monkeypatch)
        built.model.loss_fn(params, {"tokens": toks[:, :-1],
                                     "labels": toks[:, 1:]})
        assert len(shapes) == want
        assert set(shapes) <= {((32, 64), (64, 256))}
        monkeypatch.undo()
    shapes = _counting_acc(monkeypatch)
    with torch.no_grad():
        model.prefill(params, {"tokens": toks[:, :8]})
    assert shapes == []


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_split4_steps_match_jax_make_train_step(dtype):
    """Reduced qwen1.5-0.5b under the uniform split-4 plan, remat off:
    three steps through the port's `train()` against the JAX
    `make_train_step` (which runs `chunked_ffn` with g 4) on the same
    weights and batches."""
    jr, tr = _split_runs()
    jplan, tplan = _split_plans()
    jb, tb = jbuild(jr, jplan), tbuild(tr, tplan)
    sched = dict(warmup=2, total_steps=10)
    jstep, _ = jmake_train_step(jb, JAdamWConfig(lr=1e-3), donate=False,
                                **sched)
    jp = {k: v.astype(dtype) for k, v in
          jb.init(jax.random.PRNGKey(0)).items()}
    start = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                            device="cpu")
    jst = jinit_state(jp)
    ds = JDataset(jr.model, jr.shape, seed=0)
    jlosses, jnorms = [], []
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in ds.global_batch(s).items()}
        jp, jst, m = jstep(jp, jst, batch)
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    res = ttrain(tb, 3, opt_cfg=AdamWConfig(lr=1e-3), device="cpu",
                 params=start, log_every=0, **sched)
    loss_rtol = {"float32": 1e-4, "bfloat16": 5e-3}[dtype]
    first, every = {"float32": (1e-5, 1e-2), "bfloat16": (3e-2, 3e-2)}[dtype]
    np.testing.assert_allclose(res.losses, jlosses, rtol=loss_rtol)
    np.testing.assert_allclose(res.grad_norms[0], jnorms[0], rtol=first)
    np.testing.assert_allclose(res.grad_norms, jnorms, rtol=every)
