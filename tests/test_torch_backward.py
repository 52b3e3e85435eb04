"""The port's backward against `jax.grad` of the JAX package.

On the CPU the kernels' plain versions run (`kernels/ref.py`): here
they are held against `jax.grad` of the JAX model path's jnp twins,
`models/attention.py::flash_attention` and `x @ w`
(`sharding/specs.py::seg_matmul`), with inputs from numpy.
`chip_smoke.py` holds the CUDA kernels against the same plain versions
on the card.  Also: the differentiable forms (`ops.matmul`,
`ops.attention`), gradients through `seg_matmul`'s sum and concat
variants, and the step-1 loss and every gradient leaf of reduced
qwen1.5-0.5b and phi4-mini under a DP-only and a mixed DP/ZDP plan and
of reduced mamba2-2.7b under global remat,
against `jax.value_and_grad(model.loss_fn)` on the same weights and
batch.  (The backward layouts' launch plans are checked in
tests/test_torch_split_plan.py.)

Every tensor is small: reduced configs (2 layers, d <= 256, vocab
<= 512), seq <= 64.  No test builds or loads the CUDA library.

Tolerances.  Kernel arithmetic, float32 inputs: 1e-4 of the largest
gradient entry (the recompute-from-logsumexp backward and autodiff of
the online softmax sum in other orders; measured about 1e-6).  bfloat16
inputs: 2e-2 of the largest entry plus 2e-2 relative (one bf16 ulp of
an O(1) result, as `tests/test_torch_kernels.py`), compared in fp32 on
the same bf16 inputs.  Whole model, float32 weights: every leaf within
1e-3 of its norm (||port - jax|| / ||jax||; the same algorithm with sums
in other orders, measured 1.5e-6 to 2.5e-5) and the loss within 1e-5
relative.  Whole model, bfloat16 weights (the model's own dtype): the
two frameworks round activations and gradients to bf16 at different
places, so each leaf is held to twice the reference's own rounding
noise, ||port - jax_bf16|| <= 2 ||jax_bf16 - jax_f32|| (measured at most
1.04x), and the loss within 2e-3 relative.
"""
import dataclasses
from functools import lru_cache
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
from repro.models import attention as jattn
from repro.models.registry import build_model as jbuild
from repro.sharding import specs as jspecs
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core.cost_model import Decision as TDecision
from repro_torch.kernels import ops, ref
from repro_torch.models.registry import build_model as tbuild
from repro_torch.sharding import specs as tspecs
from repro_torch.train.loop import loss_and_grads

# (B, S, T, KV, G, hd, causal, window, q_offset): causal and window,
# G 1 and 3, hd 64 and 128, ragged S (not a multiple of the 512-row
# block of the plain version), T > S with an offset, non-causal
FLASH_CASES = [
    (1, 40, 40, 2, 1, 64, True, 0, 0),
    (2, 37, 37, 2, 3, 128, True, 0, 0),
    (1, 50, 50, 1, 3, 64, True, 16, 0),
    (1, 33, 33, 2, 1, 128, True, 9, 0),
    (1, 20, 45, 1, 3, 64, True, 0, 25),
    (2, 21, 30, 2, 1, 64, False, 0, 0),
]
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-3}
F32_LEAF_TOL = 1e-3
BF16_NOISE_FACTOR = 2.0


def _rand(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _f32(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, dtype, what):
    want = _np(want)
    top = np.abs(want).max()
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(_np(got), want,
                               rtol=0 if dtype == "float32" else tol,
                               atol=tol * top, err_msg=what)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# --- flash_attention ---------------------------------------------------------

@lru_cache(maxsize=None)
def _flash_inputs(case, dtype, seed=0):
    B, S, T, KV, G, hd = case[:6]
    rng = np.random.default_rng(seed + S + T + hd)
    return (_rand(rng, (B, S, KV, G, hd), dtype),
            _rand(rng, (B, T, KV, hd), dtype),
            _rand(rng, (B, T, KV, hd), dtype),
            _rand(rng, (B, S, KV, G, hd), dtype))


@lru_cache(maxsize=None)
def _jax_flash_grads(case, dtype, seed=0):
    """jax.grad of sum(flash(q, k, v) * do), in fp32 on the inputs'
    values (the jnp twin of the Pallas kernel)."""
    causal, window, q_offset = case[6:]
    q, k, v, do = _flash_inputs(case, dtype, seed)

    def f(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
        return jnp.sum(o * _f32(do))
    return jax.jit(jax.grad(f, argnums=(0, 1, 2)))(_f32(q), _f32(k),
                                                   _f32(v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_bwd_ref_matches_jax_grad(case, dtype):
    causal, window, q_offset = case[6:]
    want = _jax_flash_grads(case, dtype)
    tq, tk, tv, tdo = (to_torch(a, "cpu")
                       for a in _flash_inputs(case, dtype))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    # the arithmetic of the CUDA backward, in fp32 on the same values
    qf, kf, vf, dof = (t.float() for t in (tq, tk, tv, tdo))
    o, lse = ref.flash_attention_ref(qf, kf, vf, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(qf, kf, vf, o, lse, dof, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, "float32", f"{name} {case}")
    # and in the inputs' dtype, as the model path calls it
    o, lse = ops.flash_attention(tq, tk, tv, return_lse=True, **kw)
    assert o.dtype == tq.dtype and lse.dtype == torch.float32
    got = ops.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, w, t in zip(("dq", "dk", "dv"), got, want, (tq, tk, tv)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _close(g, w, dtype, f"{name} {case}")


@pytest.mark.parametrize("case", FLASH_CASES[:4], ids=str)
def test_flash_autograd_matches_jax_grad(case):
    """torch autograd through the plain blockwise forward, and the
    differentiable form `ops.attention` (whose backward is the plain
    backward here), against jax.grad of the jnp twin, in fp32."""
    causal, window, q_offset = case[6:]
    q, k, v, do = _flash_inputs(case, "float32")
    want = _jax_flash_grads(case, "float32")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    for route in ("autograd", "function"):
        ts = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (q, k, v)]
        fn = ref.flash_attention_ref if route == "autograd" \
            else ops.attention
        (fn(*ts, **kw) * torch.from_numpy(do)).sum().backward()
        for name, t, w in zip(("dq", "dk", "dv"), ts, want):
            _close(t.grad, w, "float32", f"{route} {name} {case}")


def test_flash_lse_is_the_rows_logsumexp():
    case = FLASH_CASES[2]
    q, k, v, _ = _flash_inputs(case, "float32")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = ref.flash_attention_ref(tq, tk, tv, causal=True, window=16,
                                     return_lse=True, bq=16, bk=8)
    s = torch.einsum("bqkgh,btkh->bqkgt", tq, tk) / 8.0
    pos = torch.arange(q.shape[1])
    msk = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < 16)
    s = s.masked_fill(~msk[None, :, None, None, :], float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-5)


# --- split_matmul ------------------------------------------------------------

@pytest.mark.parametrize("transpose_w", [False, True], ids=["w", "wT"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(48, 64, 40), (100, 72, 136)])
def test_split_matmul_grads_match_jax_grad(m, k, n, dtype, transpose_w):
    """dgrad and wgrad (the "nt"/"tn" layouts, or "nn"/"tn" for a weight
    the forward reads transposed) against jax.grad of x @ w, with the
    K-slice sum of the plain versions and the split-K order of the
    plans; and the differentiable form's autograd."""
    rng = np.random.default_rng(m + n)
    x = _rand(rng, (m, k), dtype)
    w = _rand(rng, (n, k) if transpose_w else (k, n), dtype, k ** -0.5)
    dy = _rand(rng, (m, n), dtype)

    def f(x, w):
        return jnp.sum((x @ (w.T if transpose_w else w)) * _f32(dy))
    jdx, jdw = jax.grad(f, argnums=(0, 1))(_f32(x), _f32(w))
    tx, tw, tdy = (to_torch(a, "cpu") for a in (x, w, dy))
    dx = ops.split_matmul_dgrad(tdy, tw, transpose_w=transpose_w)
    dw = ops.split_matmul_wgrad(tx, tdy, transpose_w=transpose_w)
    assert dx.shape == tx.shape and dx.dtype == tx.dtype
    assert dw.shape == tw.shape and dw.dtype == tw.dtype
    _close(dx, jdx, dtype, "dx")
    _close(dw, jdw, dtype, "dw")
    # the contracted dimension in slices of 32, as the forward's bk
    _close(ref.split_matmul_dgrad_ref(tdy, tw, transpose_w=transpose_w,
                                      bk=32), jdx, dtype, "dx, 32-slices")
    _close(ref.split_matmul_wgrad_ref(tx, tdy, transpose_w=transpose_w,
                                      bk=32), jdw, dtype, "dw, 32-slices")
    # the split-K order of the plans, on views ("tn": x^T or dy^T)
    ranges = [(0, 32), (32, m)]
    got = ref.split_matmul_splitk_ref(tdy.t(), tx, 32, ranges) \
        if transpose_w else ref.split_matmul_splitk_ref(tx.t(), tdy, 32,
                                                        ranges)
    _close(got, jdw, dtype, "dw split-K")
    ax, aw = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    y = ops.matmul(ax, aw, transpose_w=transpose_w)
    (y.float() * tdy.float()).sum().backward()
    torch.testing.assert_close(ax.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(aw.grad, dw, rtol=0, atol=0)


# --- seg_matmul's mixed segments ---------------------------------------------

# phi4 keeps GQA (4 q heads on 2 kv heads); qwen1.5 brings the QKV bias
# and tied embeddings; qwen_pad a vocabulary the padding multiple does
# not divide (500 -> 512), so the head's padded columns are masked
ARCHS = {"phi4": ("phi4-mini-3.8b", dict(n_kv_heads=2)),
         "qwen": ("qwen1.5-0.5b", {}),
         "qwen_pad": ("qwen1.5-0.5b", dict(vocab_size=500)),
         # chunk 32: the scan's state gradient crosses two chunks
         "mamba": ("mamba2-2.7b", dict(ssm_chunk=32))}
MIXED_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
             "layers.ffn_w2", "head.out")
MIXED = ("DP", "ZDP", "DP", "ZDP")
SEQ, BATCH = 64, 2


def _train_runs(name, plan):
    """Both packages' reduced run configs at seq 64, batch 2, OSDP off
    (the decisions come from `_plans`): the default global remat for
    DP-only, none for the mixed plan."""
    arch, kw = ARCHS[name]
    ck = plan == "dp"
    jr = JRun(model=jreduced(jget_arch(arch), **kw),
              shape=jget_shape("train_4k"),
              mesh=JMesh((1, 1), ("data", "model")),
              osdp=JOSDP(enabled=False, checkpointing=ck))
    tr = TRun(model=treduced(tget_arch(arch), **kw),
              shape=tget_shape("train_4k"),
              mesh=TMesh((1, 1), ("data", "model")),
              osdp=TOSDP(enabled=False, checkpointing=ck))
    cut = lambda r: dataclasses.replace(r, shape=dataclasses.replace(
        r.shape, seq_len=SEQ, global_batch=BATCH))
    return cut(jr), cut(tr)


def _plans(plan):
    if plan == "dp":
        return None, None
    return (SimpleNamespace(decisions={op: JDecision(op, MIXED)
                                       for op in MIXED_OPS}),
            SimpleNamespace(decisions={op: TDecision(op, MIXED)
                                       for op in MIXED_OPS}))


@lru_cache(maxsize=None)
def _pair(name, plan, dtype):
    jr, tr = _train_runs(name, plan)
    jplan, tplan = _plans(plan)
    jb, tb = jbuild(jr, jplan), tbuild(tr, tplan)
    jp = jb.init(jax.random.PRNGKey(0))
    if dtype == "float32":
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
    return jb, jp, tb


def _tparams(jp):
    return params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                           device="cpu")


# (weight path, variant): an input-dim split sums its segments' partial
# products, an output-dim split concatenates them
SEG_PATHS = [("layers/attn/wq", "sum"), ("layers/attn/wo", "concat"),
             ("layers/ffn/w13", "sum"), ("layers/ffn/w2", "concat"),
             ("head/out", "sum")]


@pytest.mark.parametrize("path,variant", SEG_PATHS)
def test_seg_matmul_grads_match_jax_grad(path, variant):
    """Gradients through `seg_matmul` of the mixed plan (4 segments a
    weight), x and every segment leaf, against jax.grad of the JAX
    `seg_matmul` on the same segment weights (layer 0 of the stacked
    ones), in fp32."""
    jb, jp, tb = _pair("phi4", "mixed", "float32")
    segs = tb.model.pset.segments(path)
    assert len(segs) == 4
    spec = tb.model.pset.layouts[path].spec
    zdp_local = spec.zdp_axis - (1 if spec.stacked else 0)
    assert (zdp_local == 0) == (variant == "sum")
    leaves = {leaf: np.asarray(jp[leaf][0] if spec.stacked else jp[leaf])
              for leaf, _ in segs}
    K = sum(v.shape[0] for v in leaves.values()) if variant == "sum" \
        else next(iter(leaves.values())).shape[0]
    rng = np.random.default_rng(len(path))
    x = _rand(rng, (2, 5, K), "float32")
    y_shape = jspecs.seg_matmul(_f32(x), {k: _f32(v) for k, v in
                                          leaves.items()},
                                jb.pset_abstract, path, 0).shape
    dy = _rand(rng, y_shape, "float32")

    def f(x, ws):
        return jnp.sum(jspecs.seg_matmul(x, ws, jb.pset_abstract, path, 0)
                       * _f32(dy))
    jdx, jdw = jax.grad(f, argnums=(0, 1))(
        _f32(x), {k: _f32(v) for k, v in leaves.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in leaves.items()}
    y = tspecs.seg_matmul(tx, tw, tb.model.pset, path, 0)
    assert tuple(y.shape) == tuple(y_shape)
    (y * torch.from_numpy(dy)).sum().backward()
    _close(tx.grad, jdx, "float32", f"{path} dx")
    for leaf in leaves:
        _close(tw[leaf].grad, jdw[leaf], "float32", f"{leaf} dw")


# --- counters --------------------------------------------------------------

def test_launch_counts_name_the_backward_kernels():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {
        "split_matmul": 0, "split_matmul_acc": 0, "split_matmul_dgrad": 0,
        "split_matmul_wgrad": 0, "flash_attention": 0,
        "flash_attention_bwd": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
    assert ops.split_matmul_layout_counts() == {"nn": 0, "nt": 0, "tn": 0}


# --- the whole model: step-1 loss and gradients --------------------------------

def _batch(cfg, seed=0, seq=SEQ, batch=BATCH):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())})


@lru_cache(maxsize=None)
def _jax_grads(name, plan, dtype):
    jb, jp, tb = _pair(name, plan, dtype)
    jbatch, _ = _batch(tb.model.cfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jb.model.loss_fn, has_aux=True))(jp, jbatch)
    return float(loss), {k: np.asarray(v, np.float32)
                         for k, v in grads.items()}


def _check_step1_grads(name, plan, dtype):
    jb, jp, tb = _pair(name, plan, dtype)
    model = tb.model
    assert model.remat is (plan == "dp") and jb.model.remat is model.remat
    jloss, jgrads = _jax_grads(name, plan, dtype)
    tp = _tparams(jp)
    _, tbatch = _batch(model.cfg)
    loss, metrics, grads = loss_and_grads(model, tp, tbatch)
    assert abs(float(loss) - jloss) <= LOSS_TOL[dtype] * abs(jloss)
    assert float(metrics["tokens"]) == SEQ * BATCH
    assert set(grads) == set(jgrads)
    exact = _jax_grads(name, plan, "float32")[1]
    for k, g in grads.items():
        assert g.dtype == tp[k].dtype and g.shape == tp[k].shape, k
        rel = _rel(g.float().numpy(), jgrads[k])
        tol = (F32_LEAF_TOL if dtype == "float32" else
               BF16_NOISE_FACTOR * _rel(jgrads[k], exact[k]))
        assert rel <= tol, f"{k}: |d| / |g| = {rel:.3g} > {tol:.3g}"
    return tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan", ["dp", "mixed"])
@pytest.mark.parametrize("name", ["qwen", "phi4"])
def test_step1_grads_match_jax(name, plan, dtype):
    """DP-only (full remat) and the mixed DP/ZDP plan (remat off; the
    sum and concat variants in every layer and the head)."""
    _check_step1_grads(name, plan, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_step1_grads_match_jax(dtype):
    """Reduced mamba2-2.7b under global remat: the SSD block's chunk
    scan differentiated through `ops.ssd` (`ref.ssd_scan_bwd_ref` on
    the CPU) against jax.grad of the JAX jnp scan, every leaf (A_log,
    dt_bias, D, the conv and both projections) included."""
    _check_step1_grads("mamba", "dp", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_vocab_grads_match_jax(dtype):
    """The masked padded-vocab columns of the tied head: the same loss
    and gradients as JAX's, whose padded logits are -1e30."""
    tp = _check_step1_grads("qwen_pad", "dp", dtype)
    _, _, tb = _pair("qwen_pad", "dp", dtype)
    cfg = tb.model.cfg
    assert cfg.padded_vocab == 512 > cfg.vocab_size == 500
    _, batch = _batch(cfg)
    with torch.no_grad():
        x, _ = tb.model.forward(tp, batch)
        logits = tb.model.logits(tp, x)
    assert (logits[..., cfg.vocab_size:] < -1e29).all()
    assert (logits[..., :cfg.vocab_size] > -1e29).all()
