"""Selective per-slice remat in the port against the JAX package.

- Each plan slice's remat bit resolved per segment (`Segment.remat`),
  `saved_activation_names` and `_remat_policy` (`Model.remat`) equal to
  the JAX package's on the same plans: all keep, all remat, inherited
  bits under either global flag, keep only the embedding (the searched
  plans' shape), a mixed plan, the sum variant (an input-dim split whose
  slices all keep: only the whole output is named) and the concat
  variant (an output-dim split: per-leaf names); and on the plans the
  port's own planner searches for qwen1.5-0.5b on one H100 at full
  width (no tensor built).
- The compiled policy run: a selective plan's step-1 loss and gradients
  against `jax.value_and_grad` of the JAX model under its
  `save_only_these_names` policy, and three steps against its
  `make_train_step`; `ops.product_counts` shows what was recomputed (a
  kept product computed once a layer, a recomputed one twice); a
  policy whose names tag nothing in the layer (the searched plans')
  gives the full checkpoint's losses and gradients bit for bit, with
  the same recomputation.

Every tensor is small: reduced qwen1.5-0.5b (2 layers, d 256, d_ff 256,
vocab 512), seq 64, batch 4; the full-width plans are planned, never
built.  No test builds or loads the CUDA library.

Tolerances: those of tests/test_torch_backward.py (float32 weights:
the loss within 1e-5 relative, every gradient leaf within 1e-3 of its
norm) and tests/test_torch_train.py (three steps: losses within 1e-4
relative in float32 and 5e-3 in bfloat16; grad norms within 1e-5 at
step 1 and 1e-2 at every step in float32, 3e-2 in bfloat16).  The
embed-only policy against the full checkpoint: bit for bit (the same
arithmetic in the same order).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DeviceInfo as JDevice
from repro.configs import MeshConfig as JMesh
from repro.configs import OSDPConfig as JOSDP
from repro.configs import RunConfig as JRun
from repro.configs import get_arch as jget_arch
from repro.configs import get_shape as jget_shape
from repro.configs import reduced as jreduced
from repro.core.api import osdp as josdp
from repro.core.cost_model import Decision as JDecision
from repro.data.synthetic import Dataset as JDataset
from repro.models.registry import build_model as jbuild
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_state as jinit_state
from repro.sharding.specs import saved_activation_names as jsaved
from repro.train.loop import make_train_step as jmake_train_step
from repro_torch.configs import DeviceInfo as TDevice
from repro_torch.configs import MeshConfig as TMesh
from repro_torch.configs import OSDPConfig as TOSDP
from repro_torch.configs import RunConfig as TRun
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import get_shape as tget_shape
from repro_torch.configs import reduced as treduced
from repro_torch.convert import params_from_jax
from repro_torch.core.api import osdp as tosdp
from repro_torch.core.cost_model import Decision as TDecision
from repro_torch.kernels import ops
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import AdamWConfig
from repro_torch.sharding.specs import saved_activation_names as tsaved
from repro_torch.train.loop import loss_and_grads
from repro_torch.train.loop import train as ttrain

MIXED = ("DP", "ZDP", "DP", "ZDP")
LAYER_OPS = ("layers.attn_qkv", "layers.attn_out", "layers.ffn_w13",
             "layers.ffn_w2")
K, R, I = False, True, None     # keep, recompute, inherit

# name -> (global checkpointing flag, {op: (modes, remat bits)})
PLANS = {
    # the ops outside the plan (embedding, norms) inherit the flag
    "all_keep": (False, {op: (MIXED, (K,) * 4) for op in LAYER_OPS}),
    "all_remat": (True, {op: (MIXED, (R,) * 4) for op in LAYER_OPS}),
    "inherit_on": (True, {op: (MIXED, (I, K, I, K)) for op in LAYER_OPS}),
    "inherit_off": (False, {op: (("DP",), (I,)) for op in LAYER_OPS}),
    "embed_only": (False, dict({"embed.tok": (("DP",), (K,))},
                               **{op: (("DP",), (R,)) for op in LAYER_OPS})),
    "mixed": (False, {"layers.attn_qkv": (("DP",), (K,)),
                      "layers.attn_out": (("DP",), (R,)),
                      "layers.ffn_w13": (("DP",), (R,)),
                      "layers.ffn_w2": (("DP",), (K,))}),
    # w13 split over its input dim (d): the sum of its four segments
    "sum": (False, {"layers.ffn_w13": (MIXED, (K,) * 4),
                    "layers.attn_qkv": (MIXED, (K, R, K, K)),
                    "layers.attn_out": (("DP",), (R,)),
                    "layers.ffn_w2": (("DP",), (R,))}),
    # w2 and wo split over their output dim: the concatenation
    "concat": (False, {"layers.ffn_w2": (MIXED, (K, R, K, R)),
                       "layers.attn_out": (MIXED, (R, K, R, R)),
                       "layers.attn_qkv": (("DP",), (R,)),
                       "layers.ffn_w13": (("DP",), (R,))}),
}


def _runs(flag, seq=64, batch=4):
    out = []
    for Run, Mesh, OSDP, get_arch, get_shape, reduced in (
            (JRun, JMesh, JOSDP, jget_arch, jget_shape, jreduced),
            (TRun, TMesh, TOSDP, tget_arch, tget_shape, treduced)):
        shape = dataclasses.replace(get_shape("train_4k"), seq_len=seq,
                                    global_batch=batch)
        out.append(Run(model=reduced(get_arch("qwen1.5-0.5b")), shape=shape,
                       mesh=Mesh((1, 1), ("data", "model")),
                       osdp=OSDP(enabled=False, checkpointing=flag)))
    return out


def _built(name, **kw):
    flag, ops_ = PLANS[name]
    jr, tr = _runs(flag, **kw)
    plans = [SimpleNamespace(decisions={op: D(op, m, r)
                                        for op, (m, r) in ops_.items()})
             for D in (JDecision, TDecision)]
    return jbuild(jr, plans[0]), tbuild(tr, plans[1])


# --- the compiled policy ---------------------------------------------------------

@pytest.mark.parametrize("name", list(PLANS))
def test_policy_matches_jax(name):
    jb, tb = _built(name)
    jlay, tlay = jb.pset_abstract.layouts, tb.model.pset.layouts
    assert sorted(jlay) == sorted(tlay)
    for path in jlay:
        assert [(s.key, s.size, s.remat) for s in tlay[path].segments] == \
            [(s.key, s.size, s.remat) for s in jlay[path].segments], path
    for default in (False, True):
        assert tsaved(tlay, default) == jsaved(jlay, default)
    assert tb.model.remat == jb.model.remat
    want = {"all_keep": False, "all_remat": True, "inherit_off": False}
    if name in want:
        assert tb.model.remat is want[name]
    else:
        assert isinstance(tb.model.remat, tuple) and tb.model.remat


def test_sum_and_concat_names():
    """The sum variant names only the whole output (kept when every
    segment keeps); the concat variant names each kept leaf."""
    saved = _built("sum")[1].model.remat
    assert {"layers/ffn/w13", "layers/ffn/w13@0"} <= set(saved)
    assert "layers/attn/wq" not in saved and "layers/attn/wq@0" in saved
    saved = _built("concat")[1].model.remat
    assert {"layers/ffn/w2@0", "layers/ffn/w2@2",
            "layers/attn/wo@1"} <= set(saved)
    assert not {"layers/ffn/w2", "layers/ffn/w2@1",
                "layers/attn/wo"} & set(saved)


@pytest.mark.parametrize("gib", [20.0, 64.0])
def test_searched_full_width_plans_compile_like_jax(gib):
    """qwen1.5-0.5b, train_4k at batch 8, one h100-sxm, selective
    checkpointing: below 25 GiB the searcher keeps the embedding and
    recomputes every layer op, which compiles to names that tag nothing
    in the layer body (full recomputation, as in the JAX package); at
    64 GiB nothing remats."""
    outs = []
    for osdp_, Dev, get_arch, get_shape, Mesh, Run, build in (
            (josdp, JDevice, jget_arch, jget_shape, JMesh, JRun, jbuild),
            (tosdp, TDevice, tget_arch, tget_shape, TMesh, TRun, tbuild)):
        cfg = get_arch("qwen1.5-0.5b")
        shape = dataclasses.replace(get_shape("train_4k"), global_batch=8)
        mesh = Mesh((1, 1), ("data", "model"))
        plan = osdp_(cfg, shape, mesh, memory_limit_gib=gib,
                     device=Dev.preset("h100-sxm"),
                     checkpointing="selective")
        run = Run(model=cfg, shape=shape, mesh=mesh, osdp=plan.run.osdp)
        outs.append((build(run, plan).model, plan))
    (jm, jplan), (tm, tplan) = outs
    assert tm.remat == jm.remat
    assert tm._split_g("layers.ffn_w13") == jm._split_g("layers.ffn_w13") \
        == 4
    if gib == 64.0:
        assert tm.remat is False
        return
    assert "embed/tok" in tm.remat
    assert not any(n.startswith(("layers/attn/w", "layers/ffn/w"))
                   for n in tm.remat)
    assert all(tplan.decisions[op].remat == (True,) * 4 for op in LAYER_OPS)


# --- the policy run ---------------------------------------------------------------

def _batch(seed=0, seq=64, batch=4):
    toks = np.random.default_rng(seed).integers(0, 512, (batch, seq + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _start(jb, dtype="float32"):
    jp = {k: v.astype(dtype) for k, v in
          jb.init(jax.random.PRNGKey(0)).items()}
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               device="cpu")


@pytest.mark.parametrize("name", ["mixed", "sum", "concat"])
def test_selective_step1_matches_jax(name):
    """Loss and every gradient leaf (float32) against the JAX model under
    its own selective policy; each kept tag is computed once a layer,
    each other tag of the layer twice (again in the backward)."""
    jb, tb = _built(name)
    saved = tb.model.remat
    assert jb.model.remat == saved and isinstance(saved, tuple)
    jp, tp = _start(jb)
    toks, labs = _batch()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jb.model.loss_fn, has_aux=True))(jp, {"tokens": jnp.asarray(toks),
                                              "labels": jnp.asarray(labs)})
    ops.reset_launch_counts()
    loss, _, grads = loss_and_grads(tb.model, tp, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)})
    counts = dict(ops.product_counts)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for k, g in jgrads.items():
        g = np.asarray(g, np.float32)
        rel = np.linalg.norm(grads[k].float().numpy() - g) / np.linalg.norm(g)
        assert rel <= 1e-3, k
    L = tb.model.cfg.n_layers
    assert counts, "no tagged product ran"
    for tag, n in counts.items():
        assert n == (L if tag in saved else 2 * L), (tag, n)
    assert any(n == L for n in counts.values())
    assert any(n == 2 * L for n in counts.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_three_steps_match_jax_make_train_step(dtype):
    jb, tb = _built("mixed")
    sched = dict(warmup=2, total_steps=10)
    jstep, _ = jmake_train_step(jb, JAdamWConfig(lr=1e-3), donate=False,
                                **sched)
    jp, start = _start(jb, dtype)
    jst = jinit_state(jp)
    ds = JDataset(jb.run.model, jb.run.shape, seed=0)
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


def test_untagged_names_recompute_like_full_remat():
    """The searched plans' policy (names that tag no product of the
    layer) and the full checkpoint: the same loss and gradients bit for
    bit, and every tagged product computed twice a layer by both."""
    _, tb = _built("embed_only")
    # the embedding and the norms (which inherit "keep") are named;
    # neither is a product of the layer body
    assert tb.model.remat == ("embed/tok", "final_norm/scale",
                              "layers/attn/norm_scale",
                              "layers/ffn/norm_scale")
    toks, labs = _batch(3)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)}
    params = tb.init(0, "cpu")
    runs = []
    for remat in (tb.model.remat, True):
        model = dataclasses.replace(tb.model, remat=remat)
        ops.reset_launch_counts()
        loss, _, grads = loss_and_grads(model, params, batch)
        runs.append((loss, grads, dict(ops.product_counts)))
    (l1, g1, c1), (l2, g2, c2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert c1 == c2 and set(c1.values()) == {2 * tb.model.cfg.n_layers}
