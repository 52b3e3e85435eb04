"""The `split_matmul` launch planner and its split-K summation order.

`repro_torch.kernels.split_matmul.plan_launch` is pure Python: it picks
the CUDA design for a product (weight streaming with split-K for decode
rows, TMA + wgmma for prefill rows, the persistent TMA + wgmma design
for the accumulating form, dgrad and wgrad, the general first-version
kernel only where none can run), its tile and its K split, for each operand
layout: "nn" (the forward, the accumulating form, the tied head's
dgrad), "nt" (dgrad and the tied head's forward) and "tn" (wgrad).  Here
it is checked at every product of the two served models and of the
training steps of qwen1.5-0.5b and mamba2-2.7b, read from their
configurations (mamba2's plans pinned, w_bcdt's 336-wide ragged tiles
and the untied 50432-wide head included), and at
the cases that force the general kernel; the persistent design's walk
over its tiles (`tile_order`, the kernel's `TileOrder`) and its model
of the operands' memory bytes (`operand_bytes`) are checked by
enumeration.  The
order the kernels sum in (fp32 partials over whole K slices, ranges
summed in order) is `ref.split_matmul_splitk_ref`; it is held against
the Pallas `split_matmul` in interpret mode, as `tests/test_kernels.py`
runs it, at small shapes.  Tensors stay under a few MB, and nothing
here builds or loads the CUDA library.

Tolerances: f32 2e-4 absolute / 1e-3 relative (fp32 sums in another
order); bf16 2e-2 (one bf16 ulp of an O(1) output).
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_arch
from repro_torch.convert import to_torch
from repro_torch.kernels import ref
from repro_torch.kernels.split_matmul import (BWD_KSLICE, MIN_STAGES, N_SM,
                                               PERSISTENT_BNS, SMEM_LIMIT,
                                               STREAM_BNS, STREAM_MAX_M,
                                               WGMMA_BM, operand_bytes,
                                               persistent_smem, plan_launch,
                                               tile_order)

BK = 512                       # the serve path's K slice (ops default)


def _products(arch):
    """(name, K, N) of every `split_matmul` on the model's serve path."""
    cfg = get_arch(arch)
    d = cfg.d_model
    out = []
    if cfg.has_attention:
        hd = cfg.resolved_head_dim
        out += [("wq", d, cfg.n_heads * hd), ("wk", d, cfg.n_kv_heads * hd),
                ("wv", d, cfg.n_kv_heads * hd), ("wo", cfg.n_heads * hd, d)]
    if cfg.d_ff:
        out += [("w13", d, 2 * cfg.d_ff), ("w2", cfg.d_ff, d)]
    if cfg.has_ssm:
        di = cfg.ssm_d_inner
        out += [("w_zx", d, 2 * di),
                ("w_bcdt", d, 2 * cfg.ssm_state + cfg.ssm_n_heads),
                ("ssm_wo", di, d)]
    return out, ("head", d, cfg.padded_vocab)


def _path_shapes():
    """Rows: prompts of 333 and 512 tokens, 8 decode slots and 1 row;
    the head runs at the last prompt row (1) and at the decode slots."""
    cases = []
    for arch in ("phi4-mini-3.8b", "mamba2-2.7b"):
        layers, head = _products(arch)
        for name, K, N in layers:
            for M in (1, 8, 333, 512):
                cases.append(pytest.param(M, K, N,
                                          id=f"{arch}-{name}-M{M}"))
        for M in (1, 8):
            cases.append(pytest.param(M, head[1], head[2],
                                      id=f"{arch}-head-M{M}"))
    return cases


def _check_ranges(plan, K):
    ranges = plan.k_ranges(K)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0                     # no gap, no overlap
    for k0, k1 in ranges:
        assert k1 > k0                      # no empty split
        assert k0 % plan.kslice == 0        # splits fall on slices
        assert k1 == K or (k1 - k0) == plan.slices_per_split * plan.kslice


@pytest.mark.parametrize("M,K,N", _path_shapes())
def test_path_shapes_take_a_new_design(M, K, N):
    plan = plan_launch(M, N, K, BK)
    assert plan.variant == ("stream" if M <= STREAM_MAX_M else "wgmma")
    assert plan.kslice == min(BK, K)
    _check_ranges(plan, K)
    assert plan.workspace == ((plan.splits, M, N) if plan.splits > 1
                              else ())
    assert plan.blocks == (math.ceil(M / plan.bm) * math.ceil(N / plan.bn)
                           * plan.splits)
    if plan.variant == "stream":
        assert plan.bm >= M and plan.bn in STREAM_BNS
        n_slices = math.ceil(K / plan.kslice)
        finest = math.ceil(N / STREAM_BNS[-1]) * n_slices
        if finest >= 2 * N_SM:
            assert plan.blocks >= 2 * N_SM  # 2 blocks a SM at least
        else:                               # the most whole slices allow
            assert (plan.bn, plan.splits) == (STREAM_BNS[-1], n_slices)


def test_decode_shapes_fill_the_card():
    """Every decode product reaches 2 blocks a SM except mamba2's
    w_bcdt (K 2560 = 5 slices of 512, N 336), where 5 slices x 21
    tiles of 16 columns is the most a whole-slice split allows."""
    short = []
    for arch in ("phi4-mini-3.8b", "mamba2-2.7b"):
        layers, head = _products(arch)
        for name, K, N in layers + [head]:
            if plan_launch(8, N, K, BK).blocks < 2 * N_SM:
                short.append((arch, name))
    assert short == [("mamba2-2.7b", "w_bcdt")]


@pytest.mark.parametrize("M,K,N,kw,why", [
    (8, 3072, 3072, dict(dtype="float32"), "float32"),
    (333, 37, 3072, {}, "multiple of 8"),
    (8, 3072, 7, {}, "multiple of 8"),
    (333, 3072, 1024, dict(aligned=False), "16-byte aligned"),
])
def test_general_kernel_only_where_needed(M, K, N, kw, why):
    plan = plan_launch(M, N, K, BK, **kw)
    assert plan.variant == "general" and why in plan.reason
    assert plan.splits == 1 and plan.workspace == ()


@pytest.mark.parametrize("M", [1, 16, 17, 64, 65, 129, 600])
@pytest.mark.parametrize("bk", [13, 40, 100, 256, 512, 2048])
def test_any_bk_is_split_on_slice_boundaries(M, bk):
    K, N = 2048, 336
    plan = plan_launch(M, N, K, bk)
    assert plan.variant != "general"
    assert plan.kslice == min(bk, K)
    _check_ranges(plan, K)


def test_bk_a_quarter_of_k_gives_a_split_4_plan():
    plan = plan_launch(8, 256, 2048, 512)
    assert (plan.variant, plan.splits, plan.slices_per_split) == (
        "stream", 4, 1)


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


@pytest.mark.parametrize("M,K,N,bk,n_sm,layout,role", [
    (8, 512, 64, 64, 4, "nn", "fwd"),       # stream: 8 slices over splits
    (8, 768, 128, 128, 8, "nn", "fwd"),     # stream, slices of 128
    (128, 2048, 128, 256, 16, "nn", "fwd"),  # wgmma rows, split-K, small card
    (128, 2048, 128, 256, 16, "nn", "acc"),  # persistent, the acc's split-K
    (200, 1536, 72, 192, 8, "nn", "acc"),    # persistent, ragged M and N
    (64, 2048, 192, 256, 16, "nt", "dgrad"),  # persistent dgrad, split-K
], ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_k_order_matches_pallas(M, K, N, bk, n_sm, layout, role,
                                      dtype):
    """The kernels' split-K order (per-slice fp32 partials, summed in
    split order) against the Pallas kernel's sequential K walk, for each
    design that splits K (the persistent design's plans included; "nt"
    reads w stored (N, K), the same product)."""
    plan = plan_launch(M, N, K, bk, n_sm=n_sm, layout=layout, role=role)
    assert plan.splits > 1
    assert plan.variant == ("persistent" if role != "fwd" else
                            "stream" if M <= STREAM_MAX_M else "wgmma")
    assert plan.kslice == bk
    rng = np.random.default_rng(M + K + N + bk)
    x, w = _rand(rng, (M, K), dtype), _rand(rng, (K, N), dtype)
    want = jops.split_matmul(jnp.asarray(x), jnp.asarray(w), bm=M, bn=N,
                             bk=bk, interpret=True)
    got = ref.split_matmul_splitk_ref(to_torch(x, "cpu"), to_torch(w, "cpu"),
                                      plan.kslice, plan.k_ranges(K))
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
           else dict(atol=2e-4, rtol=1e-3))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("M,K,N,layout,role", [
    (300, 1000, 256, "nn", "acc"),     # the accumulating form, bk 100
    (200, 600, 136, "nn", "dgrad"),    # the head's dgrad layout, bk 100
], ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_k_slice_matches_pallas(M, K, N, layout, role, dtype):
    """A `bk` that is not a multiple of 64 is planned by the persistent
    design as one slice of all of K; its one fp32 sum over K holds
    against the Pallas kernel's walk in slices of that `bk`."""
    bk = 100
    plan = plan_launch(M, N, K, bk, layout=layout, role=role)
    assert (plan.variant, plan.kslice, plan.splits) == ("persistent", K, 1)
    rng = np.random.default_rng(M + K + N)
    x, w = _rand(rng, (M, K), dtype), _rand(rng, (K, N), dtype)
    want = jops.split_matmul(jnp.asarray(x), jnp.asarray(w), bm=M, bn=N,
                             bk=bk, interpret=True)
    got = ref.split_matmul_splitk_ref(to_torch(x, "cpu"), to_torch(w, "cpu"),
                                      plan.kslice, plan.k_ranges(K))
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
           else dict(atol=2e-4, rtol=1e-3))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_split_k_order_is_fixed():
    """The same plan sums in the same order: bit-identical results."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, (8, 1000), "float32"))
    w = torch.from_numpy(_rand(rng, (1000, 48), "float32"))
    plan = plan_launch(8, 48, 1000, 100, n_sm=4)
    a = ref.split_matmul_splitk_ref(x, w, plan.kslice, plan.k_ranges(1000))
    b = ref.split_matmul_splitk_ref(x, w, plan.kslice, plan.k_ranges(1000))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), (x @ w).numpy(), atol=2e-4,
                               rtol=1e-3)


TRAIN_ROWS = 8 * 4096          # the training steps: batch 8 x seq 4096
CE_ROWS = 8 * 512              # one chunk of the chunked cross-entropy


@pytest.mark.parametrize("name,K,N",
                         _products("qwen1.5-0.5b")[0],
                         ids=lambda v: str(v))
def test_backward_plans_at_qwen_training_shapes(name, K, N):
    """Every backward product of the training step takes the persistent
    TMA + wgmma design (never the general kernel), with K cut at
    multiples of 64: dgrad dy (rows, N) . w^T ("nt") and wgrad x^T . dy
    ("tn", contracted over the rows)."""
    for M_, N_, K_, layout, role, design in (
            (TRAIN_ROWS, K, N, "nt", "dgrad", "persistent"),
            (K, N, TRAIN_ROWS, "tn", "wgrad", "persistent")):
        plan = plan_launch(M_, N_, K_, BWD_KSLICE, layout=layout, role=role)
        assert plan.variant == design, plan
        assert plan.kslice % 64 == 0
        spans = plan.k_ranges(K_)
        assert spans[0][0] == 0 and spans[-1][1] == K_
        assert all(a % 64 == 0 for a, _ in spans)


def test_head_plans_take_the_transposed_layouts():
    """The tied head at one CE chunk: the forward x emb^T reads the
    (V, d) embedding as stored ("nt"), its dgrad is dy emb ("nn") and
    its wgrad dy^T x ("tn"): the forward on the grid design, dgrad and
    wgrad on the persistent one; the backward layouts never stream, and
    fall back to the strided kernel only for what TMA cannot take."""
    _, (_, d, Vp) = _products("qwen1.5-0.5b")
    fwd = plan_launch(CE_ROWS, Vp, d, BK, layout="nt")
    dgrad = plan_launch(CE_ROWS, d, Vp, BWD_KSLICE, role="dgrad")
    wgrad = plan_launch(Vp, d, CE_ROWS, BWD_KSLICE, layout="tn",
                        role="wgrad")
    assert (fwd.variant, dgrad.variant, wgrad.variant) == (
        "wgmma", "persistent", "persistent")
    assert plan_launch(8, 1024, 1024, BK, layout="nt").variant == "wgmma"
    assert plan_launch(8, 1024, 1024, BWD_KSLICE, layout="nt",
                       role="dgrad").variant == "persistent"
    assert plan_launch(5, 19, 37, BK, layout="tn").variant == "general"
    assert plan_launch(64, 72, 80, BK, dtype="float32",
                       layout="nt").variant == "general"


# --- the persistent design: the accumulating form and dgrad ---------------

SPLIT = 4                      # the 64 GiB plan's uniform FFN split


def _acc_dgrad_products():
    """(name, role, layout, M, N, K, bk) of every accumulating and dgrad
    product of qwen1.5-0.5b's step, as out(M, N) = A(M, K) . B: the
    layers' dgrad (dy (rows, N_fwd) . w^T, "nt"), unchunked and at the
    plan's FFN split of 4 (w13 chunk d x 2 ff/4, w2 chunk ff/4 x d), the
    w2 chunk's accumulating forward ("nn", bk 512), and the tied head's
    dgrad at a CE chunk (dy (rows, V) . emb, "nn")."""
    layers, (_, d, Vp) = _products("qwen1.5-0.5b")
    c = get_arch("qwen1.5-0.5b").d_ff // SPLIT
    out = [(f"dgrad-{n}", "dgrad", "nt", TRAIN_ROWS, K, N, BWD_KSLICE)
           for n, K, N in layers + [("w13_chunk", d, 2 * c),
                                    ("w2_chunk", c, d)]]
    out.append(("acc-w2_chunk", "acc", "nn", TRAIN_ROWS, d, c, BK))
    out.append(("dgrad-head", "dgrad", "nn", CE_ROWS, d, Vp, BWD_KSLICE))
    out += [(f"dgrad-mamba-{n}", "dgrad", layout, M, N, K, BWD_KSLICE)
            for n, layout, M, N, K in _mamba_products("dgrad")]
    return [pytest.param(*p[1:], id=p[0]) for p in out]


def _mamba_products(role):
    """(name, layout, M, N, K) of mamba2-2.7b's step (batch 8 x 4096) in
    `role`, as out(M, N) = A(M, K) . B: the SSD block's three projections
    (w_zx 2560 -> 10240, w_bcdt 2560 -> 336, wo 5120 -> 2560) at 32,768
    rows and the untied head (2560 -> 50432) at a CE chunk: the forward
    "nn", dgrad dy . w^T ("nt"), wgrad x^T . dy ("tn")."""
    layers, (_, d, Vp) = _products("mamba2-2.7b")
    prods = [(n, K, N, TRAIN_ROWS) for n, K, N in layers]
    prods.append(("head", d, Vp, CE_ROWS))
    if role == "fwd":
        return [(n, "nn", rows, N, K) for n, K, N, rows in prods]
    if role == "dgrad":
        return [(n, "nt", rows, K, N) for n, K, N, rows in prods]
    return [(n, "tn", K, N, rows) for n, K, N, rows in prods]


@pytest.mark.parametrize("role,layout,M,N,K,bk", _acc_dgrad_products())
def test_acc_and_dgrad_take_the_persistent_design(role, layout, M, N, K,
                                                  bk):
    """Each accumulating and dgrad product of the step takes the
    persistent design: one block a SM at most, K cut on whole slices,
    a ring of at least MIN_STAGES stages beside its output tile within a
    block's shared memory, the row operand read from memory once."""
    plan = plan_launch(M, N, K, bk, layout=layout, role=role)
    assert plan.variant == "persistent", plan
    assert plan.bm == WGMMA_BM and plan.bn in PERSISTENT_BNS
    assert plan.kslice == (min(bk, K) if layout == "nn"
                           else 64 * math.ceil(min(bk, K) / 64))
    _check_ranges(plan, K)
    items = math.ceil(M / WGMMA_BM) * math.ceil(N / plan.bn) * plan.splits
    assert plan.blocks == min(N_SM, items)
    out_bytes = 4 if role == "acc" or plan.splits > 1 else 2
    assert (plan.stages, plan.smem) == persistent_smem(
        plan.bn, out_bytes, acc=role == "acc" and plan.splits == 1)
    assert plan.stages >= MIN_STAGES and plan.smem <= SMEM_LIMIT
    assert plan.workspace == ((plan.splits, M, N) if plan.splits > 1
                              else ())
    assert plan.row_bytes == M * K * 2          # one pass of A


def test_stream_rows_keep_the_stream_design():
    """At decode rows the accumulating form and the "nn" dgrad stay on
    weight streaming; the forward never takes the persistent design,
    wgrad ("tn") always does."""
    assert plan_launch(8, 1024, 704, BK, role="acc").variant == "stream"
    assert plan_launch(64, 1024, 2048, BWD_KSLICE,
                       role="dgrad").variant == "stream"
    assert plan_launch(65, 1024, 704, BK, role="acc").variant == \
        "persistent"
    # slices cut inside a 64-wide k-step: one slice of all of K
    plan = plan_launch(300, 256, 1000, 100, role="acc")
    assert (plan.variant, plan.kslice, plan.splits) == ("persistent", 1000,
                                                        1)
    for role, layout in (("fwd", "nn"), ("fwd", "nt")):
        assert plan_launch(4096, 1024, 1024, BK, layout=layout,
                           role=role).variant == "wgmma"
    for M in (8, 64, 4096):
        assert plan_launch(M, 1024, 1024, BK, layout="tn",
                           role="wgrad").variant == "persistent"
    with pytest.raises(ValueError):
        plan_launch(4096, 1024, 1024, BK, layout="nt", role="acc")


# forward "nn" at the layer products and the w13 chunk and the tied
# head's forward "nt" at a CE chunk, as the grid design plans them, and
# every wgrad "tn", as the persistent design plans them (bn and splits
# the fastest of a sweep of both on an H100): (M, N, K, layout, design,
# bn, splits, slices a split, blocks, tile-order group)
PINNED = {
    "fwd-attn": (TRAIN_ROWS, 1024, 1024, "nn", "wgmma", 256, 1, 2, 1024, 0),
    "fwd-w13": (TRAIN_ROWS, 5632, 1024, "nn", "wgmma", 256, 1, 2, 5632, 0),
    "fwd-w2": (TRAIN_ROWS, 1024, 2816, "nn", "wgmma", 256, 1, 6, 1024, 0),
    "fwd-w13_chunk": (TRAIN_ROWS, 1408, 1024, "nn", "wgmma", 256, 1, 2,
                      1536, 0),
    "fwd-head-nt": (CE_ROWS, 152064, 1024, "nt", "wgmma", 256, 1, 2, 19008,
                    0),
    "wgrad-attn": (1024, 1024, TRAIN_ROWS, "tn", "persistent", 256, 4, 16,
                   128, 8),
    "wgrad-w13": (1024, 5632, TRAIN_ROWS, "tn", "persistent", 256, 3, 22,
                  132, 6),
    "wgrad-w2": (2816, 1024, TRAIN_ROWS, "tn", "persistent", 256, 3, 22,
                 132, 22),
    "wgrad-w13_chunk": (1024, 1408, TRAIN_ROWS, "tn", "persistent", 192, 2,
                        32, 128, 8),
    "wgrad-w2_chunk": (704, 1024, TRAIN_ROWS, "tn", "persistent", 256, 5,
                       13, 120, 6),
    "wgrad-head": (152064, 1024, CE_ROWS, "tn", "persistent", 256, 1, 8,
                   132, 33),
    # mamba2-2.7b's step: w_bcdt's 336 columns ragged against bn 192 and
    # its 336-deep dgrad, the untied 50432-wide head
    "mamba-fwd-w_zx": (TRAIN_ROWS, 10240, 2560, "nn", "wgmma", 256, 1, 5,
                       10240, 0),
    "mamba-fwd-w_bcdt": (TRAIN_ROWS, 336, 2560, "nn", "wgmma", 192, 1, 5,
                         512, 0),
    "mamba-fwd-ssm_wo": (TRAIN_ROWS, 2560, 5120, "nn", "wgmma", 256, 1, 10,
                         2560, 0),
    "mamba-fwd-head": (CE_ROWS, 50432, 2560, "nn", "wgmma", 256, 1, 5, 6304,
                       0),
    "mamba-wgrad-w_zx": (2560, 10240, TRAIN_ROWS, "tn", "persistent", 256, 4,
                         16, 132, 3),
    "mamba-wgrad-w_bcdt": (2560, 336, TRAIN_ROWS, "tn", "persistent", 192, 3,
                           22, 120, 20),
    "mamba-wgrad-ssm_wo": (5120, 2560, TRAIN_ROWS, "tn", "persistent", 256,
                           4, 16, 132, 13),
    "mamba-wgrad-head": (2560, 50432, CE_ROWS, "tn", "persistent", 256, 1, 8,
                         132, 1),
}

# mamba2-2.7b's dgrad plans: (M, N, K, bn, splits, slices a split, blocks,
# tile-order group)
PINNED_DGRAD = {
    "w_zx": (TRAIN_ROWS, 2560, 10240, 256, 1, 20, 132, 13),
    "w_bcdt": (TRAIN_ROWS, 2560, 336, 256, 1, 1, 132, 13),
    "ssm_wo": (TRAIN_ROWS, 5120, 2560, 256, 1, 5, 132, 6),
    "head": (CE_ROWS, 2560, 50432, 256, 2, 50, 132, 13),
}


@pytest.mark.parametrize("name", list(PINNED))
def test_grid_design_plans_stay_pinned(name):
    M, N, K, layout, design, bn, splits, sps, blocks, group = PINNED[name]
    role = "wgrad" if layout == "tn" else "fwd"
    plan = plan_launch(M, N, K, 512, layout=layout, role=role)
    assert (plan.variant, plan.bn, plan.splits, plan.slices_per_split,
            plan.blocks, plan.group) == (design, bn, splits, sps, blocks,
                                         group)


@pytest.mark.parametrize("name", list(PINNED_DGRAD))
def test_mamba_dgrad_plans_stay_pinned(name):
    M, N, K, bn, splits, sps, blocks, group = PINNED_DGRAD[name]
    plan = plan_launch(M, N, K, BWD_KSLICE, layout="nt", role="dgrad")
    assert (plan.variant, plan.bn, plan.splits, plan.slices_per_split,
            plan.blocks, plan.group) == ("persistent", bn, splits, sps,
                                         blocks, group)


def test_mamba_products_are_the_pinned_ones():
    """The pins above are every product of mamba2-2.7b's step."""
    fwd = {(M, N, K) for _, _, M, N, K in _mamba_products("fwd")}
    wgrad = {(M, N, K) for _, _, M, N, K in _mamba_products("wgrad")}
    dgrad = {(M, N, K) for _, _, M, N, K in _mamba_products("dgrad")}
    pinned = {n: v[:3] for n, v in PINNED.items() if n.startswith("mamba")}
    assert fwd == {v for n, v in pinned.items() if "-fwd-" in n}
    assert wgrad == {v for n, v in pinned.items() if "-wgrad-" in n}
    assert dgrad == {v[:3] for v in PINNED_DGRAD.values()}


def test_tile_order_by_hand():
    """3 row tiles x 2 column tiles, groups of 2 row tiles, 2 splits:
    the first group's 4 tiles with the row tile fastest, then the last
    row tile's 2, then the same for the second split."""
    order = tile_order(3 * WGMMA_BM - 5, 2 * 128, 128, 2, 2)
    one = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (2, 1)]
    assert order == [(m, n, s) for s in range(2) for m, n in one]


# (M, N, K, bn, splits, blocks, group): the path's shapes, ragged edges,
# fewer tiles than blocks, tiles not a multiple of the blocks, split-K
ORDER_CASES = [
    (TRAIN_ROWS, 1024, 1024, 256, 1, 132, 33),
    (TRAIN_ROWS, 1024, 704, 128, 1, 132, 16),
    (TRAIN_ROWS, 704, 1024, 256, 1, 132, 44),
    (32845, 1000, 704, 128, 1, 132, 16),
    (300, 1000, 704, 128, 1, 24, 3),
    (4000, 2000, 704, 192, 1, 132, 12),
    (256, 256, 8192, 192, 16, 64, 2),
    (CE_ROWS, 1024, 152064, 256, 1, 128, 32),
]
# mamba2-2.7b's persistent plans: its dgrad and wgrad products, w_bcdt's
# 336 columns ragged against bn 192
ORDER_CASES += [(M, N, K, bn, s, b, g)
                for M, N, K, bn, s, _, b, g in PINNED_DGRAD.values()]
ORDER_CASES += [(M, N, K, bn, s, b, g)
                for n, (M, N, K, _, _, bn, s, _, b, g) in PINNED.items()
                if n.startswith("mamba-wgrad")]


@pytest.mark.parametrize("M,N,K,bn,splits,blocks,group", ORDER_CASES,
                         ids=lambda v: str(v))
def test_tile_order_covers_every_tile_once(M, N, K, bn, splits, blocks,
                                           group):
    """Over the persistent blocks (block b takes items b, b + blocks,
    ...), every (row tile, column tile, split) is computed exactly once,
    and no block takes more than its share rounded up."""
    order = tile_order(M, N, bn, splits, group)
    tiles_m, tiles_n = math.ceil(M / WGMMA_BM), math.ceil(N / bn)
    walked = [order[t] for b in range(blocks)
              for t in range(b, len(order), blocks)]
    assert sorted(walked) == [(m, n, s) for m in range(tiles_m)
                              for n in range(tiles_n)
                              for s in range(splits)]
    per_block = [len(range(b, len(order), blocks)) for b in range(blocks)]
    assert max(per_block) == math.ceil(len(order) / blocks)
    assert min(per_block) >= 1


@pytest.mark.parametrize("layout", ["nt", "nn"])
def test_bn_192_walks_several_tiles_a_block(layout):
    """The dgrad case of `chip_smoke.py` that takes bn 192 through the
    wrapper (3 chunks of 64 columns a tile, an odd count, so the staging
    buffers alternate across tile boundaries): one split of 3 k-steps,
    about 3 tiles a block."""
    plan = plan_launch(8192, 1152, 192, BWD_KSLICE, layout=layout,
                       role="dgrad")
    items = math.ceil(8192 / WGMMA_BM) * math.ceil(1152 / plan.bn)
    assert (plan.variant, plan.bn, plan.splits) == ("persistent", 192, 1)
    assert items >= 2 * plan.blocks


def test_operand_bytes_one_pass_against_row_tiles_fastest():
    """At the attention dgrad (32768 rows, bn 256: 4 column tiles) the
    grouped raster reads dy once; with all 256 row tiles in one group
    (the grid design's order, row tiles fastest) each column tile reads
    it again, and the 2 MB weight stays one pass either way."""
    M, N, K, bn, blocks = TRAIN_ROWS, 1024, 1024, 256, 132
    one = M * K * 2
    a, b = operand_bytes(M, N, K, bn, 1, K, blocks, 33)
    assert (a, b) == (one, N * K * 2)
    a, b = operand_bytes(M, N, K, bn, 1, K, blocks, M // WGMMA_BM)
    assert (a, b) == (4 * one, N * K * 2)


# --- wgrad ("tn") on the persistent design ----------------------------------

CHAIN_WIDTH, CHAIN_ROWS = 16384, 64   # the calibration's remat chain


def _wgrad_products():
    """(name, M, N, K) of every wgrad of qwen1.5-0.5b's step and of the
    calibration's remat chain, as out(M, N) = x^T (M, K) . dy (K, N),
    contracted over the K rows: the layers unchunked and at the plan's
    FFN split of 4, the tied head's dy^T x at a CE chunk, the chain's
    16384 x 16384 weight over 64 rows."""
    layers, (_, d, Vp) = _products("qwen1.5-0.5b")
    c = get_arch("qwen1.5-0.5b").d_ff // SPLIT
    out = [(f"wgrad-{n}", K, N, TRAIN_ROWS)
           for n, K, N in layers + [("w13_chunk", d, 2 * c),
                                    ("w2_chunk", c, d)]]
    out += [("wgrad-head", Vp, d, CE_ROWS),
            ("wgrad-chain", CHAIN_WIDTH, CHAIN_WIDTH, CHAIN_ROWS)]
    out += [(f"wgrad-mamba-{n}", M, N, K)
            for n, _, M, N, K in _mamba_products("wgrad")]
    return [pytest.param(*p[1:], id=p[0]) for p in out]


@pytest.mark.parametrize("M,N,K", _wgrad_products())
def test_every_wgrad_takes_the_persistent_design(M, N, K):
    """Each wgrad of the step and of the chain takes the persistent
    design: one block a SM at most, K cut at multiples of 64 on whole
    slices, a ring of at least MIN_STAGES stages beside its staging
    buffers (fp32 partials with split-K) within a block's shared
    memory."""
    plan = plan_launch(M, N, K, BWD_KSLICE, layout="tn", role="wgrad")
    assert plan.variant == "persistent", plan
    assert plan.bm == WGMMA_BM and plan.bn in PERSISTENT_BNS
    assert plan.kslice == 64 * math.ceil(min(BWD_KSLICE, K) / 64)
    _check_ranges(plan, K)
    items = math.ceil(M / WGMMA_BM) * math.ceil(N / plan.bn) * plan.splits
    assert plan.blocks == min(N_SM, items)
    assert (plan.stages, plan.smem) == persistent_smem(
        plan.bn, 4 if plan.splits > 1 else 2)
    assert plan.stages >= MIN_STAGES and plan.smem <= SMEM_LIMIT
    assert plan.workspace == ((plan.splits, M, N) if plan.splits > 1
                              else ())


def test_head_wgrad_reads_dy_once():
    """The tied head's wgrad dy^T x at a CE chunk (out 152064 x 1024 over
    4096 rows): the plan's grouped raster reads dy (the row operand A,
    stored (4096, 152064)) from memory once; in the grid design's order
    (all 1188 row tiles in one group, row tiles fastest) each of the
    column tiles reads it again."""
    _, (_, d, Vp) = _products("qwen1.5-0.5b")
    plan = plan_launch(Vp, d, CE_ROWS, BWD_KSLICE, layout="tn",
                       role="wgrad")
    one = Vp * CE_ROWS * 2
    assert plan.row_bytes == one
    span = plan.slices_per_split * plan.kslice
    grid, _ = operand_bytes(Vp, d, CE_ROWS, plan.bn, plan.splits, span,
                            plan.blocks, math.ceil(Vp / WGMMA_BM))
    assert grid == math.ceil(d / plan.bn) * one


@pytest.mark.parametrize("M,N,K,n_sm,splits", [
    (128, 192, 2048, 16, 4),    # split-K on a small card
    (200, 136, 1000, 8, 2),     # ragged output rows and columns, K not a
                                # multiple of 64
    (64, 256, 4096, 132, 8),    # fewer tiles than SMs: split-K
    (256, 128, 640, 132, 1),    # one split of a slice and a part
    (256, 384, 1536, 4, 1),     # tiles enough for a small card
], ids=lambda v: str(v))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wgrad_split_order_matches_jax(M, N, K, n_sm, splits, dtype):
    """The persistent wgrad plan's summation order (fp32 partials over
    its `k_ranges`, each over whole 512-row slices, summed in split
    order: `ref.split_matmul_splitk_ref` on x^T) against the JAX
    package's x.T @ dy in fp32.  Tolerances as above: f32 2e-4 / 1e-3
    (another order of fp32 sums), bf16 2e-2 (one bf16 ulp of an O(1)
    output, the cast at the end)."""
    plan = plan_launch(M, N, K, BWD_KSLICE, n_sm=n_sm, layout="tn",
                       role="wgrad")
    assert (plan.variant, plan.splits) == ("persistent", splits)
    rng = np.random.default_rng(M + N + K)
    x = _rand(rng, (K, M), dtype)
    dy = (_rand(rng, (K, N), "float32") / np.sqrt(K)).astype(x.dtype)
    want = jnp.matmul(jnp.asarray(x).T, jnp.asarray(dy),
                      preferred_element_type=jnp.float32)
    got = ref.split_matmul_splitk_ref(to_torch(x, "cpu").t(),
                                      to_torch(dy, "cpu"), plan.kslice,
                                      plan.k_ranges(K))
    tol = (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
           else dict(atol=2e-4, rtol=1e-3))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
