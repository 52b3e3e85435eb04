"""The `split_matmul` launch planner and its split-K summation order.

`repro_torch.kernels.split_matmul.plan_launch` is pure Python: it picks
the CUDA design for a product (weight streaming with split-K for decode
rows, TMA + wgmma for prefill rows, the general first-version kernel
only where neither can run), its tile and its K split.  Here it is
checked at every product of the two served models, read from their
configurations, and at the cases that force the general kernel.  The
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
from repro_torch.kernels.split_matmul import (N_SM, STREAM_BNS,
                                               STREAM_MAX_M, plan_launch)

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


@pytest.mark.parametrize("M,K,N,bk,n_sm", [
    (8, 512, 64, 64, 4),        # stream: 8 slices over the splits
    (8, 768, 128, 128, 8),      # stream, slices of 128
    (128, 2048, 128, 256, 16),  # wgmma rows, split-K on a small card
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_k_order_matches_pallas(M, K, N, bk, n_sm, dtype):
    """The kernels' split-K order (per-slice fp32 partials, summed in
    split order) against the Pallas kernel's sequential K walk."""
    plan = plan_launch(M, N, K, bk, n_sm=n_sm)
    assert plan.splits > 1
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
