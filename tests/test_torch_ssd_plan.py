"""The `ssd_scan` kernel's arithmetic and launch plan, on the CPU.

The CUDA kernel (`src/repro_torch/csrc/ssd_scan.cu`) runs the Mamba2 SSD
scan in three passes (chunk states and c.b^T; the state recurrence
across chunks; the chunk scan) with every product on the tensor cores.
The tensor cores take bf16, so each fp32 factor of a product (x*w, the
masked decay matrix G, the carried state) is cut into bf16 terms
hi = bf16(v), lo = bf16(v - hi): with bf16 inputs x, b and c are exact
and each product is two mmas; with f32 inputs every operand is three
terms and the term pairs whose indices sum to at most 2 are kept; left
of the diagonal 64-row tiles the decay is factored through the end of
each column tile, as the kernel forms it.  `ref.ssd_scan_split_ref` is
that arithmetic in plain PyTorch.  Here it is
held against the Pallas `ssd_scan` (interpret mode, as
`tests/test_kernels.py` runs it), the JAX model path's `ssd_chunk_scan`
and the port's plain version `ref.ssd_scan_ref`, at ragged S, S shorter
than a chunk, four chunks and more, an initial state, and the head shapes
of mamba2-2.7b (64 wide, state 128, chunk 256; fewer heads) and
hymba-1.5b (50 wide, state 16).  `plan_launch` is checked at both
families' serve-path shapes.  Tensors stay under a few MB, and nothing
here builds or loads the CUDA library.

Tolerances, on the scale of 1 + |want| over y and the final state, as
`chip_smoke.py` holds the kernel to: 1e-3 for bf16 inputs, 1e-4 for f32
inputs.  The emulated error of the split is about 1e-5 (bf16) and 1.5e-6
(f32) at (1, 512, 80, 64); rounding the fp32 factors to bf16 once would
give 4.8e-3.  The Pallas kernel returns y in its input type, so with bf16
inputs its side also carries its own rounding of y: 2^-8 |want|.
"""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import (HEAD_GROUP, MAX_SMEM, TILE,
                                          plan_launch)

TOL = {"bfloat16": 1e-3, "float32": 1e-4}
N_SM = 132


def _inputs(seed, B, S, nh, hd, ns, dtype, init):
    """numpy inputs as the model makes them: x, b, c slices of one conv
    row (cast to `dtype`), dt a softplus, a_log in [0, log 16)."""
    rng = np.random.default_rng(seed)
    conv = (rng.standard_normal((B, S, nh * hd + 2 * ns)) * 0.5
            ).astype(np.float32)
    if dtype == "bfloat16":
        conv = conv.astype(ml_dtypes.bfloat16)
    x = conv[..., :nh * hd].reshape(B, S, nh, hd)
    b, c = conv[..., nh * hd:nh * hd + ns], conv[..., nh * hd + ns:]
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)) - 1.0)
                  ).astype(np.float32)
    a_log = rng.uniform(0.0, math.log(16.0), nh).astype(np.float32)
    s0 = (rng.standard_normal((B, nh, hd, ns)).astype(np.float32)
          if init else None)
    return (x, dt, a_log, b, c), s0


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _scaled_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float((np.abs(got - want) / (1.0 + np.abs(want))).max())


def _model(args, s0, chunk):
    targs = [_torch(a) for a in args]
    return ref.ssd_scan_split_ref(
        *targs, chunk=chunk,
        init_state=None if s0 is None else torch.from_numpy(s0))


# B, S, nh, hd, ns, chunk, init: what each exercises
CASES = {
    "ragged": (2, 45, 4, 16, 8, 32, False),
    "short": (1, 20, 3, 16, 8, 64, True),            # S < chunk
    "chunks5-init": (2, 200, 3, 16, 16, 48, True),   # nc 5, last ragged
    "chunks8-exact": (1, 256, 2, 8, 4, 32, False),   # nc 8, S = 8 chunks
    "mamba2-heads": (1, 300, 4, 64, 128, 256, True),
    "hymba-heads": (1, 300, 4, 50, 16, 256, False),
    "one-row": (1, 1, 4, 64, 128, 256, False),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_model_matches_jax_model_path_and_plain(case, dtype):
    B, S, nh, hd, ns, chunk, init = CASES[case]
    args, s0 = _inputs(len(case) * 7 + S, B, S, nh, hd, ns, dtype, init)
    got = _model(args, s0, chunk)
    want_jax = jssm.ssd_chunk_scan(
        *map(jnp.asarray, args), chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    want_plain = ref.ssd_scan_ref(
        *[_torch(a) for a in args], chunk=chunk,
        init_state=None if s0 is None else torch.from_numpy(s0))
    assert got[0].dtype == got[1].dtype == torch.float32
    assert tuple(got[1].shape) == (B, nh, hd, ns)
    for want in (want_jax, want_plain):
        for g, w in zip(got, want):
            assert _scaled_err(g.numpy(), np.asarray(w)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [
    # B, S, nh, hd, ns, chunk, bh (S a multiple of the chunk, as Pallas
    # asks)
    (1, 64, 2, 16, 8, 16, 2),
    (2, 128, 4, 50, 16, 32, 2),
    (1, 128, 2, 64, 128, 64, 1),
])
def test_split_model_matches_pallas(shape, dtype):
    B, S, nh, hd, ns, chunk, bh = shape
    args, _ = _inputs(sum(shape), B, S, nh, hd, ns, dtype, False)
    want = np.asarray(jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                                    bh=bh, interpret=True), np.float32)
    y = _model(args, None, chunk)[0].numpy()
    slack = 2.0 ** -8 * np.abs(want) if dtype == "bfloat16" else 0.0
    err = np.abs(y - want) - slack
    assert (err <= TOL[dtype] * (1.0 + np.abs(want))).all(), \
        float((err / (1.0 + np.abs(want))).max())


def test_split_is_what_meets_the_tolerance():
    """Rounding each fp32 factor to bf16 once misses 1e-3; the split
    (the kernel's scheme) is within a tenth of it."""
    args, _ = _inputs(5, 1, 256, 4, 64, 128, "bfloat16", False)
    targs = [_torch(a) for a in args]
    want = ref.ssd_scan_ref(*targs, chunk=128)
    split = ref.ssd_scan_split_ref(*targs, chunk=128)
    terms = ref._bf16_terms
    try:
        ref._bf16_terms = lambda v, n: terms(v, 1)
        once = ref.ssd_scan_split_ref(*targs, chunk=128)
    finally:
        ref._bf16_terms = terms
    err = lambda got: max(_scaled_err(g.numpy(), w.numpy())
                          for g, w in zip(got, want))
    assert err(split) <= TOL["bfloat16"] / 10
    assert err(once) > TOL["bfloat16"]


@pytest.mark.parametrize("Q", [64, 200, 256])
def test_decay_matrix_factored_as_the_kernel(Q):
    """The kernel's decay left of the diagonal tiles, exp(csum_i -
    csum_r) exp(csum_r - csum_j), is exp(csum_i - csum_j) to fp32
    rounding (values under 1e-30, where the two underflow apart, aside);
    nothing above the diagonal; every factor <= 1."""
    rng = np.random.default_rng(Q)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((1, 1, Q, 2))
                                          - 1.0)).astype(np.float32))
    csum = torch.cumsum(dt * -torch.tensor([1.0, 16.0]), dim=2)
    ones = torch.ones(1, 1, Q, Q)
    g = ref.ssd_decay_matrix(csum, ones, dt)
    want = torch.exp((csum[:, :, :, None] - csum[:, :, None]).masked_fill(
        ~torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, None, :, :,
                                                         None],
        float("-inf"))) * dt[:, :, None]
    above = ~torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    assert (g[0, 0][above] == 0).all()
    assert torch.allclose(g, want, rtol=1e-5, atol=1e-30)
    assert (g <= dt[:, :, None]).all()


# --- the launch plan ---------------------------------------------------------

def _path(arch, B, S, dtype="bfloat16"):
    cfg = get_arch(arch)
    return (B, S, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk, dtype)


PATH_SHAPES = [("mamba2-2.7b", 1, 333), ("mamba2-2.7b", 1, 512),
               ("mamba2-2.7b", 8, 512), ("hymba-1.5b", 1, 333),
               ("hymba-1.5b", 2, 512)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch,B,S", PATH_SHAPES)
def test_plan_at_path_shapes(arch, B, S, dtype):
    B, S, nh, hd, ns, chunk, dtype = _path(arch, B, S, dtype)
    p = plan_launch(B, S, nh, hd, ns, chunk, dtype)
    Q = min(chunk, S)
    nc = -(-S // Q)
    QP = -(-Q // TILE) * TILE
    assert (p.chunk_rows, p.n_chunks, p.chunk_pad) == (Q, nc, QP)
    assert p.hd_pad == -(-hd // 16) * 16 and p.hd_pad >= hd
    assert p.ns_pad == -(-ns // 16) * 16
    assert p.hd_tile == 64 and p.head_group == HEAD_GROUP
    ntq = QP // TILE
    groups = -(-nh // p.head_group)
    # states + c.b^T tiles; the state pass; the chunk scan
    assert p.grids == ((nh + ntq * (ntq + 1) // 2, nc, B),
                       (-(-(hd * ns // 4) // 256), nh, B),
                       (ntq * groups, nc, B))
    assert p.threads == (256, 256, 128 * p.head_group)
    nd = 2 if dtype == "bfloat16" else 3          # bf16 terms of S_prev
    assert p.workspace_bytes == (4 * (B * nc * nh * hd * ns + B * nc * QP * QP
                                      + 2 * B * nc * nh * QP)
                                 + 2 * B * nc * nh * nd * hd * p.ns_pad)
    assert max(p.smem) <= MAX_SMEM
    # far more blocks than one per (batch, head)
    assert p.blocks[0] > B * nh and p.blocks[2] > B * nh


def test_plan_fills_the_card_at_batch_one():
    p = plan_launch(*_path("mamba2-2.7b", 1, 512))
    assert p.head_group == 2
    assert p.blocks == (180, 640, 320)
    assert p.blocks[2] >= N_SM
    assert p.workspace_bytes == 11337728


def test_plan_pads_hymba_head_dim():
    p = plan_launch(*_path("hymba-1.5b", 1, 333))
    assert (p.hd_pad, p.ns_pad, p.hd_tile) == (64, 16, 64)


@pytest.mark.parametrize("arch,B,S", PATH_SHAPES)
def test_plan_as_the_c_entry_reads_it(arch, B, S):
    """`c_plan` in the order of `struct Plan` (csrc/ssd_scan.cu), and
    within what the entry checks: workspace regions that keep 16-byte
    alignment, threads of 256, 256 and 128 a head."""
    p = plan_launch(*_path(arch, B, S))
    vals = list(p.c_plan)
    assert len(vals) == 22
    assert vals[:9] == [v for g in p.grids for v in g]
    assert vals[9:12] == [256, 256, 128 * p.head_group]
    assert vals[12:15] == list(p.smem)
    assert vals[15:20] == list(p.workspace)
    assert all(f % 4 == 0 for f in p.workspace)
    assert vals[20:] == [p.head_group, p.hd_tile]
    assert all(1 <= g[1] <= 65535 and 1 <= g[2] <= 65535 for g in p.grids)


def test_plan_shrinks_the_group_to_fit_shared_memory():
    # f32 at head dim 128 does not hold two heads' buffers
    p = plan_launch(1, 300, 4, 128, 64, 128, "float32")
    assert (p.hd_tile, p.head_group) == (128, 1) and p.smem[2] <= MAX_SMEM
    assert plan_launch(1, 300, 4, 128, 64, 128).head_group == 2


@pytest.mark.parametrize("bad", [
    dict(hd=129), dict(ns=130), dict(ns=6), dict(chunk=2048, S=4096)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    kw = dict(B=1, S=512, nh=8, hd=64, ns=128, chunk=256)
    kw.update(bad)
    with pytest.raises(ValueError):
        plan_launch(kw["B"], kw["S"], kw["nh"], kw["hd"], kw["ns"],
                    kw["chunk"])
