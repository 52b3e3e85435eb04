"""The `ssd_scan` backward on the CPU: its plain version and launch plan.

`ref.ssd_scan_bwd_ref` writes out the chunk-parallel gradient of the
Mamba2 SSD scan that the CUDA backward (`csrc/ssd_scan.cu`, passes F1-B5)
computes: the state gradient walked backwards over the chunks, the
quadratic form's gradient within a chunk, the reverse cumsum of dcsum.
Here it is held against `jax.vjp` of the JAX model path's
`ssd_chunk_scan` (the function the JAX package differentiates, the
Pallas kernel having no VJP) for every input (x, dt, a_log, b, c), with
and without a cotangent of the final state and an initial state, at S a
multiple of the chunk, ragged S and S shorter than a chunk, with f32 and
bf16 inputs made from numpy with one seed; and against torch autograd of
`ref.ssd_scan_ref`.  `ops.ssd` (the differentiable form) is checked to
route through it.  `ssd_scan.plan_bwd` and the plan array the C entry
reads (`BwdPlan.c_plan`, laid out as `struct BwdPlan`) are checked by
enumeration.  Nothing here builds or loads the CUDA library.

Tolerances, as ||port - jax|| / ||jax|| over each output (da_log is a sum
over every row of a head, so it is held relative to its own norm):
1e-4 for fp32 results (both sides compute in fp32 from the same inputs,
in other orders; measured at most 2.8e-5, da_log), and 2e-3 for the
results returned in bf16 with bf16 inputs (dx, db, dc: each side rounds
its own fp32 value to bf16, a relative step of up to 2^-8 where the two
fp32 values straddle a rounding boundary; measured at most 2.0e-4).
"""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import (BWD_MAX_HEAD_DIM, MAX_SMEM, TILE,
                                          bwd_chunk_bytes, bwd_dstate_bytes,
                                          plan_bwd, plan_launch)

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" \
    / "ssd_scan.cu"
F32_TOL, BF16_TOL = 1e-4, 2e-3
NAMES = ("dx", "ddt", "da_log", "db", "dc")

# (B, S, nh, hd, ns, chunk, init, dfin): S a multiple of the chunk (three
# chunks), ragged S, S shorter than the chunk, an initial state, the head
# shapes of mamba2-2.7b (64 wide; fewer heads, a smaller state) and of
# hymba-1.5b (50 wide, state 16)
CASES = {
    "three_chunks": (2, 96, 3, 16, 8, 32, False, True),
    "ragged": (1, 70, 2, 16, 8, 32, True, True),
    "short": (2, 20, 3, 16, 8, 32, False, False),
    "mamba_heads": (1, 80, 2, 64, 32, 32, False, True),
    "hymba_heads": (1, 40, 2, 50, 16, 16, False, False),
}


def _inputs(case, dtype, seed=0):
    B, S, nh, hd, ns, chunk, init, dfin = CASES[case]
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
    dy = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    df = (rng.standard_normal((B, nh, hd, ns)).astype(np.float32) if dfin
          else None)
    s0 = (rng.standard_normal((B, nh, hd, ns)).astype(np.float32) if init
          else None)
    return (x, dt, a_log, b, c), dy, df, s0, chunk


def _torch(a):
    if a is None:
        return None
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_grads(args, dy, df, s0, chunk):
    ns = args[3].shape[-1]
    B, _, nh, hd = args[0].shape
    init = None if s0 is None else jnp.asarray(s0)
    f = lambda *a: jssm.ssd_chunk_scan(*a, chunk, init)
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    dfin = df if df is not None else np.zeros((B, nh, hd, ns), np.float32)
    return [np.asarray(g, np.float32) for g in vjp((dy, dfin))]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_jax_grad(case, dtype):
    args, dy, df, s0, chunk = _inputs(case, dtype)
    want = _jax_grads(args, dy, df, s0, chunk)
    got = ref.ssd_scan_bwd_ref(*(_torch(a) for a in args), _torch(dy),
                               chunk=chunk, d_final_state=_torch(df),
                               init_state=_torch(s0))
    assert got[0].dtype == got[3].dtype == got[4].dtype == \
        (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, g, w in zip(NAMES, got, want):
        tol = BF16_TOL if (dtype == "bfloat16"
                           and name in ("dx", "db", "dc")) else F32_TOL
        err = _rel(g.float().numpy(), w)
        assert err <= tol, f"{case} {dtype} {name}: {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("case", ["ragged", "short", "mamba_heads"])
def test_bwd_ref_matches_autograd_of_the_plain_scan(case):
    """The written-out gradient against torch autograd of the plain
    forward, `ref.ssd_scan_ref`, in fp32."""
    args, dy, df, s0, chunk = _inputs(case, "float32", seed=1)
    ts = [_torch(a).requires_grad_(True) for a in args]
    y, fin = ref.ssd_scan_ref(*ts, chunk=chunk, init_state=_torch(s0))
    loss = (y * _torch(dy)).sum()
    if df is not None:
        loss = loss + (fin * _torch(df)).sum()
    want = torch.autograd.grad(loss, ts)
    got = ref.ssd_scan_bwd_ref(*(_torch(a) for a in args), _torch(dy),
                               chunk=chunk, d_final_state=_torch(df),
                               init_state=_torch(s0))
    for name, g, w in zip(NAMES, got, want):
        err = _rel(g.numpy(), w.numpy())
        assert err <= F32_TOL, f"{case} {name}: {err:.3g}"


def test_ssd_autograd_routes_through_the_backward(monkeypatch):
    """`ops.ssd` differentiates x, dt, a_log, b and c through
    `ops.ssd_scan_bwd`, looked up at call time; the final state carries
    no gradient."""
    args, dy, df, _, chunk = _inputs("ragged", "float32")
    calls = []
    real = ops.ssd_scan_bwd

    def spy(*a, **kw):
        calls.append(kw["d_final_state"])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "ssd_scan_bwd", spy)
    ts = [_torch(a).requires_grad_(True) for a in args]
    y, fin = ops.ssd(*ts, chunk=chunk)
    assert not fin.requires_grad
    (y * _torch(dy)).sum().backward()
    assert len(calls) == 1
    want = ref.ssd_scan_bwd_ref(*(_torch(a) for a in args), _torch(dy),
                                chunk=chunk)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad, w)


def test_ssd_refuses_an_initial_state_that_needs_a_gradient():
    args, _, _, s0, chunk = _inputs("ragged", "float32")
    init = _torch(s0).requires_grad_(True)
    with pytest.raises(NotImplementedError, match="init_state"):
        ops.ssd(*(_torch(a) for a in args), chunk=chunk, init_state=init)


# --- the launch plan ---------------------------------------------------------

def _path(arch, B, S, dtype="bfloat16"):
    cfg = get_arch(arch)
    return (B, S, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_chunk, dtype)


# the training step's shape, the serve shapes, and hymba's heads
PATH_SHAPES = [("mamba2-2.7b", 8, 4096), ("mamba2-2.7b", 1, 333),
               ("mamba2-2.7b", 1, 512), ("mamba2-2.7b", 2, 100),
               ("hymba-1.5b", 1, 333)]


def _smem_by_tiles(QP, NSP, ni, nf):
    """The chunk block's shared memory, tile by tile as the kernel carves
    it: csum, dt and six rows of row vectors (fp32); then bf16-term
    planes of 64-row tiles, rows padded by 8 elements (ni planes an input
    tile, nf an fp32 one) and an fp32 c.b^T tile: a dx block's x_J and
    its largest phase, a db block's x_J, x_J dt w and its larger phase,
    a row block's dy_I, e dy_I and its larger phase."""
    T, HD = TILE, BWD_MAX_HEAD_DIM
    planes = lambda n, cols: n * T * (cols + 8) * 2
    head = 4 * (2 * QP + 6 * T)
    x_in, x_f = planes(ni, HD), planes(nf, HD)
    s_in, s_f = planes(ni, NSP), planes(nf, NSP)
    cb = 4 * T * (T + 4)
    dx = x_in + max(s_in + s_f + x_f,           # c_J, P, dy_J
                    s_in + s_f,                 # b_J, D
                    x_f + cb)                   # dy_I, CB
    db = x_in + x_f + max(s_f,                  # D
                          x_f + s_in)           # dy_I, c_I
    row = 2 * x_f + max(s_f,                    # P
                        x_in + s_in + cb)       # x_J, b_J, CB
    return head + max(dx, db, row)


@pytest.mark.parametrize("ni,nf", [(1, 2), (3, 3)])
@pytest.mark.parametrize("NSP", [16, 32, 64, 128])
@pytest.mark.parametrize("QP", [64, 128, 256, 512, 1024])
def test_shared_memory_by_enumeration(QP, NSP, ni, nf):
    assert bwd_chunk_bytes(QP, NSP, ni, nf) == _smem_by_tiles(QP, NSP, ni,
                                                               nf)
    assert bwd_dstate_bytes(QP, NSP, ni, nf) == (
        4 * QP + nf * TILE * (BWD_MAX_HEAD_DIM + 8) * 2
        + ni * TILE * (NSP + 8) * 2)
    assert bwd_chunk_bytes(QP, NSP, ni, nf) % 16 == 0
    assert bwd_chunk_bytes(QP, NSP, ni, nf) <= MAX_SMEM


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch,B,S", PATH_SHAPES)
def test_bwd_plan_at_path_shapes(arch, B, S, dtype):
    B, S, nh, hd, ns, chunk, dtype = _path(arch, B, S, dtype)
    p = plan_bwd(B, S, nh, hd, ns, chunk, dtype)
    assert p.fwd == plan_launch(B, S, nh, hd, ns, chunk, dtype)
    Q = min(chunk, S)
    nc = -(-S // Q)
    QP = -(-Q // TILE) * TILE
    ntq = QP // TILE
    heads = B * nc * nh
    # dstate a (head, chunk, batch); the state pass a float4 of the state
    # a thread, a (1024 elements, head, batch); the
    # chunk terms a (tile, chunk, batch), launched for each of the dx, db
    # and row roles; finish a
    # thread a (batch, chunk, head); da a thread a head
    passes = -(-(hd * ns) // 1024)
    assert p.grids == ((nh, nc, B), (passes, nh, B), (ntq, nc, B),
                       (-(-heads // 256), 1, 1), (-(-nh // 128), 1, 1))
    assert p.threads == (128, 256, 256, 256, 128)
    ni, nf = (1, 2) if dtype == "bfloat16" else (3, 3)
    NSP = p.fwd.ns_pad
    assert p.smem == (bwd_dstate_bytes(QP, NSP, ni, nf), 0,
                      _smem_by_tiles(QP, NSP, ni, nf), 0, 0)
    assert max(p.smem) <= MAX_SMEM
    up4 = lambda v: -(-v // 4) * 4
    assert p.workspace == (B * nh * hd * ns, heads * QP, heads * QP,
                           up4(heads * ntq), up4(heads * passes * 8),
                           up4(heads))
    assert all(f % 4 == 0 for f in p.workspace)
    assert p.workspace_bytes == p.fwd.workspace_bytes + 4 * sum(p.workspace)


def test_bwd_plan_at_the_training_shape():
    """mamba2-2.7b's step at batch 8 x 4096: 512 chunk blocks a role, 83
    KB of shared memory a block, 0.77 GB of workspace a call (the forward's
    0.72 GB recomputed, plus the final state and the dcsum terms)."""
    p = plan_bwd(*_path("mamba2-2.7b", 8, 4096))
    assert p.grids[2] == (4, 16, 8)
    assert p.smem[2] == 84480
    assert p.fwd.workspace_bytes == 725614592
    assert p.workspace_bytes == 770383872


def _struct_fields(name):
    body = re.search(r"struct %s \{(.*?)\};" % name, SRC.read_text(),
                     re.S).group(1)
    return [(m.group(1), [int(v) for v in re.findall(r"\[(\d+)\]",
                                                       m.group(2))])
            for m in re.finditer(r"^\s*(?:long long|Plan) (\w+)((?:\[\d+\])*);",
                                 body, re.M)]


@pytest.mark.parametrize("arch,B,S", PATH_SHAPES)
def test_bwd_plan_as_the_c_entry_reads_it(arch, B, S):
    """`c_plan` in the order of `struct BwdPlan` (csrc/ssd_scan.cu): the
    forward's 22 int64, then the five grids, threads, shared memory and
    the six workspace regions."""
    fields = _struct_fields("BwdPlan")
    assert fields == [("fwd", []), ("grid", [5, 3]), ("threads", [5]),
                      ("smem", [5]), ("ws", [6])]
    p = plan_bwd(*_path(arch, B, S))
    vals = list(p.c_plan)
    assert len(vals) == 22 + 15 + 5 + 5 + 6
    assert vals[:22] == list(p.fwd.c_plan)
    assert vals[22:37] == [v for g in p.grids for v in g]
    assert vals[37:42] == list(p.threads)
    assert vals[42:47] == list(p.smem)
    assert vals[47:] == list(p.workspace)
    assert all(1 <= g[1] <= 65535 and 1 <= g[2] <= 65535 for g in p.grids)


@pytest.mark.parametrize("bad", [dict(hd=65), dict(hd=128), dict(ns=6),
                                 dict(chunk=2048, S=4096)])
def test_bwd_plan_refuses_what_the_kernel_does_not_take(bad):
    kw = dict(B=1, S=512, nh=8, hd=64, ns=128, chunk=256)
    kw.update(bad)
    with pytest.raises(ValueError):
        plan_bwd(kw["B"], kw["S"], kw["nh"], kw["hd"], kw["ns"],
                 kw["chunk"])
