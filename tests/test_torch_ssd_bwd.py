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
enumeration, and so is the walk of the persistent chunk-term kernels
(`walk`, `col_item`, `row_item`): every (batch, chunk, head, I >= J)
tile pair once, blocks' work within a stated factor of the mean.
Nothing here builds or loads the CUDA library.

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
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ssd_scan import (BWD_MAX_HEAD_DIM, MAX_SMEM, TILE,
                                          bwd_cols_bytes, bwd_dstate_bytes,
                                          bwd_rows_bytes, plan_bwd,
                                          plan_launch)

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


def _cols_by_regions(ni, nf, hs):
    """The column kernel's shared memory, region by region as the kernel
    carves it: a ring of 4 slots (a 16 KB tile and a 1 KB side vector
    each); `hs` head stages of x's ni bf16 planes (64 x 64) and
    256 rows of csum and dt (fp32); nf bf16 planes of 64 x 128 (D, or
    dy's 64 x 64 in the same place); G^T of 4 tile pairs (fp32 64 x 64);
    4 x 64 + 64 + 4 floats of scratch; 2 mbarriers a slot and a head
    stage; 1024 bytes to align the base."""
    slots = 4 * (64 * 64 * 4 + 1024)
    head = ni * 64 * 64 * 2 + 2 * 256 * 4
    return (slots + hs * head + nf * 64 * 128 * 2 + 4 * 64 * 64 * 4
            + (4 * 64 + 64 + 4) * 4 + 8 * (2 * 4 + 2 * hs)
            + 1024)


@pytest.mark.parametrize("ni,nf", [(1, 2), (3, 3)])
@pytest.mark.parametrize("NSP", [16, 32, 64, 128])
@pytest.mark.parametrize("QP", [64, 128, 256, 512, 1024])
def test_shared_memory_by_enumeration(QP, NSP, ni, nf):
    """dstate's shared memory by its tiles; the chunk-term kernels', the
    same at every QP and NSP (their tiles are 64 x 64 and 64 x 128,
    padded), by region; the column kernel keeps 2 head stages where they
    fit (bf16), else 1 (f32)."""
    assert bwd_dstate_bytes(QP, NSP, ni, nf) == (
        4 * QP + nf * TILE * (BWD_MAX_HEAD_DIM + 8) * 2
        + ni * TILE * (NSP + 8) * 2)
    hs = 2 if _cols_by_regions(ni, nf, 2) <= MAX_SMEM else 1
    assert hs == (2 if ni == 1 else 1)
    assert bwd_cols_bytes(ni, nf, hs) == _cols_by_regions(ni, nf, hs)
    assert bwd_rows_bytes(ni) == (4 * (64 * 64 * 4 + 1024)
                                  + ni * 64 * 128 * 2 + 8 * 10 + 1024)
    for b in (bwd_dstate_bytes(QP, NSP, ni, nf),
              bwd_cols_bytes(ni, nf, hs), bwd_rows_bytes(ni)):
        assert b % 16 == 0 and b <= MAX_SMEM


def _walk_items(p, B, S):
    """Each block's items of the column and row kernels, in walk order."""
    nc, Q = p.fwd.n_chunks, p.fwd.chunk_rows
    ntq, ntl = p.fwd.chunk_pad // TILE, -(-(S - (nc - 1) * Q) // TILE)
    out = []
    for G, items, item in ((p.grids[3][0], p.col_items,
                            lambda r: sk.col_item(r, nc, ntq, ntl, p.groups)),
                           (p.grids[4][0], p.row_items,
                            lambda r: sk.row_item(r, nc, ntq, ntl))):
        blocks = []
        for x in range(G):
            ranks = []
            k = 0
            while sk.walk(k, x, G) < items:
                ranks.append(sk.walk(k, x, G))
                k += 1
            blocks.append([item(r) for r in ranks])
        out.append(blocks)
    return out


RAGGED = [(1, 70), (2, 300), (3, 1000), (1, 20)]


@pytest.mark.parametrize("B,S", [(B, S) for _, B, S in PATH_SHAPES[:4]]
                         + RAGGED)
def test_bwd_walk_covers_every_tile_pair_once(B, S):
    """The column kernel's items, walked by its blocks, hold every
    (batch, chunk, head, I >= J) tile pair once (an item is a column
    tile J of a head group: all its heads and its row tiles I >= J); the
    row kernel's every (batch, chunk, row tile I) once."""
    nh = 80
    p = plan_bwd(B, S, nh, 64, 128, 256)
    cols, rows = _walk_items(p, B, S)
    nc, Q = p.fwd.n_chunks, p.fwd.chunk_rows
    seen = {}
    for blk in cols:
        for b, c, g, J in blk:
            nt = -(-min(Q, S - c * Q) // TILE)
            assert 0 <= J < nt and 0 <= g < p.groups
            for h in range(g * p.heads_per_group,
                           min(nh, (g + 1) * p.heads_per_group)):
                for I in range(J, nt):
                    key = (b, c, h, I, J)
                    seen[key] = seen.get(key, 0) + 1
    want = {(b, c, h, I, J) for b in range(B) for c in range(nc)
            for h in range(nh)
            for I in range(-(-min(Q, S - c * Q) // TILE))
            for J in range(I + 1)}
    assert set(seen) == want and set(seen.values()) == {1}
    got_rows = sorted(it for blk in rows for it in blk)
    assert got_rows == sorted(
        (b, c, I) for b in range(B) for c in range(nc)
        for I in range(-(-min(Q, S - c * Q) // TILE)))
    assert len(cols) == min(p.col_items, sk.SMS)


@pytest.mark.parametrize("B,S,factor", [(8, 4096, 1.05), (1, 333, 1.25)])
def test_bwd_walk_is_balanced(B, S, factor):
    """The largest block's work in the column kernel is within `factor`
    of the mean: an item's work counted as its heads x (its row tiles +
    2, the state terms' share of a head, by their products); at batch 1
    the heads are cut into groups so that there are items for every SM."""
    p = plan_bwd(B, S, 80, 64, 128, 256)
    cols, _ = _walk_items(p, B, S)
    nc, Q = p.fwd.n_chunks, p.fwd.chunk_rows
    load = []
    for blk in cols:
        w = 0
        for b, c, g, J in blk:
            nt = -(-min(Q, S - c * Q) // TILE)
            heads = min(80, (g + 1) * p.heads_per_group) \
                - g * p.heads_per_group
            w += heads * (nt - J + 2)
        load.append(w)
    assert len(load) == sk.SMS
    assert max(load) <= factor * sum(load) / len(load)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("chunk", [16, 32, 64, 100, 128, 192, 256])
@pytest.mark.parametrize("ns", [4, 16, 64, 128])
def test_bwd_shared_memory_fits_at_every_tile_count(ns, chunk, dtype):
    """Every kernel's shared memory within the card's 227 KB at each
    chunk (QP 64 to 256) and state (NSP 16 to 128) the plan takes."""
    p = plan_bwd(1, 1000, 8, 64, ns, chunk, dtype)
    assert max(p.smem) <= MAX_SMEM
    assert p.fwd.chunk_pad in (64, 128, 192, 256)
    ni, nf = (3, 3) if dtype == "float32" else (1, 2)
    assert p.smem[3] == bwd_cols_bytes(ni, nf, p.head_stages)
    assert p.head_stages == (1 if dtype == "float32" else 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch,B,S", PATH_SHAPES)
def test_bwd_plan_at_path_shapes(arch, B, S, dtype):
    B, S, nh, hd, ns, chunk, dtype = _path(arch, B, S, dtype)
    p = plan_bwd(B, S, nh, hd, ns, chunk, dtype)
    assert p.fwd == plan_launch(B, S, nh, hd, ns, chunk, dtype)
    Q = min(chunk, S)
    nc = -(-S // Q)
    QP = -(-Q // TILE) * TILE
    ntq, ntl = QP // TILE, -(-(S - (nc - 1) * Q) // TILE)
    heads = B * nc * nh
    f32 = dtype == "float32"
    # column items (batch, chunk, column tile) x head groups: groups so
    # that there are at least two items an SM, as long as a group keeps
    # a head
    units = B * ((nc - 1) * ntq + ntl)
    groups0 = min(nh, max(1, -(-264 // units)))
    assert p.heads_per_group == -(-nh // groups0)
    assert p.groups == -(-nh // p.heads_per_group)
    assert (p.groups - 1) * p.heads_per_group < nh
    assert p.col_items == units * p.groups and p.row_items == units
    wx, wb = -(-(nh * hd) // 8) * 8, -(-ns // 8) * 8
    split = 3 * B * S * (wx + 2 * wb)
    # split (f32): a thread a value, at most 4 waves of 132 blocks;
    # dstate a (head, chunk, batch); the state pass a float4 of the state
    # a thread, a (1024 elements, head, batch); the chunk terms' two
    # kernels one block an SM (or an item); finish a thread a (batch,
    # chunk, head); da a thread a head
    passes = -(-(hd * ns) // 1024)
    assert p.grids == (
        (min(-(-split // 3 // 256), 528) if f32 else 1, 1, 1),
        (nh, nc, B), (passes, nh, B), (min(p.col_items, 132), 1, 1),
        (min(units, 132), 1, 1), (-(-heads // 256), 1, 1),
        (-(-nh // 128), 1, 1))
    assert p.threads == (256, 128, 256, 160, 160, 256, 128)
    ni, nf = (3, 3) if f32 else (1, 2)
    NSP = p.fwd.ns_pad
    assert p.smem == (0, bwd_dstate_bytes(QP, NSP, ni, nf), 0,
                      _cols_by_regions(ni, nf, 1 if f32 else 2),
                      bwd_rows_bytes(ni), 0, 0)
    assert max(p.smem) <= MAX_SMEM
    up4 = lambda v: -(-v // 4) * 4
    npair, noff = ntq * (ntq + 1) // 2, ntq * (ntq - 1) // 2
    assert p.workspace == (
        max(B * nh * hd * ns, B * nc * npair * p.groups * 4096),
        heads * QP, heads * noff * 64, up4(heads * ntq),
        up4(heads * passes), up4(heads),
        B * nc * ntq * p.groups * 64 * 128 if p.groups > 1 or f32 else 0,
        up4(split // 2) if f32 else 0)
    assert all(f % 4 == 0 for f in p.workspace)
    assert p.workspace_bytes == p.fwd.workspace_bytes + 4 * sum(p.workspace)


def test_bwd_plan_at_the_training_shape():
    """mamba2-2.7b's step at batch 8 x 4096: one head group (512 column
    items and 512 row items over 132 blocks each), 190,832 bytes of
    shared memory in the column kernel, 87,120 in the row kernel, and
    0.773 GB of workspace a call: the forward's 0.726 GB recomputed, G^T
    written over F2's final state (21 MB each), the rows' dcsum terms
    and Z's row sums of the off-diagonal tile pairs."""
    p = plan_bwd(*_path("mamba2-2.7b", 8, 4096))
    assert (p.groups, p.heads_per_group, p.head_stages) == (1, 80, 2)
    assert (p.col_items, p.row_items) == (512, 512)
    assert p.grids[3] == p.grids[4] == (132, 1, 1)
    assert p.smem[3:5] == (190832, 87120)
    assert p.fwd.workspace_bytes == 725614592
    assert p.workspace[0] == 8 * 80 * 64 * 128 == 8 * 16 * 10 * 4096
    assert p.workspace_bytes == 773332992


def test_bwd_plan_at_batch_one():
    """(1, 333): six (chunk, column tile) units, so the 80 heads go in 40
    groups of 2 (240 items over 132 blocks), each group's db summed by
    the row kernel."""
    p = plan_bwd(*_path("mamba2-2.7b", 1, 333))
    assert (p.groups, p.heads_per_group) == (40, 2)
    assert (p.col_items, p.row_items) == (240, 6)
    assert p.grids[3] == (132, 1, 1) and p.grids[4] == (6, 1, 1)
    assert p.workspace[6] == 2 * 4 * 40 * 64 * 128


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
    forward's 22 int64, then the seven grids, threads, shared memory, the
    eight workspace regions, the head groups, heads a group, head stages
    and the f32 planes' row widths."""
    fields = _struct_fields("BwdPlan")
    assert fields == [("fwd", []), ("grid", [7, 3]), ("threads", [7]),
                      ("smem", [7]), ("ws", [8]), ("groups", []),
                      ("hpg", []), ("hstages", []), ("wx", []), ("wb", [])]
    p = plan_bwd(*_path(arch, B, S))
    vals = list(p.c_plan)
    assert len(vals) == 22 + 21 + 7 + 7 + 8 + 5
    assert vals[:22] == list(p.fwd.c_plan)
    assert vals[22:43] == [v for g in p.grids for v in g]
    assert vals[43:50] == list(p.threads)
    assert vals[50:57] == list(p.smem)
    assert vals[57:65] == list(p.workspace)
    assert vals[65:] == [p.groups, p.heads_per_group, p.head_stages,
                         *p.plane_widths]
    assert all(1 <= g[1] <= 65535 and 1 <= g[2] <= 65535 for g in p.grids)


@pytest.mark.parametrize("bad", [dict(hd=65), dict(hd=128), dict(ns=6),
                                 dict(chunk=2048, S=4096),
                                 dict(chunk=512, S=4096)])
def test_bwd_plan_refuses_what_the_kernel_does_not_take(bad):
    kw = dict(B=1, S=512, nh=8, hd=64, ns=128, chunk=256)
    kw.update(bad)
    with pytest.raises(ValueError):
        plan_bwd(kw["B"], kw["S"], kw["nh"], kw["hd"], kw["ns"],
                 kw["chunk"])
