"""The key-major `flash_attention` backward's plan and arithmetic, on the CPU.

The CUDA backward (`src/repro_torch/csrc/flash_attention.cu`,
`flash_bwd_kernel`) gives each block 128 keys of one (batch, kv head)
and walks the query tiles that see them; each step's dQ tile is added
into an fp32 scratch in a fixed order of key tiles per query tile.
`kernels/flash_attention.py::plan_launch` owns what it does: the tiles,
the walk of each key tile, which tile pairs test masks per element,
shared memory and scratch sizes, and the array the C entry reads
(`BwdPlan.c_plan`, laid out as `struct BwdPlanC`); `BwdPlan` also states
the kernel's fixed orders, the dq order (key tiles decreasing) and the
ticket order in which blocks take their items (`bwd_item`, `dq_rank` in
the source, evaluated here).  Here the plan is
checked at the path shapes (qwen1.5-0.5b training (8, 4096, 16, 1, 64)
causal, phi4-mini (1, 512, 8, 3, 128), hymba-1.5b's window 1024 with
G 5) and every case `chip_smoke.py` holds the kernel to on the card
(`FLASH_BWD_CASES`), against brute force over positions, exhaustively
at small sizes and on hypothesis draws over S, T, G, window and offset.

Then `_tiled_bwd`, the kernel's arithmetic in plain PyTorch launched as
the plan says (the walks, masks only on edge pairs, P and dS rounded to
bf16 where the kernel's second products take them, dq summed in fp32
over key tiles in the plan's order), is held against `jax.grad` of the
JAX model path's `models/attention.py::flash_attention` and against the
port's plain version `ref.flash_attention_bwd_ref`.

Tolerance: 2e-2 of the largest entry plus 2e-2 relative, as the kernels
are held on the card.  bf16 inputs, compared in fp32: the mirror rounds
P and dS to bf16 (a relative 2^-9 each) and its outputs to bf16 (2^-9 of
an O(1) result), which the fp32 references do not.

Nothing here builds or loads the CUDA library; every tensor is under a
few MB (the path shapes are checked tile by tile, without tensors).
"""
import math
import re
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.models import attention as jattn
from repro_torch.configs import get_arch
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (MAX_SMEM, BwdPlan,
                                                 plan_launch)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import FLASH_BWD_CASES  # noqa: E402

TOL = 2e-2


def _path_shapes():
    """(B, S, T, KV, G, hd, causal, window, q_offset) of the paths."""
    qw, phi, hy = (get_arch(a) for a in ("qwen1.5-0.5b", "phi4-mini-3.8b",
                                         "hymba-1.5b"))
    out = []
    for cfg, B, S in ((qw, 8, 4096), (phi, 1, 512), (hy, 1, 1500)):
        G = cfg.n_heads // cfg.n_kv_heads
        out.append((B, S, S, cfg.n_kv_heads, G, cfg.resolved_head_dim, True,
                    cfg.sliding_window, 0))
    return out


PLAN_CASES = _path_shapes() + [tuple(c[:9]) for c in FLASH_BWD_CASES]


def _plan(case) -> BwdPlan:
    return plan_launch(*case)


def _rect(p: BwdPlan, qt: int, kt: int):
    """(any, all): whether some / every (row, key) pair of the tile pair
    is visible, by brute force over the tile's real rows and its nominal
    keys (keys past T are never visible)."""
    r0, r1 = qt * p.rows, min(p.S * p.G, (qt + 1) * p.rows)
    pos = p.q_offset + np.arange(r0, r1) // p.G
    key = np.arange(kt * p.bk, (kt + 1) * p.bk)
    vis = np.broadcast_to(key[:, None] < p.T, (len(key), len(pos))).copy()
    if p.causal:
        vis &= key[:, None] <= pos[None, :]
    if p.window:
        vis &= pos[None, :] - key[:, None] < p.window
    return bool(vis.any()), bool(vis.all())


def _check_plan(p: BwdPlan) -> None:
    """Walks, kt ranges, masks and the dq order against brute force."""
    seen = {}
    for kt in range(p.n_kt):
        qb, qe = p.walk(kt)
        assert 0 <= qb <= qe <= p.n_qt
        for qt in range(p.n_qt):
            any_, all_ = _rect(p, qt, kt)
            # a key tile walks exactly the query tiles it shares a
            # visible pair with
            assert (qb <= qt < qe) == any_, (qt, kt)
            # only edge pairs test masks, and every edge pair does
            assert p.full(qt, kt) == all_, (qt, kt)
            if any_:
                seen.setdefault(qt, []).append(kt)
    for qt in range(p.n_qt):
        want = sorted(seen.get(qt, []), reverse=True)
        lo, hi = p.kt_range(qt)
        assert p.order(qt) == want, qt
        assert (lo > hi) == (not want)
        if want:
            # contiguous: the counter's rank of key tile kt is its index
            assert sorted(want) == list(range(lo, hi + 1))


def _check_tickets(p: BwdPlan) -> None:
    """Each item once, and each key tile's predecessor in every query
    tile's order takes an earlier ticket (forward progress)."""
    ticket = {}
    for t, item in enumerate(p.tickets()):
        assert item not in ticket
        ticket[item] = t
    assert len(ticket) == p.items == p.B * p.KV * p.n_kt
    for qt in range(p.n_qt):
        order = p.order(qt)
        for bh in range(p.B * p.KV):
            ts = [ticket[(bh, kt)] for kt in order]
            assert ts == sorted(ts), (qt, bh)


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_plan_at_path_shapes_and_chip_cases(case):
    p = _plan(case)
    B, S, T, KV, G, hd = case[:6]
    assert p.bq == (128 if hd == 64 else 64) and p.bk == 128
    assert p.rows == p.bq // G * G and p.rows % G == 0
    assert p.n_qt * p.rows >= S * G > (p.n_qt - 1) * p.rows
    assert p.n_kt * p.bk >= T > (p.n_kt - 1) * p.bk
    assert p.smem <= MAX_SMEM
    assert p.acc_floats == B * KV * p.n_qt * p.bq * hd
    assert p.row_floats == B * KV * p.n_qt * 3 * p.bq
    assert p.counter_ints == B * KV * p.n_qt + 1
    assert p.store_blocks * 256 >= p.acc_floats // 4
    _check_plan(p)
    if p.items <= 4096:
        _check_tickets(p)


def test_qwen_training_plan_numbers():
    """(8, 4096, 16, 1, 64) causal: 32 x 32 tiles of 128, 4096 blocks,
    128 MiB of dq scratch, masks on the 32 diagonal pairs only."""
    p = _plan(_path_shapes()[0])
    assert (p.n_qt, p.n_kt, p.items) == (32, 32, 4096)
    assert p.acc_floats * 4 == 128 * 2 ** 20
    pairs = [(qt, kt) for kt in range(p.n_kt)
             for qt in range(*p.walk(kt))]
    assert len(pairs) == 32 * 33 // 2
    assert [(qt, kt) for qt, kt in pairs if not p.full(qt, kt)] == \
        [(i, i) for i in range(32)]
    # decreasing order: key tile j reaches query tile i at step i - j of
    # its walk, one step after key tile j + 1 reached it
    for qt in range(p.n_qt):
        order = p.order(qt)
        steps = [qt - p.walk(kt)[0] for kt in order]
        assert steps == sorted(steps) and order[0] == qt


def _check_elements(p: BwdPlan) -> None:
    """Every visible (row, key) pair lies in a tile pair the plan walks
    (the tiles partition rows and keys, so in exactly one)."""
    pos = p.q_offset + np.arange(p.S * p.G) // p.G
    key = np.arange(p.T)
    vis = np.ones((p.S * p.G, p.T), dtype=bool)
    if p.causal:
        vis &= key[None, :] <= pos[:, None]
    if p.window:
        vis &= pos[:, None] - key[None, :] < p.window
    walked = np.zeros((p.n_qt, p.n_kt), dtype=bool)
    for kt in range(p.n_kt):
        walked[slice(*p.walk(kt)), kt] = True
    r_i, k_i = np.nonzero(vis)
    assert walked[r_i // p.rows, k_i // p.bk].all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5, 130])
@pytest.mark.parametrize("G", [1, 3, 5])
def test_plan_exhaustive_at_small_sizes(G, window, causal):
    """Every S and T up to two tiles past a tile edge, offsets 0 and 100,
    both head dims: walks, masks, orders and tickets against brute
    force, element by element."""
    for hd in (64, 128):
        for S in (1, 7, 64 // G + 1, 130 // G, 300 // G):
            for T in (1, 127, 128, 129, 300):
                for q_offset in (0, 100):
                    p = plan_launch(1, S, T, 1, G, hd, causal, window,
                                    q_offset)
                    _check_plan(p)
                    _check_elements(p)
                    _check_tickets(p)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(S=st.integers(1, 70), T=st.integers(1, 300), G=st.integers(1, 7),
       window=st.sampled_from([0, 1, 5, 64, 130]),
       q_offset=st.integers(0, 260), causal=st.booleans(),
       hd=st.sampled_from([64, 128]))
def test_plan_covers_every_visible_pair(S, T, G, window, q_offset, causal,
                                        hd):
    """Element by element: every visible (row, key) pair lies in exactly
    one tile pair the plan walks, and is masked out of none."""
    p = plan_launch(1, S, T, 1, G, hd, causal, window, q_offset)
    _check_plan(p)
    _check_elements(p)
    _check_tickets(p)


def _c_function(src: str, name: str) -> str:
    """The return expression of the one-line device function `name` of
    the source, as Python (ints are non-negative: / is //)."""
    body = re.search(rf"\b{name}\([^)]*\) \{{\s*return ([^;]*);", src)
    return body.group(1).replace("make_int2", "").replace("/", "//")


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_kernel_orders_are_the_plans(case):
    """The kernel's ticket decode (`bwd_item`) gives `tickets()`, and its
    dq rank (`dq_rank`) each key tile's index in `order(qt)`."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    item, rank = (_c_function(src, f) for f in ("bwd_item", "dq_rank"))
    p = _plan(case)
    BH, n_kt = p.B * p.KV, p.n_kt
    assert [eval(item, dict(t=t, n_kt=n_kt, BH=BH))
            for t in range(p.items)] == list(p.tickets())
    for qt in range(p.n_qt):
        lo, hi = p.kt_range(qt)
        assert [eval(rank, dict(kt=kt, lo=lo, hi=hi))
                for kt in p.order(qt)] == list(range(hi - lo + 1))


def test_c_plan_matches_the_c_struct():
    """`c_plan` holds the fields of `struct BwdPlanC` (csrc), in order,
    as int64."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention.cu").read_text()
    body = re.search(r"struct BwdPlanC \{\s*long long ([^;]*);", src)
    fields = tuple(f.strip() for f in body.group(1).split(","))
    assert fields == BwdPlan.C_FIELDS
    p = _plan(_path_shapes()[1])
    assert len(p.c_plan) == len(fields)
    assert list(p.c_plan) == [int(getattr(p, f)) for f in fields]
    for name, want in (("BWD_BK", p.bk), ("BWD_STAGES", p.stages)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) \
            == str(want)


@pytest.mark.parametrize("args", [
    (1, 64, 64, 1, 1, 96, True, 0, 0),       # head dim not built
    (1, 64, 64, 1, 129, 64, True, 0, 0),     # G above a 128-row tile
    (1, 64, 64, 1, 65, 128, True, 0, 0),     # G above a 64-row tile
    (1, 64, 64, 1, 1, 64, True, 0, -1),      # negative offset
    (1, 64, 64, 1, 1, 64, True, -4, 0),      # negative window
    (1, 0, 64, 1, 1, 64, True, 0, 0),        # empty
], ids=str)
def test_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        plan_launch(*args)


# --- the kernel's arithmetic against jax.grad ------------------------------

# (B, S, T, KV, G, hd, causal, window, q_offset): several query and key
# tiles each, G 3, 5 and 7 (pad rows), ragged ends, windows, offsets,
# T != S
MIRROR_CASES = [
    (1, 300, 300, 2, 3, 64, True, 0, 0),
    (1, 150, 200, 1, 1, 128, True, 70, 40),
    (2, 150, 140, 1, 1, 64, False, 0, 0),
    (1, 60, 290, 1, 3, 128, True, 0, 230),
    (1, 40, 40, 2, 5, 64, True, 17, 0),
    (1, 100, 260, 1, 1, 64, True, 64, 150),
    (2, 33, 33, 1, 7, 128, True, 0, 0),
]


def _tiled_bwd(p: BwdPlan, q, k, v, o, lse, dout) -> tuple:
    """The key-major kernel's arithmetic (`flash_bwd_kernel`) launched as
    plan `p`: for each key tile and each query tile of its walk, S^T and
    dP^T in fp32, P = exp2(S scale log2e - lse log2e), masked only on the
    plan's edge pairs, dS = P (dP - D); P and dS rounded to bf16 as the
    kernel's second products take them; dV += P^T dO, dK += dS^T q in
    fp32; each query tile's dQ tiles dS k summed in fp32 in the order
    `p.order(qt)`.  Same contract as `ref.flash_attention_bwd_ref`."""
    B, S, KV, G, hd = q.shape
    T, n = k.shape[1], S * G
    scale = 1.0 / math.sqrt(hd)
    log2e = 1.4426950408889634
    rowm = lambda t: t.float().permute(0, 2, 1, 3, 4).reshape(B, KV, n, -1)
    qr, dor = rowm(q), rowm(dout)
    dsum = (dout.float() * o.float()).sum(-1)            # (B,S,KV,G)
    dsum = dsum.permute(0, 2, 1, 3).reshape(B, KV, n)
    lse2 = (lse.float() * log2e).permute(0, 2, 1, 3).reshape(B, KV, n)
    pos = p.q_offset + torch.arange(n) // G
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))  # (B,KV,T,hd)
    key = torch.arange(T)
    bf = lambda t: t.to(torch.bfloat16).float()
    dk = torch.zeros(B, KV, T, hd)
    dv = torch.zeros_like(dk)
    parts = {}                                   # (qt, kt) -> dQ tile
    for kt in range(p.n_kt):
        ks = slice(kt * p.bk, min(T, (kt + 1) * p.bk))
        for qt in range(*p.walk(kt)):
            rs = slice(qt * p.rows, min(n, (qt + 1) * p.rows))
            s = torch.einsum("bhkd,bhrd->bhkr", kf[:, :, ks], qr[:, :, rs])
            x = s * (scale * log2e) - lse2[:, :, None, rs]
            if not p.full(qt, kt):
                vis = torch.ones(x.shape[-2:], dtype=torch.bool)
                if p.causal:
                    vis &= key[ks, None] <= pos[None, rs]
                if p.window:
                    vis &= pos[None, rs] - key[ks, None] < p.window
                x = torch.where(vis, x, torch.tensor(-math.inf))
            pt = torch.exp2(x)
            dp = torch.einsum("bhkd,bhrd->bhkr", vf[:, :, ks], dor[:, :, rs])
            ds = bf(pt * (dp - dsum[:, :, None, rs]))
            dv[:, :, ks] += torch.einsum("bhkr,bhrd->bhkd", bf(pt),
                                         dor[:, :, rs])
            dk[:, :, ks] += torch.einsum("bhkr,bhrd->bhkd", ds, qr[:, :, rs])
            parts[qt, kt] = torch.einsum("bhkr,bhkd->bhrd", ds, kf[:, :, ks])
    dq = torch.zeros(B, KV, n, hd)
    for qt in range(p.n_qt):
        order = p.order(qt)
        if order:
            acc = parts.pop((qt, order[0]))
            for kt in order[1:]:
                acc = acc + parts.pop((qt, kt))
            dq[:, :, qt * p.rows:qt * p.rows + acc.shape[2]] = acc
    assert not parts, "a walked tile pair outside every dq order"
    dq = (dq * scale).reshape(B, KV, S, G, hd).permute(0, 2, 1, 3, 4)
    back = lambda t: t.permute(0, 2, 1, 3)
    return (dq.to(q.dtype), back(dk * scale).to(k.dtype),
            back(dv).to(v.dtype))


def _bf16(rng, shape):
    return rng.standard_normal(shape).astype(np.float32).astype(
        ml_dtypes.bfloat16)


@lru_cache(maxsize=None)
def _case(case):
    """bf16 inputs (numpy), the plain forward's o (bf16) and lse, and
    jax.grad of sum(flash(q, k, v) * do) in fp32 on the same values."""
    B, S, T, KV, G, hd, causal, window, q_offset = case
    rng = np.random.default_rng(S + T + hd)
    q, do = _bf16(rng, (B, S, KV, G, hd)), _bf16(rng, (B, S, KV, G, hd))
    k, v = _bf16(rng, (B, T, KV, hd)), _bf16(rng, (B, T, KV, hd))
    tq, tk, tv, tdo = (torch.from_numpy(a.astype(np.float32)).bfloat16()
                       for a in (q, k, v, do))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = ref.flash_attention_ref(tq.float(), tk.float(), tv.float(),
                                     return_lse=True, **kw)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))

    def f(q_, k_, v_):
        return jnp.sum(jattn.flash_attention(q_, k_, v_, **kw) * f32(do))
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(f32(q), f32(k), f32(v))
    return (tq, tk, tv, o.bfloat16(), lse, tdo), kw, \
        [np.asarray(w) for w in want]


def _close(got, want, what, tol=TOL):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * top,
                               err_msg=what)


@pytest.mark.parametrize("case", MIRROR_CASES, ids=str)
def test_tiled_mirror_matches_jax_grad_and_the_plain_backward(case):
    args, kw, want = _case(case)
    got = _tiled_bwd(_plan(case), *args)
    plain = ref.flash_attention_bwd_ref(*args, **kw)
    for name, g, w, pl, t in zip(("dq", "dk", "dv"), got, want, plain,
                                 args[:3]):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        _close(g, w, f"{name} {case} against jax.grad")
        _close(g, pl, f"{name} {case} against the plain backward")
