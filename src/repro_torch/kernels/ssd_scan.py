"""ssd_scan — the Mamba2 SSD chunk scan as a CUDA kernel.

The wrapper of `csrc/ssd_scan.cu`, which replaces the TPU kernel
`src/repro/kernels/ssd_scan.py::ssd_scan`.  It follows the JAX model
path's `models/ssm.py::ssd_chunk_scan` contract (fp32 y and the final
fp32 state, an optional initial state, ragged S), which the decode
cache needs; the Pallas kernel returns y in x's type and no state.  It
takes CUDA tensors only (the plain version in `ref.py` serves the CPU;
`ops` dispatches) and counts its calls in `launches`: one a call, which
runs the kernel's three passes (chunk states and c.b^T, the state
recurrence across chunks, the chunk scan).

`plan_launch`, pure Python, gives the grids, the head group of the
chunk-scan pass, the padding, shared memory and workspace of a call.  It
is the plan's one owner: the wrapper passes it to the C entry
(`SsdPlan.c_plan`), which checks it against the kernels' limits and
launches it as given.

`ssd_scan_bwd` is the gradient (the Pallas kernel has none; the JAX
package differentiates its jnp scan): eight kernels a call (nine with
f32 inputs), counted once in `bwd_launches`.  It recomputes the forward's passes 1 and 2 (csum, dt,
c.b^T, the carried states) into the forward's workspace layout rather
than keeping them from the forward: at (8, 4096, 80, 64), state 128,
that workspace is about 0.72 GB a layer, which a training step would
otherwise hold for every layer between its forward and its backward.
`plan_bwd` owns the backward's grids, shared memory, workspace and the
persistent chunk-term kernels' walk (`BwdPlan.c_plan`, `struct BwdPlan`
in the source; `walk`, `col_item` and `row_item` mirror the kernels'
item order).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib

MAX_HEAD_DIM = 128     # the kernel's limits (csrc/ssd_scan.cu)
MAX_STATE = 128
MAX_CHUNK = 1024
TILE = 64              # rows of a tile: chunk rows and state rows
HEAD_GROUP = 2         # heads a chunk-scan block, picked by a chip sweep
MAX_SMEM = 232448      # bytes of shared memory a block (H100)
THREADS = 256          # of the states/CB blocks and of the state pass
BWD_MAX_HEAD_DIM = 64  # the backward's limits: one 64-wide head tile,
BWD_STATE = 128        # one 128-wide state tile,
BWD_MAX_CHUNK = 256    # four row tiles a chunk
BWD_NTQ = BWD_MAX_CHUNK // TILE
BWD_THREADS = 128      # of its dstate blocks (4 warps)
BWD_CHUNK_THREADS = 160   # of the chunk-term kernels: a consumer
                          # warpgroup and a producer warp
BWD_PASS_THREADS = 256
BWD_FINISH_THREADS = 256
BWD_DA_THREADS = 128
BWD_SPLIT_THREADS = 256   # f32 inputs cut into bf16 planes
SMS = 132              # H100 SMs: the chunk-term kernels' blocks
RING = 4               # their ring of tiles: slots of a 16 KB tile and a
SLOT_STRIDE = 16384 + 1024  # 1 KB side vector
GSLOT = 4096           # floats of a 64 x 64 G^T tile
launches = 0           # calls since the last reset
bwd_launches = 0       # backward calls since the last reset


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class SsdPlan:
    """How one call is launched (three kernels, in stream order)."""
    chunk_rows: int              # Q = min(chunk, S)
    n_chunks: int
    chunk_pad: int               # Q padded to the 64-row tile
    hd_pad: int                  # head dim padded to 16 (mma tiles)
    ns_pad: int                  # state padded to 16
    hd_tile: int                 # 64 or 128: the chunk scan's head tile
    head_group: int              # heads a chunk-scan block
    grids: Tuple[Tuple[int, int, int], ...]
    threads: Tuple[int, int, int]
    smem: Tuple[int, int, int]   # dynamic shared memory a block, bytes
    # fp32 values: chunk states, c.b^T tiles, csum and dt of each chunk,
    # the carried states as bf16 terms
    workspace: Tuple[int, int, int, int, int]

    @property
    def blocks(self) -> Tuple[int, int, int]:
        return tuple(x * y * z for x, y, z in self.grids)

    @property
    def workspace_bytes(self) -> int:
        return 4 * sum(self.workspace)

    @functools.cached_property
    def c_plan(self) -> ctypes.Array:
        """The plan as the C entry reads it (`struct Plan` in
        csrc/ssd_scan.cu): 22 int64, the grids, threads, shared memory,
        workspace floats, head group and head tile."""
        vals = ([v for g in self.grids for v in g] + list(self.threads)
                + list(self.smem) + list(self.workspace)
                + [self.head_group, self.hd_tile])
        return (ctypes.c_longlong * len(vals))(*vals)


@functools.lru_cache(maxsize=1024)
def plan_launch(B: int, S: int, nh: int, hd: int, ns: int, chunk: int,
                dtype: str = "bfloat16") -> SsdPlan:
    """The launch of one `ssd_scan` call: x (B, S, nh, hd) in `dtype`
    ("bfloat16" or "float32"), state ns, chunk `chunk`.  The chunk scan
    takes HEAD_GROUP heads a block, one where shared memory does not
    hold them."""
    if not (1 <= hd <= MAX_HEAD_DIM and 4 <= ns <= MAX_STATE
            and ns % 4 == 0 and chunk >= 1 and B >= 1 and S >= 1
            and nh >= 1 and min(chunk, S) <= MAX_CHUNK and B <= 65535):
        raise ValueError(f"ssd_scan takes head dim <= {MAX_HEAD_DIM}, "
                         f"state a multiple of 4 <= {MAX_STATE} and chunk "
                         f"<= {MAX_CHUNK}; got hd={hd}, ns={ns}, "
                         f"chunk={chunk}")
    plan = _plan(B, S, nh, hd, ns, chunk, dtype, HEAD_GROUP)
    if plan.smem[2] > MAX_SMEM:
        plan = _plan(B, S, nh, hd, ns, chunk, dtype, 1)
    if max(plan.smem) > MAX_SMEM:
        raise ValueError(f"ssd_scan: {max(plan.smem)} bytes of shared "
                         f"memory a block at chunk {chunk}, head dim {hd}, "
                         f"state {ns}")
    return plan


def _plan(B, S, nh, hd, ns, chunk, dtype, hg) -> SsdPlan:
    """The plan with the chunk scan's head group `hg`, shared memory not
    checked (`tools/ssd_scan_phases.py` sweeps hg with it)."""
    f32 = dtype == "float32"
    ni, nd = (3, 3) if f32 else (1, 2)    # bf16 terms: inputs, fp32 factors
    Q = min(chunk, S)
    nc = -(-S // Q)
    QP = _up(Q, TILE)
    ntq = QP // TILE
    HDP, NSP = _up(hd, 16), _up(ns, 16)
    hd_tile = 64 if hd <= 64 else 128
    lx = lc = 8                            # row padding, elements
    px, pb = TILE * (HDP + lx), TILE * (NSP + lc)   # bf16 tile planes

    # pass 3: csum, dt and two column factors of each head, c planes;
    # then S_prev's planes of each head, or two buffers of a c.b^T tile
    # and x planes of each head
    state = 2 * hg * nd * hd_tile * (NSP + lc)
    jbuf = 4 * TILE * (TILE + 8) + 2 * hg * ni * TILE * (hd_tile + lx)
    chunk_smem = 8 * hg * (QP + TILE) + 2 * ni * pb + max(state, 2 * jbuf)
    # pass 1: csum and w, x w planes, three buffers of b planes and (bf16)
    # raw x; or the c and b planes of a c.b^T tile
    states = 8 * QP + 2 * nd * px + 3 * 2 * (ni * pb + (0 if f32 else px))
    smem = (max(states, 4 * ni * pb), 0, chunk_smem)
    groups = -(-nh // hg)
    grids = ((nh + ntq * (ntq + 1) // 2, nc, B),
             (-(-(hd * ns // 4) // THREADS), nh, B),
             (ntq * groups, nc, B))
    return SsdPlan(Q, nc, QP, HDP, NSP, hd_tile, hg, grids,
                   (THREADS, THREADS, 128 * hg), smem,
                   (B * nc * nh * hd * ns, B * nc * QP * QP,
                    B * nc * nh * QP, B * nc * nh * QP,
                    B * nc * nh * nd * hd * NSP // 2))


def _rows(t: torch.Tensor, name: str) -> tuple:
    """(batch stride, sequence stride) of `t`, whose dims after the
    sequence must be dense."""
    want = 1
    for size, stride in zip(reversed(t.shape[2:]), reversed(t.stride()[2:])):
        if size > 1 and stride != want:
            raise ValueError(f"ssd_scan: {name} needs its trailing dims "
                             f"dense, got strides {t.stride()}")
        want *= size
    return t.stride(0), t.stride(1)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None) -> tuple:
    """x:(B,S,nh,hd) dt:(B,S,nh) a_log:(nh,) b,c:(B,S,ns) -> (y fp32
    (B,S,nh,hd), final_state fp32 (B,nh,hd,ns)).  x, b and c share one
    type (bf16 or f32) and may be views with any batch and sequence
    strides (the model passes slices of the conv output); dt and a_log
    are taken in fp32."""
    global launches
    ts = [x, dt, a_log, b, c] + ([init_state] if init_state is not None
                                 else [])
    if any(t.device.type != "cuda" or t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan needs CUDA tensors on one device, got "
                         f"{sorted({str(t.device) for t in ts})}")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes x, b, c of one type, bf16 or f32, "
                        f"got {x.dtype}, {b.dtype}, {c.dtype}")
    if x.ndim != 4 or b.ndim != 3 or b.shape != c.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    if tuple(dt.shape) != (B, S, nh) or tuple(a_log.shape) != (nh,) or \
            tuple(b.shape[:2]) != (B, S):
        raise ValueError(f"bad shapes dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)} for x {tuple(x.shape)}")
    plan = plan_launch(B, S, nh, hd, ns, chunk,
                       "bfloat16" if x.dtype == torch.bfloat16 else
                       "float32")
    if init_state is not None and tuple(init_state.shape) != (B, nh, hd,
                                                              ns):
        raise ValueError(f"init_state {tuple(init_state.shape)}, want "
                         f"{(B, nh, hd, ns)}")
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=x.device)
    fin = torch.empty((B, nh, hd, ns), dtype=torch.float32, device=x.device)
    ws = torch.empty(sum(plan.workspace), dtype=torch.float32,
                     device=x.device)
    x_sb, x_ss = _rows(x, "x")
    b_sb, b_ss = _rows(b, "b")
    c_sb, c_ss = _rows(c, "c")
    dt = dt.float().contiguous()
    a_log = a_log.float().contiguous()
    init = (init_state.float().contiguous() if init_state is not None
            else None)
    lib = _lib.lib()
    fn = lib.ssd_scan_bf16 if x.dtype == torch.bfloat16 else lib.ssd_scan_f32
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), init.data_ptr() if init is not None else None,
            y.data_ptr(), fin.data_ptr(), B, S, nh, hd, ns, chunk,
            x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, plan.c_plan,
            ws.data_ptr(), plan.workspace_bytes, _lib.stream_of(x))
    _lib.check(rc, "ssd_scan")
    launches += 1
    return y, fin


# --- the backward -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call is launched: the forward's passes 1 and 2
    as `fwd` plans them, then in stream order dstate, the state pass,
    the chunk terms (one grid, launched once for each of its dx, db and
    row roles), finish and da_log."""
    fwd: SsdPlan
    grids: Tuple[Tuple[int, int, int], ...]
    threads: Tuple[int, ...]
    smem: Tuple[int, ...]        # dynamic shared memory a block, bytes
    # fp32 values after the forward's workspace: the final state F2
    # writes, the column and row blocks' dcsum terms, the tiles' and the
    # state pass's warps' dlast parts, each chunk's sum dA dt
    workspace: Tuple[int, ...]

    @property
    def workspace_bytes(self) -> int:
        return self.fwd.workspace_bytes + 4 * sum(self.workspace)

    @functools.cached_property
    def c_plan(self) -> ctypes.Array:
        """The plan as the C entry reads it (`struct BwdPlan` in
        csrc/ssd_scan.cu): the forward's 22 int64, then 31: the grids,
        threads, shared memory and workspace floats."""
        vals = (list(self.fwd.c_plan) + [v for g in self.grids for v in g]
                + list(self.threads) + list(self.smem)
                + list(self.workspace))
        return (ctypes.c_longlong * len(vals))(*vals)


def _planes(n: int, cols: int) -> int:
    """Bytes of n bf16 planes of a 64-row tile (rows padded by 16 bytes)."""
    return 2 * n * TILE * (cols + 8)


def bwd_dstate_bytes(QP: int, NSP: int, ni: int, nf: int) -> int:
    """Shared memory of a dstate block (`bwd_dstate_bytes` in the
    source): exp(csum), e dy as `nf` bf16 planes and c as `ni`."""
    return 4 * QP + _planes(nf, BWD_MAX_HEAD_DIM) + _planes(ni, NSP)


def bwd_head_bytes(ni: int) -> int:
    """A head stage of the column kernel: x's `ni` bf16 planes (64 x 64)
    and the chunk's csum and dt (fp32, 256 rows each)."""
    return ni * TILE * TILE * 2 + 2 * 4 * BWD_NTQ * TILE


def bwd_cols_bytes(ni: int, nf: int, hs: int) -> int:
    """Shared memory of the column kernel (`bwd_cols_bytes` in the
    source): the ring, `hs` head stages, the `nf` bf16 planes it cuts
    (D, 64 x 128, or dy, 64 x 64), G^T of four tile pairs (fp32 64 x 64),
    the reduction scratch (4 x 64 + 64 + 4 floats), the mbarriers and
    1024 bytes to align the base to the swizzle's period."""
    return (RING * SLOT_STRIDE + hs * bwd_head_bytes(ni)
            + nf * TILE * BWD_STATE * 2 + BWD_NTQ * GSLOT * 4
            + 4 * (4 * TILE + TILE + 4) + 8 * (2 * RING + 2 * hs) + 1024)


def bwd_rows_bytes(ni: int) -> int:
    """Shared memory of the row kernel (`bwd_rows_bytes`): the ring, c_I's
    `ni` bf16 planes (64 x 128), the mbarriers and the alignment."""
    return (RING * SLOT_STRIDE + ni * TILE * BWD_STATE * 2
            + 8 * (2 * RING + 2) + 1024)


def walk(k: int, x: int, G: int) -> int:
    """The item rank block x of G takes in round k (`walk_rank`): rounds
    of one item a block, every other round reversed."""
    return k * G + (G - 1 - x if k & 1 else x)


def col_item(r: int, nc: int, ntq: int, ntl: int, groups: int) -> tuple:
    """The column kernel's item of rank r (`col_item`): (batch, chunk,
    head group, column tile J), J fastest; the last chunk has ntl
    tiles."""
    full = (nc - 1) * groups * ntq
    b, k = divmod(r, full + groups * ntl)
    if k < full:
        c, k = divmod(k, groups * ntq)
        return (b, c) + divmod(k, ntq)
    return (b, nc - 1) + divmod(k - full, ntl)


def row_item(r: int, nc: int, ntq: int, ntl: int) -> tuple:
    """The row kernel's item of rank r (`row_item`): (batch, chunk, row
    tile I)."""
    b, k = divmod(r, (nc - 1) * ntq + ntl)
    return (b,) + (divmod(k, ntq) if k < (nc - 1) * ntq
                   else (nc - 1, k - (nc - 1) * ntq))


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call is launched: the forward's passes 1 and 2
    as `fwd` plans them, then in stream order the f32 inputs' split
    (launched for f32 only), dstate, the state pass, the column and row
    kernels of the chunk terms (persistent: one block an SM walking its
    items), finish and da_log."""
    fwd: SsdPlan
    grids: Tuple[Tuple[int, int, int], ...]
    threads: Tuple[int, ...]
    smem: Tuple[int, ...]        # dynamic shared memory a block, bytes
    # fp32 values after the forward's workspace: F2's final state, then
    # G^T of each tile pair and head group over it; each row's dcsum
    # terms; Z's row sums of the pairs I > J; the column tiles' and the
    # state pass's blocks' dlast parts; each chunk's sum dA dt; db of
    # each head group (several groups, or f32 inputs); f32 inputs' bf16
    # planes
    workspace: Tuple[int, ...]
    groups: int                  # the column kernel's head groups
    heads_per_group: int
    head_stages: int             # its head stages (2, or 1 for f32)
    plane_widths: Tuple[int, int]   # f32 inputs' planes: x's, b's rows
    col_items: int
    row_items: int

    @property
    def workspace_bytes(self) -> int:
        return self.fwd.workspace_bytes + 4 * sum(self.workspace)

    @functools.cached_property
    def c_plan(self) -> ctypes.Array:
        """The plan as the C entry reads it (`struct BwdPlan` in
        csrc/ssd_scan.cu): the forward's 22 int64, then 48: the grids,
        threads, shared memory, workspace floats, head groups, heads a
        group, head stages and the planes' row widths."""
        vals = (list(self.fwd.c_plan) + [v for g in self.grids for v in g]
                + list(self.threads) + list(self.smem)
                + list(self.workspace)
                + [self.groups, self.heads_per_group, self.head_stages,
                   *self.plane_widths])
        return (ctypes.c_longlong * len(vals))(*vals)


@functools.lru_cache(maxsize=1024)
def plan_bwd(B: int, S: int, nh: int, hd: int, ns: int, chunk: int,
             dtype: str = "bfloat16") -> BwdPlan:
    """The launch of one `ssd_scan_bwd` call (shapes as `plan_launch`);
    the backward takes head dim <= 64 and chunk <= 256.  The column
    kernel cuts the heads into groups when the (batch, chunk, column
    tile) items alone would not give every SM two."""
    fwd = plan_launch(B, S, nh, hd, ns, chunk, dtype)
    if hd > BWD_MAX_HEAD_DIM or min(chunk, S) > BWD_MAX_CHUNK:
        raise ValueError(f"ssd_scan_bwd takes head dim <= "
                         f"{BWD_MAX_HEAD_DIM} and chunk <= {BWD_MAX_CHUNK}, "
                         f"got hd={hd}, chunk={chunk}")
    f32 = dtype == "float32"
    QP, NSP, nc = fwd.chunk_pad, fwd.ns_pad, fwd.n_chunks
    Q = fwd.chunk_rows
    ntq = QP // TILE
    ntl = -(-(S - (nc - 1) * Q) // TILE)
    # bf16 terms of an input tile and of an fp32 one
    ni, nf = (3, 3) if f32 else (1, 2)
    units = B * ((nc - 1) * ntq + ntl)     # (batch, chunk, column tile)
    hpg = -(-nh // min(nh, max(1, -(-2 * SMS // units))))
    groups = -(-nh // hpg)
    col_items, row_items = units * groups, units
    hs = 2 if bwd_cols_bytes(ni, nf, 2) <= MAX_SMEM else 1
    smem = (0, bwd_dstate_bytes(QP, NSP, ni, nf), 0,
            bwd_cols_bytes(ni, nf, hs), bwd_rows_bytes(ni), 0, 0)
    if max(smem) > MAX_SMEM:
        raise ValueError(f"ssd_scan_bwd: {max(smem)} bytes of shared "
                         f"memory a block at chunk {chunk}, state {ns}")
    heads = B * nc * nh
    wx, wb = _up(nh * hd, 8), _up(ns, 8)
    split = 3 * B * S * (wx + 2 * wb)      # bf16 values, f32 inputs only
    pass_blocks = -(-(hd * ns) // (4 * BWD_PASS_THREADS))
    grids = ((min(-(-split // 3 // BWD_SPLIT_THREADS), 4 * SMS)
              if f32 else 1, 1, 1),
             (nh, nc, B), (pass_blocks, nh, B),
             (min(col_items, SMS), 1, 1), (min(row_items, SMS), 1, 1),
             (-(-heads // BWD_FINISH_THREADS), 1, 1),
             (-(-nh // BWD_DA_THREADS), 1, 1))
    threads = (BWD_SPLIT_THREADS, BWD_THREADS, BWD_PASS_THREADS,
               BWD_CHUNK_THREADS, BWD_CHUNK_THREADS, BWD_FINISH_THREADS,
               BWD_DA_THREADS)
    npair, noff = ntq * (ntq + 1) // 2, ntq * (ntq - 1) // 2
    workspace = (max(B * nh * hd * ns, B * nc * npair * groups * GSLOT),
                 heads * QP, heads * noff * TILE, _up(heads * ntq, 4),
                 _up(heads * pass_blocks, 4), _up(heads, 4),
                 B * nc * ntq * groups * TILE * BWD_STATE
                 if groups > 1 or f32 else 0,
                 _up(split // 2, 4) if f32 else 0)
    return BwdPlan(fwd, grids, threads, smem, workspace, groups, hpg, hs,
                   (wx, wb), col_items, row_items)


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """`t` (B, S, ...) with its batch and sequence strides and its start
    on 16 bytes, as the chunk-term kernels' tensor maps need; a copy into
    rows padded to 16 bytes where they are not."""
    e = t.element_size()
    if t.data_ptr() % 16 == 0 and all(st * e % 16 == 0
                                      for st in t.stride()[:2]):
        return t
    B, S = t.shape[:2]
    width = t[0, 0].numel()
    buf = torch.zeros(B, S, _up(width, 16 // e), dtype=t.dtype,
                      device=t.device)
    buf[..., :width] = t.reshape(B, S, width)
    return buf[..., :width].view(t.shape)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int, d_final_state: Optional[torch.Tensor] = None,
                 init_state: Optional[torch.Tensor] = None) -> tuple:
    """The gradient of `ssd_scan` (same inputs, which may be views as
    there) for dy (like y) and d_final_state (B,nh,hd,ns) or None (zero)
    -> (dx like x, ddt fp32, da_log fp32, db like b, dc like c).  The
    initial state is the forward's; its gradient is not computed."""
    global bwd_launches
    ts = [x, dt, a_log, b, c, dy] + [t for t in (d_final_state, init_state)
                                     if t is not None]
    if any(t.device.type != "cuda" or t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan_bwd needs CUDA tensors on one device, "
                         f"got {sorted({str(t.device) for t in ts})}")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan_bwd takes x, b, c of one type, bf16 or "
                        f"f32, got {x.dtype}, {b.dtype}, {c.dtype}")
    if x.ndim != 4 or b.ndim != 3 or b.shape != c.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    B, S, nh, hd = x.shape
    ns = b.shape[-1]
    if tuple(dt.shape) != (B, S, nh) or tuple(a_log.shape) != (nh,) or \
            tuple(b.shape[:2]) != (B, S) or dy.shape != x.shape:
        raise ValueError(f"bad shapes dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)}, dy {tuple(dy.shape)} for x "
                         f"{tuple(x.shape)}")
    for name, t in (("d_final_state", d_final_state),
                    ("init_state", init_state)):
        if t is not None and tuple(t.shape) != (B, nh, hd, ns):
            raise ValueError(f"{name} {tuple(t.shape)}, want "
                             f"{(B, nh, hd, ns)}")
    plan = plan_bwd(B, S, nh, hd, ns, chunk,
                    "bfloat16" if x.dtype == torch.bfloat16 else "float32")
    dev = x.device
    dx = torch.empty((B, S, nh, hd), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, S, nh), dtype=torch.float32, device=dev)
    da_log = torch.empty((nh,), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, ns), dtype=b.dtype, device=dev)
    dc = torch.empty((B, S, ns), dtype=c.dtype, device=dev)
    ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                     device=dev)
    if x.dtype == torch.bfloat16:
        x, b, c = _tma_rows(x), _tma_rows(b), _tma_rows(c)
    x_sb, x_ss = _rows(x, "x")
    b_sb, b_ss = _rows(b, "b")
    c_sb, c_ss = _rows(c, "c")
    dt = dt.float().contiguous()
    a_log = a_log.float().contiguous()
    dy = dy.float().contiguous()
    dfin, init = (t.float().contiguous() if t is not None else None
                  for t in (d_final_state, init_state))
    ptr = lambda t: t.data_ptr() if t is not None else None
    lib = _lib.lib()
    fn = (lib.ssd_scan_bwd_bf16 if x.dtype == torch.bfloat16
          else lib.ssd_scan_bwd_f32)
    rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), ptr(init), dy.data_ptr(), ptr(dfin),
            dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(),
            db.data_ptr(), dc.data_ptr(), B, S, nh, hd, ns, chunk,
            x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, plan.c_plan,
            ws.data_ptr(), plan.workspace_bytes, _lib.stream_of(x))
    _lib.check(rc, "ssd_scan_bwd")
    bwd_launches += 1
    return dx, ddt, da_log, db, dc
