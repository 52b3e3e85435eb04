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
package differentiates its jnp scan): nine kernels a call, counted once
in `bwd_launches`.  It recomputes the forward's passes 1 and 2 (csum, dt,
c.b^T, the carried states) into the forward's workspace layout rather
than keeping them from the forward: at (8, 4096, 80, 64), state 128,
that workspace is about 0.72 GB a layer, which a training step would
otherwise hold for every layer between its forward and its backward.
`plan_bwd` owns the backward's grids, shared memory and workspace
(`BwdPlan.c_plan`, `struct BwdPlan` in the source).
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
BWD_MAX_HEAD_DIM = 64  # the backward's limits: one 64-wide head tile
BWD_THREADS = 128      # of its dstate blocks (4 warps)
BWD_CHUNK_THREADS = 256   # of its chunk-terms blocks (8 warps)
BWD_PASS_THREADS = 256
BWD_FINISH_THREADS = 256
BWD_DA_THREADS = 128
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


def bwd_chunk_bytes(QP: int, NSP: int, ni: int, nf: int) -> int:
    """Shared memory of a chunk-terms block, the largest of its roles
    (`bwd_chunk_bytes` in the source): an fp32 head of csum, dt and six
    rows of row vectors; a dx block's x_J and the largest of its phases
    (c_J, the carried state P and dy_J; b_J and D; dy_I and a c.b^T
    tile), a db block's x_J, x_J dt w and the larger of its phases (D;
    dy_I and c_I), or a row block's dy_I, e dy_I and the larger of its
    phases (P; x_J, b_J and a c.b^T tile).  Inputs take `ni` bf16
    planes, fp32 operands (dy, D, P) `nf`."""
    HD = BWD_MAX_HEAD_DIM
    cb = 4 * TILE * (TILE + 4)
    xi, xf = _planes(ni, HD), _planes(nf, HD)
    si, sf = _planes(ni, NSP), _planes(nf, NSP)
    dx = xi + max(si + sf + xf, si + sf, xf + cb)
    db = xi + xf + max(sf, xf + si)
    row = 2 * xf + max(sf, xi + si + cb)
    return 4 * (2 * QP + 6 * TILE) + max(dx, db, row)


@functools.lru_cache(maxsize=1024)
def plan_bwd(B: int, S: int, nh: int, hd: int, ns: int, chunk: int,
             dtype: str = "bfloat16") -> BwdPlan:
    """The launch of one `ssd_scan_bwd` call (shapes as `plan_launch`);
    the backward takes head dim <= 64."""
    fwd = plan_launch(B, S, nh, hd, ns, chunk, dtype)
    if hd > BWD_MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan_bwd takes head dim <= "
                         f"{BWD_MAX_HEAD_DIM}, got {hd}")
    QP, NSP, nc = fwd.chunk_pad, fwd.ns_pad, fwd.n_chunks
    ntq = QP // TILE
    # bf16 terms of an input tile and of an fp32 one
    ni, nf = (1, 2) if dtype == "bfloat16" else (3, 3)
    smem = (bwd_dstate_bytes(QP, NSP, ni, nf), 0,
            bwd_chunk_bytes(QP, NSP, ni, nf), 0, 0)
    if max(smem) > MAX_SMEM:
        raise ValueError(f"ssd_scan_bwd: {max(smem)} bytes of shared "
                         f"memory a block at chunk {chunk}, state {ns}")
    heads = B * nc * nh
    pass_blocks = -(-(hd * ns) // (4 * BWD_PASS_THREADS))
    grids = ((nh, nc, B), (pass_blocks, nh, B), (ntq, nc, B),
             (-(-heads // BWD_FINISH_THREADS), 1, 1),
             (-(-nh // BWD_DA_THREADS), 1, 1))
    threads = (BWD_THREADS, BWD_PASS_THREADS, BWD_CHUNK_THREADS,
               BWD_FINISH_THREADS, BWD_DA_THREADS)
    # the state pass's partial sums: one a warp of each of its blocks
    parts = pass_blocks * BWD_PASS_THREADS // 32
    workspace = (B * nh * hd * ns, heads * QP, heads * QP,
                 _up(heads * ntq, 4), _up(heads * parts, 4), _up(heads, 4))
    return BwdPlan(fwd, grids, threads, smem, workspace)


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
