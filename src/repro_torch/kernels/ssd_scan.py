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
launches = 0           # calls since the last reset


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
