"""flash_attention — online-softmax GQA attention as a CUDA kernel.

The wrapper of `csrc/flash_attention.cu`, which replaces the TPU kernel
`src/repro/kernels/flash_attention.py::flash_attention`, in the model
layout (no transposes): bf16 on the tensor cores (mma.sync, cp.async
double-buffered K/V tiles), float32 on CUDA cores.  CUDA tensors only
(the plain version in `ref.py` serves the CPU; `ops` dispatches);
counts its launches in `launches`.

For training the forward also writes each row's logsumexp (fp32,
(B, S, KV, G)), and `flash_attention_bwd` computes dq, dk, dv from it,
bf16 only (training on the card is bf16), counted in `bwd_launches`.
The TPU kernel has no backward: the JAX package trains through its jnp
twin.  The backward is three kernels: a row pass (D = rowsum(dO o), lse
in log2 units, positions); one key-major kernel on TMA and wgmma in
which a block owns 128 keys of one (batch, kv head), keeps K, V, dK and
dV on chip for its walk over the query tiles that see them, and has the
copy engine add each step's dQ tile into an fp32 scratch in a fixed
order of key tiles, gated by a counter per query tile, so a repeated
call is bit-identical; and a pass that casts that sum to bf16 dq.

`plan_launch`, pure Python, gives the backward's tiles, grid, which tile
pairs need masks, shared memory and scratch sizes (`BwdPlan`), and says
in which order the kernel takes its items and sums dq (fixed: key tiles
decreasing, a head's key tiles together).  It is the plan's one owner:
the wrapper passes it to the C entry (`BwdPlan.c_plan`), which checks it
against the shapes and launches it as given; the CPU tests check what it
says the kernel does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Iterator, List, Tuple

import torch

from repro_torch.kernels import _lib

HEAD_DIMS = (64, 128)  # head dims the kernel is compiled for
launches = 0           # forward launches since the last reset
bwd_launches = 0       # backward launches

BWD_BK = 128           # keys a backward block (csrc: BWD_BK)
BWD_STAGES = 3         # the Q/dO ring's depth (csrc: BWD_STAGES)
MAX_SMEM = 232448      # bytes of shared memory a block (H100)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *more: torch.Tensor) -> None:
    ts = (q, k, v) + more
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError("flash_attention needs CUDA tensors on one device")
    if any(t.dtype != q.dtype for t in ts) \
            or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bf16 or f32, got "
                        f"{[t.dtype for t in ts]}")
    if q.ndim != 5 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    B, S, KV, G, hd = q.shape
    if k.shape[0] != B or k.shape[2] != KV or k.shape[3] != hd:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} disagree")
    if any(t.shape != q.shape for t in more):
        raise ValueError("o and dout must be shaped like q")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: kernel built for {HEAD_DIMS}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention needs contiguous inputs")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention in bf16 copies 16-byte rows: "
                         "base pointers must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, q_offset: int = 0,
                    return_lse: bool = False):
    """q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> (B,S,KV,G,hd) in q.dtype, and
    with `return_lse` also each row's logsumexp (fp32, (B,S,KV,G)).
    Query s sits at position q_offset + s, key t at t; ragged S, T."""
    global launches
    _check(q, k, v)
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((B, S, KV, G), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    rc = _lib.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, S, T, KV, G, hd, int(causal), int(window), int(q_offset),
        1.0 / math.sqrt(hd), 1 if q.dtype == torch.bfloat16 else 0,
        _lib.stream_of(q))
    _lib.check(rc, "flash_attention")
    launches += 1
    return (out, lse) if return_lse else out


# --- the backward's plan -------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call is launched, and what its key-major kernel
    does: a block takes the item (batch * KV + kv head, key tile) of its
    ticket and walks the query tiles `walk(kt)`; query tile qt gets the
    dQ tiles of key tiles `order(qt)` in that order.  The geometry
    mirrors `struct BwdGeom` in csrc/flash_attention.cu, the orders its
    `bwd_item` and `dq_rank`."""
    B: int
    S: int
    T: int
    KV: int
    G: int
    hd: int
    causal: bool
    window: int
    q_offset: int
    bq: int             # query rows a step (a tile, pad rows included)
    rows: int           # real rows a query tile: (bq // G) * G
    bk: int             # keys a key tile (a block)
    stages: int
    n_qt: int
    n_kt: int
    items: int          # blocks: B * KV * n_kt
    smem: int           # dynamic shared memory of a block, bytes
    row_floats: int     # fp32 row values (lse2, D, position) a call
    acc_floats: int     # fp32 dq scratch
    counter_ints: int   # int32 counters: the ticket, one a query tile
    row_blocks: int     # blocks of the row pass (256 threads, hd/8 a row)
    store_blocks: int   # blocks of the dq pass (256 threads, a float4 each)

    C_FIELDS = ("bq", "rows", "bk", "stages", "n_qt", "n_kt", "items",
                "smem", "row_floats", "acc_floats", "counter_ints",
                "row_blocks", "store_blocks")

    @functools.cached_property
    def c_plan(self) -> ctypes.Array:
        """The plan as the C entry reads it (`struct BwdPlanC`): int64
        values in `C_FIELDS` order."""
        vals = [int(getattr(self, f)) for f in self.C_FIELDS]
        return (ctypes.c_longlong * len(vals))(*vals)

    # geometry: positions and keys are the contract's (query s at
    # q_offset + s, key t at t); rows are (s, g) flattened
    def pos_lo(self, qt: int) -> int:
        return self.q_offset + qt * self.rows // self.G

    def pos_hi(self, qt: int) -> int:
        end = min(self.S * self.G, (qt + 1) * self.rows)
        return self.q_offset + (end - 1) // self.G

    def kt_range(self, qt: int) -> Tuple[int, int]:
        """(lo, hi): the key tiles some row of query tile qt sees;
        empty when lo > hi."""
        lo = max(0, self.pos_lo(qt) - self.window + 1) if self.window else 0
        hi = min(self.T - 1, self.pos_hi(qt)) if self.causal else self.T - 1
        return lo // self.bk, (hi // self.bk if hi >= lo
                               else lo // self.bk - 1)

    def walk(self, kt: int) -> Tuple[int, int]:
        """[qb, qe): the query tiles that see some key of key tile kt."""
        k0 = kt * self.bk
        k1 = min(self.T, k0 + self.bk) - 1
        s_lo = min(self.S, max(0, k0 - self.q_offset)) if self.causal else 0
        s_hi = (min(self.S, max(0, k1 + self.window - self.q_offset))
                if self.window else self.S)
        qb = s_lo * self.G // self.rows
        qe = _cdiv(s_hi * self.G, self.rows) if s_hi > s_lo else qb
        return qb, qe

    def full(self, qt: int, kt: int) -> bool:
        """Every (row, key) pair of the tile pair visible: no mask."""
        k0 = kt * self.bk
        k1 = k0 + self.bk - 1
        return (k1 < self.T
                and (not self.causal or k1 <= self.pos_lo(qt))
                and (not self.window or self.pos_hi(qt) - k0 < self.window))

    def order(self, qt: int) -> List[int]:
        """The key tiles that add into query tile qt's fp32 dq sum, in
        order, decreasing (causal key tile j reaches query tile i at step
        i - j of its walk): the first writes, the others add."""
        lo, hi = self.kt_range(qt)
        return list(range(hi, lo - 1, -1))

    def tickets(self) -> Iterator[Tuple[int, int]]:
        """(batch * KV + kv head, key tile) of tickets 0, 1, ...: a block
        takes the item of the ticket it draws at its start.  A head's key
        tiles come together (they share q, dO and dq tiles in L2), the
        highest first, so each comes after those it waits for."""
        for t in range(self.items):
            yield t // self.n_kt, self.n_kt - 1 - t % self.n_kt


def bwd_bq(hd: int) -> int:
    """Query rows a backward step (csrc: Bwd<HD>::BQ): 128 at hd 64, 64
    at hd 128, so that dK, dV, S^T and dP^T fit the registers."""
    return 128 if hd == 64 else 64


def bwd_smem(hd: int) -> int:
    """Dynamic shared memory of a backward block (csrc: Bwd<HD>::SMEM):
    K and V, dS^T, the fp32 dQ tile staged for its add, the ring of Q,
    dO and row values, barriers, and 1 KB to align the ring to the
    swizzle's period."""
    bq, nb = bwd_bq(hd), hd // 64
    kv, ds, qb = nb * BWD_BK * 128, BWD_BK * bq * 2, nb * bq * 128
    stage = 2 * qb + _cdiv(3 * bq * 4, 1024) * 1024
    return 2 * kv + ds + bq * hd * 4 + BWD_STAGES * stage + 1024 + 1024


@functools.lru_cache(maxsize=1024)
def plan_launch(B: int, S: int, T: int, KV: int, G: int, hd: int,
                causal: bool, window: int = 0,
                q_offset: int = 0) -> BwdPlan:
    """The launch of one backward call at q (B, S, KV, G, hd), k and v
    (B, T, KV, hd)."""
    bq = bwd_bq(hd)
    if not (hd in HEAD_DIMS and B >= 1 and S >= 1 and T >= 1 and KV >= 1
            and 1 <= G <= bq and q_offset >= 0 and window >= 0):
        raise ValueError(
            f"flash_attention_bwd takes head dim in {HEAD_DIMS}, 1 <= G <= "
            f"{bq} query heads a kv head, q_offset >= 0 and window "
            f">= 0; got B={B} S={S} T={T} KV={KV} G={G} hd={hd} "
            f"window={window} q_offset={q_offset}")
    rows = bq // G * G
    n_qt, n_kt = _cdiv(S * G, rows), _cdiv(T, BWD_BK)
    tiles = B * KV * n_qt
    plan = BwdPlan(B, S, T, KV, G, hd, bool(causal), int(window),
                   int(q_offset), bq, rows, BWD_BK, BWD_STAGES, n_qt, n_kt,
                   B * KV * n_kt, bwd_smem(hd), tiles * 3 * bq,
                   tiles * bq * hd,
                   tiles + 1, _cdiv(tiles * bq * hd // 8, 256),
                   _cdiv(tiles * bq * hd // 4, 256))
    if plan.items >= 2 ** 31 or plan.row_blocks >= 2 ** 31:
        raise ValueError(f"flash_attention_bwd: {plan.items} blocks exceed "
                         f"one launch")
    if plan.smem > MAX_SMEM:
        raise ValueError(f"flash_attention_bwd: {plan.smem} bytes of "
                         f"shared memory a block")
    return plan


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool, window: int = 0,
                        q_offset: int = 0) -> tuple:
    """(dq, dk, dv) of `flash_attention` at (q, k, v) for the output
    gradient `dout`, from its output `o` and logsumexp `lse`; dk and dv
    summed over the G query heads of each kv head.  bf16 only."""
    global bwd_launches
    _check(q, k, v, o, dout)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd takes bf16, got {q.dtype}")
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    if lse.shape != (B, S, KV, G) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous fp32 {(B, S, KV, G)} on "
                         f"{q.device}")
    if q.numel() == 0 or k.numel() == 0:
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    plan = plan_launch(B, S, T, KV, G, hd, bool(causal), int(window),
                       int(q_offset))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dev = q.device
    rowv = torch.empty(plan.row_floats, dtype=torch.float32, device=dev)
    acc = torch.empty(plan.acc_floats, dtype=torch.float32, device=dev)
    counters = torch.zeros(plan.counter_ints, dtype=torch.int32, device=dev)
    rc = _lib.lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), rowv.data_ptr(), acc.data_ptr(), counters.data_ptr(),
        B, S, T, KV, G, hd, int(causal), int(window), int(q_offset),
        1.0 / math.sqrt(hd), plan.c_plan, _lib.stream_of(q))
    _lib.check(rc, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
