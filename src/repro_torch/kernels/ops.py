"""Public kernel entry points, dispatched on the tensor's device.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
This replaces the JAX package's `use_pallas()` switch: which version
runs follows from where the data lives, not from a flag.

`matmul`, `matmul_acc`, `attention` and `ssd` are the differentiable
forms the model path calls: `torch.autograd.Function`s whose forward is
the entry point above and whose backward is again the kernels
(`split_matmul_dgrad` / `split_matmul_wgrad`, `flash_attention_bwd`,
`ssd_scan_bwd`).

A product that `sharding.specs.seg_matmul` names (its weight path, the
JAX package's `checkpoint_name` tag) runs, when gradients are being
taken, as the operator `torch.ops.repro_torch.tagged_matmul`, which
carries the tag as an argument.  The kernels launch through `ctypes`,
so the dispatcher sees nothing of them; a selective-checkpoint policy
(`models.transformer.save_only_these_names`) sees this operator, reads
its tag, and saves its output or has it recomputed.  `product_counts`
counts the tagged products actually computed, by tag: a kept product
is not computed again in the backward.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import split_matmul as _split
from repro_torch.kernels import ssd_scan as _ssd


def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on {sorted(devs)}: need all on the "
                     f"CPU or all on one CUDA device")


def split_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 64,
                 bn: int = 64, bk: int = 512, transpose_w: bool = False,
                 acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) in x.dtype, fp32 accumulation; with
    `transpose_w`, w is (N,K) and x @ w^T is taken.  With `acc` (fp32
    (M, N)) the accumulating form: the fp32 acc + x @ w."""
    if _on_cpu(x, w, *(() if acc is None else (acc,))):
        return ref.split_matmul_ref(x, w.t() if transpose_w else w, bk=bk,
                                    acc=acc)
    return _split.split_matmul(x, w, bm=bm, bn=bn, bk=bk,
                               transpose_w=transpose_w, acc=acc)


def split_matmul_dgrad(dy: torch.Tensor, w: torch.Tensor, *,
                       transpose_w: bool = False) -> torch.Tensor:
    """dx of `split_matmul(x, w, transpose_w=...)` for the output
    gradient dy."""
    dy = dy.contiguous()
    if _on_cpu(dy, w):
        return ref.split_matmul_dgrad_ref(dy, w, transpose_w=transpose_w)
    return _split.split_matmul_dgrad(dy, w, transpose_w=transpose_w)


def split_matmul_wgrad(x: torch.Tensor, dy: torch.Tensor, *,
                       transpose_w: bool = False) -> torch.Tensor:
    """dw of `split_matmul(x, w, transpose_w=...)`, shaped like w."""
    dy = dy.contiguous()
    if _on_cpu(x, dy):
        return ref.split_matmul_wgrad_ref(x, dy, transpose_w=transpose_w)
    return _split.split_matmul_wgrad(x, dy, transpose_w=transpose_w)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, q_offset: int = 0,
                    return_lse: bool = False):
    """q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> like q; with `return_lse`
    also each row's logsumexp (fp32, (B,S,KV,G))."""
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              return_lse=return_lse)
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, **kw)
    return _flash.flash_attention(q, k, v, **kw)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool, window: int = 0,
                        q_offset: int = 0) -> tuple:
    """(dq, dk, dv) of `flash_attention` from its output and logsumexp."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dout = dout.contiguous()
    if _on_cpu(q, k, v, o, lse, dout):
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, dout, **kw)
    return _flash.flash_attention_bwd(q, k, v, o, lse, dout, **kw)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int,
             init_state: Optional[torch.Tensor] = None) -> tuple:
    """x:(B,S,nh,hd) dt:(B,S,nh) a_log:(nh,) b,c:(B,S,ns) -> (y fp32,
    final_state fp32 (B,nh,hd,ns))."""
    ts = (x, dt, a_log, b, c) + ((init_state,) if init_state is not None
                                 else ())
    if _on_cpu(*ts):
        return ref.ssd_scan_ref(x, dt, a_log, b, c, chunk=chunk,
                                init_state=init_state)
    return _ssd.ssd_scan(x, dt, a_log, b, c, chunk=chunk,
                         init_state=init_state)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor, *,
                 chunk: int, d_final_state: Optional[torch.Tensor] = None,
                 init_state: Optional[torch.Tensor] = None) -> tuple:
    """(dx, ddt fp32, da_log fp32, db, dc) of `ssd_scan` for the
    cotangents dy (fp32, like y) and d_final_state (None: zero)."""
    ts = (x, dt, a_log, b, c, dy) + tuple(
        t for t in (d_final_state, init_state) if t is not None)
    kw = dict(chunk=chunk, d_final_state=d_final_state,
              init_state=init_state)
    if _on_cpu(*ts):
        return ref.ssd_scan_bwd_ref(x, dt, a_log, b, c, dy, **kw)
    return _ssd.ssd_scan_bwd(x, dt, a_log, b, c, dy, **kw)


# --- differentiable forms ---------------------------------------------------
# The bodies look the dispatch functions above up at call time, so a
# caller that rebinds them (chip_smoke.py's plain-version comparison)
# routes the whole forward and backward.

product_counts: Dict[str, int] = {}   # tagged products computed, by tag


def _products(x: torch.Tensor, ws: List[torch.Tensor], transpose_w: bool,
              tag: str) -> torch.Tensor:
    """x @ w for one weight; for several, the sum over the weights of
    x's matching column slice times each (the input-dim split of
    `seg_matmul`, summed in the weights' order in x's dtype)."""
    if tag:
        product_counts[tag] = product_counts.get(tag, 0) + 1
    if len(ws) == 1:
        return split_matmul(x, ws[0], transpose_w=transpose_w)
    y, off = None, 0
    for w in ws:
        part = split_matmul(x[:, off:off + w.shape[0]].contiguous(), w)
        y = part if y is None else y + part
        off += w.shape[0]
    return y


@torch.library.custom_op("repro_torch::tagged_matmul", mutates_args=())
def tagged_matmul(x: torch.Tensor, ws: List[torch.Tensor],
                  transpose_w: bool, tag: str) -> torch.Tensor:
    """`_products` as an operator the dispatcher sees, with its tag (see
    the module note); it has no gradient of its own: `_Matmul` calls it
    inside its forward."""
    return _products(x, ws, transpose_w, tag)


def _fetch(pieces, ws, backward: bool) -> List[torch.Tensor]:
    """The weights' data: each weight itself, or, where `pieces` has a
    `sharding.collectives.Piece`, the gathered piece it stands for."""
    if pieces is None:
        return list(ws)
    return [w if p is None else (p.backward() if backward else p.forward())
            for p, w in zip(pieces, ws)]


def _release(pieces) -> None:
    for p in pieces or ():
        if p is not None:
            p.release()


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, transpose_w, tag, via_op, pieces, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.transpose_w, ctx.pieces = transpose_w, pieces
        ws = _fetch(pieces, ws, backward=False)
        if via_op:
            return torch.ops.repro_torch.tagged_matmul(x, ws, transpose_w,
                                                       tag)
        return _products(x, ws, transpose_w, tag)

    @staticmethod
    def backward(ctx, dy):
        x, *ws = ctx.saved_tensors
        ws = _fetch(ctx.pieces, ws, backward=True)
        t = ctx.transpose_w
        dx = dws = None
        if len(ws) == 1:
            if ctx.needs_input_grad[0]:
                dx = split_matmul_dgrad(dy, ws[0], transpose_w=t)
            if ctx.needs_input_grad[5]:
                dws = [split_matmul_wgrad(x, dy, transpose_w=t)]
        else:   # each weight's slice of x; dx is their concatenation
            offs = [0]
            for w in ws:
                offs.append(offs[-1] + w.shape[0])
            if ctx.needs_input_grad[0]:
                dx = torch.cat([split_matmul_dgrad(dy, w) for w in ws], -1)
            if any(ctx.needs_input_grad[5:]):
                dws = [split_matmul_wgrad(x[:, a:b].contiguous(), dy)
                       for a, b in zip(offs, offs[1:])]
        _release(ctx.pieces)
        return (dx, None, None, None, None,
                *(dws if dws is not None else [None] * len(ws)))


def matmul(x: torch.Tensor, w, transpose_w: bool = False,
           tag: str = "", pieces=None) -> torch.Tensor:
    """x:(M,K) @ w (or w^T) through `split_matmul`, differentiable: the
    backward is `split_matmul_dgrad` and `split_matmul_wgrad`.  `w` may
    be a list of weights whose rows split K: the sum of x's slices times
    each.  `tag` names the output for a selective checkpoint; it goes
    through `tagged_matmul` only when gradients are being taken.
    `pieces` (one entry per weight, None for a weight that is its own
    data) marks ZDP weights: the weight is then a stand-in of no memory
    and its `Piece` gathers the data in the forward and again in the
    backward (`sharding.collectives`)."""
    ws = list(w) if isinstance(w, (list, tuple)) else [w]
    via_op = bool(tag) and torch.is_grad_enabled()
    return _Matmul.apply(x, transpose_w, tag, via_op,
                         tuple(pieces) if pieces else None, *ws)


class _MatmulAcc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, acc, piece):
        ctx.save_for_backward(x, w)
        ctx.pieces = (piece,)
        return split_matmul(x, _fetch(ctx.pieces, (w,), False)[0], acc=acc)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        (w,) = _fetch(ctx.pieces, (w,), backward=True)
        # The cotangent at the fp32 accumulator is the fp32 image of the
        # cotangent of the x.dtype result the chunked sum is cast to at
        # its end (`core.operator_split`), so casting it back to x.dtype
        # for the kernels loses nothing.
        dyc = dy.to(x.dtype)
        dx = split_matmul_dgrad(dyc, w) if ctx.needs_input_grad[0] \
            else None
        dw = split_matmul_wgrad(x, dyc) if ctx.needs_input_grad[1] \
            else None
        _release(ctx.pieces)
        return dx, dw, dy if ctx.needs_input_grad[2] else None, None


def matmul_acc(x: torch.Tensor, w: torch.Tensor, acc: torch.Tensor,
               piece=None) -> torch.Tensor:
    """The fp32 acc + x @ w through `split_matmul`'s accumulating form,
    differentiable: acc's gradient passes straight through, x's and w's
    are `split_matmul_dgrad` and `split_matmul_wgrad` of its cast.  A
    `piece` marks w as a ZDP stand-in, as in `matmul`."""
    return _MatmulAcc.apply(x, w, acc, piece)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if not any(ctx.needs_input_grad[:3]):      # serving: no lse
            return flash_attention(q, k, v, **kw)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """`flash_attention`, differentiable in q, k, v: when one of them
    needs a gradient the forward saves each row's logsumexp, and the
    backward is `flash_attention_bwd`."""
    return _Attention.apply(q, k, v, causal, window, q_offset)


class _Ssd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk, init_state):
        y, fin = ssd_scan(x, dt, a_log, b, c, chunk=chunk,
                          init_state=init_state)
        ctx.save_for_backward(x, dt, a_log, b, c, init_state)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(fin)
        return y, fin

    @staticmethod
    def backward(ctx, dy, dfin):
        x, dt, a_log, b, c, init_state = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, a_log, b, c, dy, chunk=ctx.chunk,
                             d_final_state=dfin, init_state=init_state)
        return (*grads, None, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, *, chunk: int,
        init_state: Optional[torch.Tensor] = None) -> tuple:
    """`ssd_scan`, differentiable in x, dt, a_log, b and c: the backward
    is `ssd_scan_bwd`.  The final state is not differentiated (the
    training path drops it); an `init_state` is taken as a constant and
    refused when it needs a gradient."""
    if init_state is not None and init_state.requires_grad:
        raise NotImplementedError("ssd: the gradient of init_state is not "
                                  "computed; pass it detached")
    return _Ssd.apply(x, dt, a_log, b, c, chunk, init_state)


def _split_tally(of) -> Dict[str, int]:
    """`split_matmul`'s launches summed by `of(role, layout, variant)`."""
    out: Dict[str, int] = {}
    for key, n in _split.counts.items():
        out[of(*key)] = out.get(of(*key), 0) + n
    return out


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last `reset_launch_counts`."""
    role = _split_tally(lambda r, lay, v: r)
    return {"split_matmul": role.get("fwd", 0),
            "split_matmul_acc": role.get("acc", 0),
            "split_matmul_dgrad": role.get("dgrad", 0),
            "split_matmul_wgrad": role.get("wgrad", 0),
            "flash_attention": _flash.launches,
            "flash_attention_bwd": _flash.bwd_launches,
            "ssd_scan": _ssd.launches,
            "ssd_scan_bwd": _ssd.bwd_launches}


def split_matmul_variant_counts() -> Dict[str, int]:
    """`split_matmul` launches by "role:design" (e.g. "dgrad:persistent")
    since the last `reset_launch_counts`."""
    return _split_tally(lambda r, lay, v: f"{r}:{v}")


def split_matmul_layout_counts() -> Dict[str, int]:
    """`split_matmul` launches of every role by operand layout ("nn",
    "nt", "tn") since the last `reset_launch_counts`."""
    return {**dict.fromkeys(_split.LAYOUTS, 0),
            **_split_tally(lambda r, lay, v: lay)}


def reset_launch_counts() -> None:
    """Zero the kernel launch counts and `product_counts`."""
    _split.counts.clear()
    product_counts.clear()
    _flash.launches = _flash.bwd_launches = 0
    _ssd.launches = _ssd.bwd_launches = 0
