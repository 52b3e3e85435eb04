"""Public kernel entry points, dispatched on the tensor's device.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
This replaces the JAX package's `use_pallas()` switch: which version
runs follows from where the data lives, not from a flag.

`matmul` and `attention` are the differentiable forms the model path
calls, in training and in serving alike: `torch.autograd.Function`s
whose forward is the entry point above and whose backward is again the
kernels (`split_matmul_dgrad` / `split_matmul_wgrad`,
`flash_attention_bwd`).
"""
from __future__ import annotations

from typing import Dict, Optional

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
                 bn: int = 64, bk: int = 512,
                 transpose_w: bool = False) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) in x.dtype, fp32 accumulation; with
    `transpose_w`, w is (N,K) and x @ w^T is taken."""
    if _on_cpu(x, w):
        return ref.split_matmul_ref(x, w.t() if transpose_w else w, bk=bk)
    return _split.split_matmul(x, w, bm=bm, bn=bn, bk=bk,
                               transpose_w=transpose_w)


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


# --- differentiable forms ---------------------------------------------------
# The bodies look the dispatch functions above up at call time, so a
# caller that rebinds them (chip_smoke.py's plain-version comparison)
# routes the whole forward and backward.

class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, transpose_w):
        ctx.save_for_backward(x, w)
        ctx.transpose_w = transpose_w
        return split_matmul(x, w, transpose_w=transpose_w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        t = ctx.transpose_w
        dx = split_matmul_dgrad(dy, w, transpose_w=t) \
            if ctx.needs_input_grad[0] else None
        dw = split_matmul_wgrad(x, dy, transpose_w=t) \
            if ctx.needs_input_grad[1] else None
        return dx, dw, None


def matmul(x: torch.Tensor, w: torch.Tensor,
           transpose_w: bool = False) -> torch.Tensor:
    """x:(M,K) @ w (or w^T) through `split_matmul`, differentiable: the
    backward is `split_matmul_dgrad` and `split_matmul_wgrad`."""
    return _Matmul.apply(x, w, transpose_w)


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


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last `reset_launch_counts`."""
    return {"split_matmul": _split.launches,
            "split_matmul_dgrad": _split.dgrad_launches,
            "split_matmul_wgrad": _split.wgrad_launches,
            "flash_attention": _flash.launches,
            "flash_attention_bwd": _flash.bwd_launches,
            "ssd_scan": _ssd.launches}


def split_matmul_layout_counts() -> Dict[str, int]:
    """`split_matmul` launches of every role by operand layout ("nn",
    "nt", "tn") since the last `reset_launch_counts`."""
    return dict(_split.layout_launches)


def reset_launch_counts() -> None:
    _split.launches = _split.dgrad_launches = _split.wgrad_launches = 0
    _split.layout_launches = dict.fromkeys(_split.LAYOUTS, 0)
    _flash.launches = _flash.bwd_launches = 0
    _ssd.launches = 0
