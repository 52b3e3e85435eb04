"""Public kernel entry points, dispatched on the tensor's device.

A CPU tensor takes the plain PyTorch version (`ref`); a CUDA tensor
launches the hand-written kernel or raises — there is no fallback.
This replaces the JAX package's `use_pallas()` switch: which version
runs follows from where the data lives, not from a flag.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import split_matmul as _split

def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs on {sorted(devs)}: need all on the "
                     f"CPU or all on one CUDA device")


def split_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 64,
                 bn: int = 64, bk: int = 512) -> torch.Tensor:
    """x:(M,K) @ w:(K,N) -> (M,N) in x.dtype, fp32 accumulation."""
    if _on_cpu(x, w):
        return ref.split_matmul_ref(x, w, bk=bk)
    return _split.split_matmul(x, w, bm=bm, bn=bn, bk=bk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q:(B,S,KV,G,hd) k,v:(B,T,KV,hd) -> like q."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last `reset_launch_counts`."""
    return {"split_matmul": _split.launches,
            "flash_attention": _flash.launches}


def reset_launch_counts() -> None:
    _split.launches = 0
    _flash.launches = 0
