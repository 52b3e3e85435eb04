"""ssd_scan — the Mamba2 SSD chunk scan as a CUDA kernel.

The wrapper of `csrc/ssd_scan.cu`, which replaces the TPU kernel
`src/repro/kernels/ssd_scan.py::ssd_scan`.  It follows the JAX model
path's `models/ssm.py::ssd_chunk_scan` contract (fp32 y and the final
fp32 state, an optional initial state, ragged S), which the decode
cache needs; the Pallas kernel returns y in x's type and no state.  It
takes CUDA tensors only (the plain version in `ref.py` serves the CPU;
`ops` dispatches) and counts its launches in `launches`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib

MAX_HEAD_DIM = 128     # the kernel's limits (csrc/ssd_scan.cu)
MAX_STATE = 128
MAX_CHUNK = 1024
launches = 0           # kernel launches since the last reset


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
    if not (1 <= hd <= MAX_HEAD_DIM and 4 <= ns <= MAX_STATE
            and ns % 4 == 0 and chunk >= 1
            and min(chunk, S) <= MAX_CHUNK and B <= 65535):
        raise ValueError(f"ssd_scan takes head dim <= {MAX_HEAD_DIM}, "
                         f"state a multiple of 4 <= {MAX_STATE} and chunk "
                         f"<= {MAX_CHUNK}; got hd={hd}, ns={ns}, "
                         f"chunk={chunk}")
    if init_state is not None and tuple(init_state.shape) != (B, nh, hd,
                                                              ns):
        raise ValueError(f"init_state {tuple(init_state.shape)}, want "
                         f"{(B, nh, hd, ns)}")
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=x.device)
    fin = torch.empty((B, nh, hd, ns), dtype=torch.float32, device=x.device)
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
            x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, _lib.stream_of(x))
    _lib.check(rc, "ssd_scan")
    launches += 1
    return y, fin
