"""Timed micro-benchmarks behind `python -m repro_torch calibrate`.

Three sweeps, mirroring the three fitted constants:

* :func:`matmul_sweep` — square bf16 products over a size ladder
  through `kernels.ops.split_matmul` (on the card the hand-written
  kernel the planned model runs, on the CPU its plain version); feeds
  :func:`repro_torch.calibrate.fit.fit_efficiency_curve`.
* :func:`collective_sweep` — `launch.perf_probe`'s all-gather timing
  over a `DataMesh`, swept over message sizes; feeds
  :func:`repro_torch.calibrate.fit.fit_link_calibrations`.
* :func:`remat_sweep` — the gradient of a deep ``tanh(h @ w)`` chain
  through `kernels.ops.matmul` (forward, dgrad and wgrad the
  `split_matmul` kernels on the card), plain vs every layer under
  `torch.utils.checkpoint`; feeds
  :func:`repro_torch.calibrate.fit.fit_remat_factor`.

Times are host-clock medians of calls that end in
`torch.cuda.synchronize()` on the card: what a step pays for the
product, its launch included.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

DEFAULT_MATMUL_SIZES = (64, 128, 256, 512, 1024)
DEFAULT_BW_MIB = (0.25, 1.0, 4.0, 16.0)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _median_time(fn, *args, repeats: int = 3, device="cpu") -> float:
    """Median wall-clock seconds of ``fn(*args)`` after one warm-up call,
    each call followed by a synchronise on the card."""
    fn(*args)
    _sync(device)
    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def matmul_sweep(sizes: Sequence[int] = DEFAULT_MATMUL_SIZES,
                 repeats: int = 3, device="cuda",
                 ) -> List[Tuple[float, float]]:
    """Time square bf16 products (n, n) @ (n, n) through
    `ops.split_matmul`; returns (total_flops, seconds) samples sized for
    :func:`fit.fit_efficiency_curve`."""
    out = []
    for n in sizes:
        gen = torch.Generator(device=device).manual_seed(n)
        a = torch.randn(n, n, generator=gen, device=device).bfloat16()
        b = (torch.randn(n, n, generator=gen, device=device)
             * n ** -0.5).bfloat16()
        dt = _median_time(lambda: ops.split_matmul(a, b), repeats=repeats,
                          device=device)
        out.append((2.0 * n * n * n, dt))
        del a, b
    return out


def measured_peak_flops(samples: Sequence[Tuple[float, float]]) -> float:
    """Best achieved FLOP/s across a matmul sweep — the natural peak
    to normalize an efficiency curve against when no datasheet number
    exists for the backend (CPU emulation)."""
    return max(flops / seconds for flops, seconds in samples)


def collective_sweep(mesh, sizes_mib: Sequence[float] = DEFAULT_BW_MIB,
                     repeats: int = 3) -> Dict[str, List[Tuple[float, float]]]:
    """Per-axis (bytes_moved, seconds) samples over a message-size
    ladder, via ``perf_probe.measure_level_bandwidth``.  Span-1 axes
    come back empty (they move no bytes)."""
    from repro_torch.launch.perf_probe import measure_level_bandwidth

    out: Dict[str, List[Tuple[float, float]]] = {
        str(a): [] for a in mesh.axis_names}
    for mib in sizes_mib:
        rec = measure_level_bandwidth(mesh, size_mib=mib, repeats=repeats)
        for axis, row in rec.items():
            if row["bytes_moved"] > 0:
                out[str(axis)].append(
                    (float(row["bytes_moved"]), float(row["seconds"])))
    return out


def remat_chain(depth: int, width: int, batch: int, device,
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The chain's bf16 weights (width, width), scaled by 1/sqrt(width)
    and each needing a gradient, and its input (batch, width), drawn
    from a generator seeded 1."""
    gen = torch.Generator(device=device).manual_seed(1)
    ws = [(torch.randn(width, width, generator=gen, device=device)
           * width ** -0.5).bfloat16().requires_grad_()
          for _ in range(depth)]
    x = torch.randn(batch, width, generator=gen, device=device).bfloat16()
    return ws, x


def _layer(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    return torch.tanh(ops.matmul(h, w))


def chain_grads(ws: Sequence[torch.Tensor], x: torch.Tensor,
                remat: bool) -> Tuple[torch.Tensor, ...]:
    """Gradients of sum(h * h) (fp32) over the chain h <- tanh(h @ w)
    with respect to the weights; with `remat` every layer runs under
    `checkpoint(..., use_reentrant=False)`, so the backward computes
    each layer's forward again."""
    h = x
    for w in ws:
        h = (checkpoint(_layer, w, h, use_reentrant=False) if remat
             else _layer(w, h))
    hf = h.float()
    return torch.autograd.grad((hf * hf).sum(), list(ws))


def remat_sweep(depth: int = 8, width: int = 256, batch: int = 64,
                repeats: int = 3, device="cuda") -> Tuple[float, float]:
    """(plain_seconds, remat_seconds) for the weights' gradient of a
    ``depth``-layer ``tanh(h @ w)`` chain (:func:`chain_grads`) — the
    remat variant computes every layer's forward again in the backward,
    which is what the cost model's recompute factor charges for."""
    ws, x = remat_chain(depth, width, batch, device)
    t_plain = _median_time(chain_grads, ws, x, False, repeats=repeats,
                           device=device)
    t_remat = _median_time(chain_grads, ws, x, True, repeats=repeats,
                           device=device)
    return t_plain, t_remat
