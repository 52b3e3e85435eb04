"""Build and load the CUDA kernels of `src/repro_torch/csrc/`.

The sources are compiled with `nvcc` for `sm_90a` into one shared
library with a plain C interface, loaded with `ctypes` at first use.
Each source is compiled by its own `nvcc` process, all started together,
then linked.  The library lands in `build/` at the repository root,
named by a hash of the sources and flags, so an edit rebuilds it.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = ROOT / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ["-O3", "-std=c++17", ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_log = ""            # nvcc's output of the last build (ptxas -v lines)
build_seconds = 0.0       # wall time of the last build, 0 when cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):     # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every `csrc/*.cu` (in parallel) and link the library;
    returns its path.  Reuses an existing library with the same hash."""
    global build_log, build_seconds
    out_dir = BUILD / f"kernels-{_digest()}"
    so = out_dir / "librepro_torch_kernels.so"
    if so.is_file():
        build_seconds = 0.0
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, objs = [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"--- {src.name}\n{text}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        objs.append(str(obj))
    tmp = so.with_suffix(".so.tmp")
    link = subprocess.run([nvcc, ARCH, "-shared", "-o", str(tmp), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    tmp.replace(so)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.split_matmul_bf16.argtypes = [p, p, p, i, i, i, i, p]
        handle.split_matmul_f32.argtypes = [p, p, p, i, i, i, i, p]
        for fn in (handle.split_matmul_stream_bf16,
                   handle.split_matmul_wgmma_bf16):
            fn.argtypes = [p, p, p, p] + [i] * 7 + [p]
        handle.flash_attention_fwd.argtypes = [
            p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        ll = ctypes.c_longlong
        for fn in (handle.ssd_scan_bf16, handle.ssd_scan_f32):
            fn.argtypes = [p] * 8 + [i] * 6 + [ll] * 6 + [p]
        for fn in (handle.split_matmul_bf16, handle.split_matmul_f32,
                   handle.split_matmul_stream_bf16,
                   handle.split_matmul_wgmma_bf16,
                   handle.flash_attention_fwd, handle.ssd_scan_bf16,
                   handle.ssd_scan_f32):
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the C entry points
    take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
