"""Carry the JAX package's parameters across to the port.

The JAX model keeps a flat dict of layer-stacked arrays under leaf
names like "layers/attn/wq" (with "@i" suffixes for plan segments); the
port uses the same names and shapes, so conversion is per leaf.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_torch(a: np.ndarray, device="cuda") -> torch.Tensor:
    """One array.  ml_dtypes bfloat16 (what JAX hands numpy) is refused
    by `torch.from_numpy`, so its bits travel as int16 and are
    reinterpreted."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(flat: Dict[str, np.ndarray],
                    device="cuda") -> Dict[str, torch.Tensor]:
    """{leaf name: numpy array} -> {leaf name: tensor on `device`}."""
    return {k: to_torch(np.asarray(v), device) for k, v in flat.items()}
