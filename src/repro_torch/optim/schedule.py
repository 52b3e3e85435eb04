"""Warmup + cosine LR schedule (scale factor in [0, 1]).

The JAX package's `warmup_cosine`, in float32 arithmetic as there (on
the host: the scale is one number a step)."""
from __future__ import annotations

import numpy as np


def warmup_cosine(step, warmup: int = 100, total: int = 10_000,
                  min_ratio: float = 0.1) -> float:
    s = np.float32(step)
    warm = s / np.float32(max(1.0, warmup))
    prog = np.clip((s - np.float32(warmup))
                   / np.float32(max(1.0, total - warmup)),
                   np.float32(0), np.float32(1))
    cos = np.float32(min_ratio) + np.float32(1 - min_ratio) \
        * np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * prog))
    return float(warm if s < warmup else cos)
