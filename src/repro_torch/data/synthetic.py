"""Deterministic synthetic data pipeline (the port's copy of the JAX
package's `data/synthetic.py`, numpy only; its batches are
byte-identical for the same (seed, step)).

Produces reproducible token/frame batches per (seed, step) — the same
global batch regardless of host count — with a learnable signal (a
noisy affine-autoregressive token process) so smoke-training shows a
decreasing loss, not just non-NaN.

The pipeline is host-sharded: `Dataset.global_batch(step)` builds the
full batch (for single-host CPU runs), `host_batch(step, host, n)` the
per-host slice a multi-host launcher would feed each host.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class Dataset:
    model: ModelConfig
    shape: ShapeConfig
    seed: int = 0
    n_patches: int = 256          # VLM stub budget
    mask_prob: float = 0.3        # audio masked-prediction rate

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def global_batch(self, step: int,
                     batch: Optional[int] = None,
                     seq: Optional[int] = None) -> Dict[str, np.ndarray]:
        B = batch or self.shape.global_batch
        S = seq or self.shape.seq_len
        cfg = self.model
        rng = self._rng(step)
        if cfg.family == "audio":
            return self._audio(rng, B, S)
        if cfg.family == "vlm":
            return self._vlm(rng, B, S)
        toks = self._lm_tokens(rng, B, S + 1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def host_batch(self, step: int, host: int, n_hosts: int,
                   **kw) -> Dict[str, np.ndarray]:
        g = self.global_batch(step, **kw)
        return {k: np.array_split(v, n_hosts, axis=0)[host]
                for k, v in g.items()}

    # -- generators -----------------------------------------------------------
    def _lm_tokens(self, rng, B: int, S: int) -> np.ndarray:
        """Markov-ish stream: tok[t] = (a*tok[t-1] + b + noise) % V."""
        V = self.model.vocab_size
        a = 31, 17
        toks = np.zeros((B, S), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        noise = (rng.random((B, S)) < 0.1)
        jump = rng.integers(0, V, (B, S))
        for t in range(1, S):
            nxt = (toks[:, t - 1] * a[0] + a[1]) % V
            toks[:, t] = np.where(noise[:, t], jump[:, t], nxt)
        return toks

    def _audio(self, rng, B: int, S: int) -> Dict[str, np.ndarray]:
        d = self.model.d_model
        V = self.model.vocab_size
        # temporally-correlated unit stream (real audio has structure;
        # iid labels would make masked prediction unlearnable — the
        # model must infer masked units from CONTEXT)
        labels = self._lm_tokens(rng, B, S) % V
        # frames carry a linear rendering of the label (learnable signal)
        proj = self._rng(0).standard_normal((V, d)).astype(np.float32) * 0.1
        frames = proj[labels] + rng.standard_normal(
            (B, S, d)).astype(np.float32) * 0.05
        mask = rng.random((B, S)) < self.mask_prob
        lab = np.where(mask, labels, -1)   # loss only on masked frames
        return {"frames": frames.astype(np.float32),
                "mask": mask, "labels": lab.astype(np.int32)}

    def _vlm(self, rng, B: int, S: int) -> Dict[str, np.ndarray]:
        d = self.model.d_model
        P = min(self.n_patches, S // 2)
        s_text = S - P
        toks = self._lm_tokens(rng, B, s_text + 1)
        patches = rng.standard_normal((B, P, d)).astype(np.float32) * 0.1
        positions = mrope_positions(B, P, s_text)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "patches": patches,
                "positions": positions,
                "labels": toks[:, 1:].astype(np.int32)}


def mrope_positions(B: int, n_patches: int, s_text: int,
                    grid: Optional[int] = None) -> np.ndarray:
    """Qwen2-VL M-RoPE positions: image patches get (t0, h, w) on an
    h x w grid at a single timestep; text continues t = t0+1, t0+2, ...
    with h = w = t (diagonal)."""
    g = grid or int(np.sqrt(n_patches))
    pos = np.zeros((B, n_patches + s_text, 3), np.int32)
    hh, ww = np.divmod(np.arange(n_patches), g)
    pos[:, :n_patches, 0] = 0
    pos[:, :n_patches, 1] = hh
    pos[:, :n_patches, 2] = ww
    t = np.arange(s_text) + max(g, 1)
    pos[:, n_patches:, 0] = t
    pos[:, n_patches:, 1] = t
    pos[:, n_patches:, 2] = t
    return pos
