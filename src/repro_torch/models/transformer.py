"""Transformer assembly, dense decoder path (serving).

    dense : x += attn(norm(x));   x += ffn(norm(x))

Parameters are stacked over layers, as in the JAX package; its
`lax.scan` over layers becomes a Python loop over `w[l]` (a view, no
copy).  The OSDP plan decides per-operator segmentation through
`sharding.specs`.  MoE, SSM, hybrid, VLM and audio families, the
training forward/loss and remat come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import DENSE, ModelConfig
from repro_torch.core.cost_model import Decision
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (AttnGeom, attn_geometry, norm,
                                       positions_for)
from repro_torch.sharding.specs import ParamSet, WeightSpec, seg_matmul

LayerParams = Dict[str, torch.Tensor]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family != DENSE or cfg.is_moe or cfg.has_ssm:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (this "
            f"slice runs the dense decoder family)")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def build_specs(cfg: ModelConfig, tp_size: int) -> List[WeightSpec]:
    """The dense decoder's weights, with the JAX package's paths, ops,
    TP and ZDP axes (`models/transformer.py::build_specs`)."""
    check_supported(cfg)
    d, L, Vp = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    ln = cfg.norm == "layernorm"
    specs: List[WeightSpec] = []

    def w(path, shape, op, tp=None, zdp=None, init="normal", stacked=False,
          scale=0.02):
        specs.append(WeightSpec(path, shape, op, tp_axis=tp, zdp_axis=zdp,
                                init=init, stacked=stacked, init_scale=scale))

    w("embed/tok", (Vp, d), "embed.tok", tp=0, zdp=1)
    if not cfg.tie_embeddings:
        w("head/out", (d, Vp), "head.out", tp=1, zdp=0)
    w("final_norm/scale", (d,), "final_norm", init="ones")
    if ln:
        w("final_norm/bias", (d,), "final_norm", init="zeros")

    geom = attn_geometry(cfg, tp_size)
    qf, kf = geom.q_flat, geom.kv_flat
    tp_q = 2 if geom.tp else None
    tp_b = 1 if geom.tp else None
    w("layers/attn/wq", (L, d, qf), "layers.attn_qkv", tp=tp_q, zdp=1,
      stacked=True, init="fan_in")
    w("layers/attn/wk", (L, d, kf), "layers.attn_qkv", zdp=1,
      stacked=True, init="fan_in")
    w("layers/attn/wv", (L, d, kf), "layers.attn_qkv", zdp=1,
      stacked=True, init="fan_in")
    if cfg.qkv_bias:
        w("layers/attn/bq", (L, qf), "layers.attn_qkv", tp=tp_b,
          init="zeros", stacked=True)
        w("layers/attn/bk", (L, kf), "layers.attn_qkv", init="zeros",
          stacked=True)
        w("layers/attn/bv", (L, kf), "layers.attn_qkv", init="zeros",
          stacked=True)
    w("layers/attn/wo", (L, qf, d), "layers.attn_out",
      tp=(1 if geom.tp else None), zdp=2, stacked=True, init="fan_in")
    w("layers/attn/norm_scale", (L, d), "layers.attn_norm", init="ones",
      stacked=True)
    if ln:
        w("layers/attn/norm_bias", (L, d), "layers.attn_norm",
          init="zeros", stacked=True)

    ff_mult = 2 if cfg.act == "swiglu" else 1
    if cfg.d_ff:
        ff = cfg.d_ff
        w("layers/ffn/w13", (L, d, ff_mult * ff), "layers.ffn_w13", tp=2,
          zdp=1, stacked=True, init="fan_in")
        w("layers/ffn/w2", (L, ff, d), "layers.ffn_w2", tp=1, zdp=2,
          stacked=True, init="fan_in")
        w("layers/ffn/norm_scale", (L, d), "layers.ffn_norm", init="ones",
          stacked=True)
        if ln:
            w("layers/ffn/norm_bias", (L, d), "layers.ffn_norm",
              init="zeros", stacked=True)
    return specs


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@dataclass
class Model:
    cfg: ModelConfig
    geom: AttnGeom
    pset: ParamSet
    decisions: Dict[str, Decision]
    swa_window: int = 0          # override window for long-context decode

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _layers(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in params.items() if k.startswith("layers/")}

    @staticmethod
    def _layer(layer_params: Dict[str, torch.Tensor], l: int) -> LayerParams:
        return {k: v[l] for k, v in layer_params.items()}

    def _norm(self, lp, x, prefix):
        bias = lp.get(prefix + "_bias") if self.cfg.norm == "layernorm" \
            else None
        return norm(self.cfg, x, lp[prefix + "_scale"], bias)

    def _window(self) -> int:
        return self.swa_window or self.cfg.sliding_window

    # -- embedding / head ---------------------------------------------------
    def embed(self, params: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return params["embed/tok"][batch["tokens"].long()]

    def logits(self, params: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm(cfg, x, params["final_norm/scale"],
                 params.get("final_norm/bias"))
        if cfg.tie_embeddings:
            # the kernel takes a row-major (K, N) weight: transposing the
            # tied embedding costs one (d, V) copy per call
            emb = params["embed/tok"]
            logits = ops.split_matmul(
                x.reshape(-1, x.shape[-1]).contiguous(),
                emb.t().contiguous()).reshape(*x.shape[:-1], emb.shape[0])
        else:
            logits = seg_matmul(x, params, self.pset, "head/out", 0)
        # mask padded vocab entries
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab,
                               device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, attn_mod.NEG_INF)
        return logits

    def _ffn(self, lp, x):
        h = self._norm(lp, x, "layers/ffn/norm")
        return x + ffn_mod.ffn_forward(self.cfg, self.pset, lp, h)

    # -- serving --------------------------------------------------------------
    def init_caches(self, batch: int, cache_len: int,
                    device="cuda") -> Dict[str, Any]:
        win = self._window()
        alen = min(cache_len, win) if win else cache_len
        return {"attn": attn_mod.init_kv_cache(self.cfg, self.geom, batch,
                                               alen, device=device)}

    def decode_step(self, params: Dict[str, torch.Tensor],
                    caches: Dict[str, Any], tokens: torch.Tensor, t
                    ) -> tuple:
        """One token for the whole batch. tokens: (B,1) int; t is a
        scalar position or a (B,) vector (continuous batching decodes
        every slot at its own position).  Updates `caches` in place and
        returns (logits (B,1,V), caches)."""
        x = params["embed/tok"][tokens.long()]
        layers = self._layers(params)
        cache = caches["attn"]
        for l in range(self.cfg.n_layers):
            lp = self._layer(layers, l)
            h = self._norm(lp, x, "layers/attn/norm")
            a, _ = attn_mod.attn_decode(
                self.cfg, self.geom, self.pset, lp, h, t,
                {k: v[l] for k, v in cache.items()}, window=self._window())
            x = self._ffn(lp, x + a)
        return self.logits(params, x), caches

    def prefill(self, params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> tuple:
        """Full-sequence forward returning last-position logits + caches.

        `cache_len` sizes the returned KV cache (>= S leaves free slots
        for decode — the continuous engine prefills straight into its
        slot shape); default S."""
        cfg = self.cfg
        x = self.embed(params, batch)
        B, S = x.shape[:2]
        positions = positions_for(cfg, batch, S)
        win = self._window()
        target = cache_len or S
        alen = min(target, win) if win else target
        layers = self._layers(params)
        per_layer = []
        for l in range(cfg.n_layers):
            lp = self._layer(layers, l)
            h = self._norm(lp, x, "layers/attn/norm")
            a, kv = _attn_with_kv(self, lp, h, positions, win)
            per_layer.append(_kv_to_cache(kv, alen))
            x = self._ffn(lp, x + a)
        caches = {"attn": {k: torch.stack([c[k] for c in per_layer])
                           for k in ("k", "v", "pos")}}
        return self.logits(params, x[:, -1:]), caches


def _attn_with_kv(model: Model, lp, h, positions, win):
    cfg, geom, pset = model.cfg, model.geom, model.pset
    q, k, v = attn_mod._proj_qkv(cfg, geom, pset, lp, h)
    q, k = attn_mod._rotate_qk(cfg, geom, q, k, positions)
    o = attn_mod.flash_attention(q, k, v, causal=cfg.causal, window=win)
    return attn_mod._out_proj(geom, pset, lp, o), (k, v)


def _kv_to_cache(kv, alen: int):
    k, v = kv
    B, S = k.shape[:2]
    take = min(alen, S)
    pos = torch.arange(S - take, S, dtype=torch.int32, device=k.device)
    slot = (pos % alen).long()
    kc = torch.zeros((B, alen) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    vc = torch.zeros_like(kc)
    pc = torch.full((B, alen), -1, dtype=torch.int32, device=k.device)
    kc[:, slot] = k[:, S - take:]
    vc[:, slot] = v[:, S - take:]
    pc[:, slot] = pos[None]
    return {"k": kc, "v": vc, "pos": pc}
