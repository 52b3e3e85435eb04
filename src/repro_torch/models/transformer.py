"""Transformer assembly, dense and SSM decoder paths.

    dense : x += attn(norm(x));   x += ffn(norm(x))
    ssm   : x += ssd(norm(x))    [x += ffn(norm(x)) where d_ff]

Parameters are stacked over layers, as in the JAX package; its
`lax.scan` over layers becomes a Python loop over `w[l]` (a view, no
copy; in training over `unbind` views, whose backward stacks the
layers' gradients once).  The OSDP plan decides per-operator
segmentation through `sharding.specs`, the FFN's uniform operator split
(`chunked_ffn` in training, as in the JAX package) and remat through
`Model.remat`: a `torch.utils.checkpoint` per layer, none, or a
selective checkpoint that keeps only the tagged products the plan
names (`save_only_these_names`).  Training runs the dense and SSM
families (`forward`, `loss_fn` with the chunked cross-entropy); the SSM
block's chunk scan differentiates through the `ssd_scan_bwd` kernel.
MoE, hybrid, VLM and audio come with later slices.

On a data mesh (`pset.mesh`) the ZDP leaves are the rank's shards,
gathered on use (`sharding.collectives`): each layer weight at its
product, the embedding (and an untied head) once for the whole forward,
its lookup and every head product feeding one reduce-scatter of its
gradient.  Serving runs unsharded only.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import DENSE, SSM, ModelConfig
from repro_torch.core.cost_model import Decision
from repro_torch.kernels import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (AttnGeom, attn_geometry, norm,
                                       positions_for)
from repro_torch.sharding.collectives import Gathered, lookup
from repro_torch.sharding.specs import ParamSet, WeightSpec, seg_matmul

LayerParams = Dict[str, torch.Tensor]

# the chunked cross-entropy of `loss_fn` (the JAX package's inline
# 512 and 2**27): the sequence is cut into CE_CHUNK positions when S is
# a multiple above it and S * padded_vocab >= CE_MIN_ELEMS, so the fp32
# (B, S, V) logits never materialize whole
CE_CHUNK = 512
CE_MIN_ELEMS = 2 ** 27


def save_only_these_names(*names: str):
    """A selective-checkpoint context factory (`checkpoint(...,
    context_fn=...)`) that keeps exactly the products tagged with one of
    `names` and recomputes everything else: the JAX package's
    `jax.checkpoint_policies.save_only_these_names`.  The policy sees
    each tagged product as `ops.tagged_matmul`, whose fourth argument is
    its tag (see `kernels.ops`); a name that tags nothing in the body
    keeps nothing."""
    keep = frozenset(names)
    tagged = torch.ops.repro_torch.tagged_matmul.default

    def policy(ctx, op, *args, **kwargs):
        if op is tagged and args[3] in keep:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return partial(create_selective_checkpoint_contexts, policy)


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in (DENSE, SSM) or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (the port "
            f"runs the dense and ssm decoder families; hybrid, moe, vlm and "
            f"audio come later)")


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

    geom = attn_geometry(cfg, tp_size) if cfg.has_attention else None
    if geom is not None:
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

    if cfg.has_ssm:
        di, ns, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
        w("layers/ssm/w_zx", (L, d, 2 * di), "layers.ssm_in", tp=2, zdp=1,
          stacked=True, init="fan_in")
        w("layers/ssm/w_bcdt", (L, d, 2 * ns + nh), "layers.ssm_in", zdp=1,
          stacked=True, init="fan_in")
        w("layers/ssm/wo", (L, di, d), "layers.ssm_out", tp=1, zdp=2,
          stacked=True, init="fan_in")
        w("layers/ssm/A_log", (L, nh), "layers.ssm_small", init="ssm_a",
          stacked=True)
        w("layers/ssm/D", (L, nh), "layers.ssm_small", init="ones",
          stacked=True)
        w("layers/ssm/dt_bias", (L, nh), "layers.ssm_small", init="zeros",
          stacked=True)
        w("layers/ssm/conv_w", (L, ssm_mod.CONV_K, di + 2 * ns),
          "layers.ssm_small", init="fan_in", stacked=True)
        w("layers/ssm/gate_norm", (L, di), "layers.ssm_small", init="ones",
          tp=1, stacked=True)
        w("layers/ssm/norm_scale", (L, d), "layers.ssm_norm", init="ones",
          stacked=True)

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
    geom: Optional[AttnGeom]     # None when the model has no attention
    pset: ParamSet
    decisions: Dict[str, Decision]
    # True = a checkpoint per layer (its activations recomputed in the
    # backward), False = keep everything, or a tuple of product tags to
    # SAVE (selective per-slice remat plans: everything else in the
    # layer is recomputed); see models.registry._remat_policy and the
    # tags of sharding.specs.seg_matmul
    remat: Union[bool, Tuple[str, ...]] = True
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

    def _split_g(self, op: str) -> int:
        """The plan's uniform operator-split granularity of `op` (1 when
        the op is unplanned or its slices mix modes)."""
        dec = self.decisions.get(op)
        if dec is None:
            return 1
        return dec.split if dec.uniform() is not None else 1

    # -- embedding / head ---------------------------------------------------
    @contextlib.contextmanager
    def _gathered_head(self, params: Dict[str, torch.Tensor]):
        """`params` with the ZDP leaves outside the layers (the embedding,
        an untied head) as `Gathered`s, each held over the block: one
        gather for all of a forward's uses, one for the backward's.
        Unsharded, or already gathered by an outer block, `params`."""
        if self.pset.mesh is None:
            yield params
            return
        new = {leaf: Gathered(params[leaf], self.pset.mesh, dim, leaf)
               for leaf, dim in self.pset.sharded().items()
               if not leaf.startswith("layers/")
               and not isinstance(params[leaf], Gathered)}
        with contextlib.ExitStack() as held:
            for g in new.values():
                held.enter_context(g.hold())
            yield dict(params, **new)
        for g in new.values():
            g.end_forward()

    def _unsharded(self, what: str) -> None:
        if self.pset.mesh is not None:
            raise NotImplementedError(f"{what} on a data mesh: sharded "
                                      f"serving is not ported (ROADMAP "
                                      f"section 1 item 5)")

    def embed(self, params: Dict[str, torch.Tensor],
              batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return lookup(params["embed/tok"], batch["tokens"])

    def logits(self, params: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = norm(cfg, x, params["final_norm/scale"],
                 params.get("final_norm/bias"))
        if cfg.tie_embeddings:
            # x @ emb^T: the kernel reads the (V, d) embedding as stored
            emb = params["embed/tok"]
            x2 = x.reshape(-1, x.shape[-1]).contiguous()
            if isinstance(emb, Gathered):
                y = ops.matmul(x2, emb.views[0], transpose_w=True,
                               pieces=[emb.piece()])
            else:
                y = ops.matmul(x2, emb, transpose_w=True)
            logits = y.reshape(*x.shape[:-1], emb.shape[0])
        else:
            logits = seg_matmul(x, params, self.pset, "head/out", 0)
        # mask padded vocab entries: in place on the product's fresh
        # output, so only the padded columns are written (a masked_fill
        # writes a second copy of the whole (rows, V) block)
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = attn_mod.NEG_INF
        return logits

    def _ffn(self, lp, x, granularity: int = 1):
        if not self.cfg.d_ff:
            return x
        h = self._norm(lp, x, "layers/ffn/norm")
        return x + ffn_mod.ffn_forward(self.cfg, self.pset, lp, h,
                                       granularity=granularity)

    # -- training -------------------------------------------------------------
    def _checkpoint(self, body):
        """A layer body under the plan's remat: a full checkpoint, none,
        or a selective one that saves only the tagged products named in
        `remat`."""
        if self.remat is True:
            return partial(checkpoint, body, use_reentrant=False)
        if self.remat:
            return partial(checkpoint, body, use_reentrant=False,
                           context_fn=save_only_these_names(*self.remat))
        return body

    def _block(self, x: torch.Tensor, lp: LayerParams,
               positions: torch.Tensor, window: int) -> torch.Tensor:
        cfg = self.cfg
        if cfg.has_attention:
            h = self._norm(lp, x, "layers/attn/norm")
            x = x + attn_mod.attn_forward(cfg, self.geom, self.pset, lp, h,
                                          positions, window=window)
        else:
            h = self._norm(lp, x, "layers/ssm/norm")
            x = x + ssm_mod.ssm_forward(cfg, self.pset, lp, h)
        return self._ffn(lp, x, self._split_g("layers.ffn_w13"))

    def forward(self, params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor], *,
                window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward -> (hidden states (B,S,d), aux loss).  A
        plan's uniform operator split of the FFN (granularity g > 1) runs
        `chunked_ffn` with g chunks, as the JAX package's forward does;
        a split of the other ops changes no product (their weights are
        not chunked there either)."""
        cfg = self.cfg
        check_supported(cfg)
        with self._gathered_head(params) as params:
            x = self.embed(params, batch)
        positions = positions_for(cfg, batch, x.shape[1])
        win = window or cfg.sliding_window
        layers = {k: v.unbind(0) for k, v in self._layers(params).items()}
        body = self._checkpoint(self._block)
        for l in range(cfg.n_layers):
            x = body(x, {k: v[l] for k, v in layers.items()}, positions,
                     win)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def _ce_block(self, params, x_blk, lab_blk):
        """Summed NLL and valid count of one (B, c, d) block."""
        logits = self.logits(params, x_blk)
        valid = lab_blk >= 0
        lab = torch.where(valid, lab_blk, 0).long()
        # in fp32, as the JAX package's astype; the cast happens inside
        # the softmax, so the fp32 logits are never stored
        logp = torch.log_softmax(logits, -1, dtype=torch.float32)
        nll = -logp.gather(-1, lab[..., None])[..., 0]
        return (torch.where(valid, nll, 0.0).sum(),
                valid.sum().to(torch.float32))

    def loss_fn(self, params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
        """Mean next-token cross-entropy (+ 0.01 aux / L) and metrics,
        as the JAX package's `loss_fn`; with the chunked vocab projection
        (`CE_CHUNK`), each chunk's logits under a checkpoint."""
        with self._gathered_head(params) as params:
            return self._loss(params, batch)

    def _loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        x, aux = self.forward(params, batch)
        labels = batch["labels"]
        S = x.shape[1]
        if (S % CE_CHUNK == 0 and S > CE_CHUNK
                and S * cfg.padded_vocab >= CE_MIN_ELEMS):
            head = {k: v for k, v in params.items()
                    if not k.startswith("layers/")}
            nll_sum = n_valid = torch.zeros((), device=x.device)
            for c0 in range(0, S, CE_CHUNK):
                bs, bn = checkpoint(self._ce_block, head,
                                    x[:, c0:c0 + CE_CHUNK],
                                    labels[:, c0:c0 + CE_CHUNK],
                                    use_reentrant=False)
                nll_sum, n_valid = nll_sum + bs, n_valid + bn
        else:
            nll_sum, n_valid = self._ce_block(params, x, labels)
        ce = nll_sum / torch.clamp(n_valid, min=1.0)
        loss = ce + 0.01 * aux / max(1, cfg.n_layers)
        return loss, {"ce": ce, "aux": aux, "tokens": n_valid}

    # -- serving --------------------------------------------------------------
    def init_caches(self, batch: int, cache_len: int,
                    device="cuda") -> Dict[str, Any]:
        caches: Dict[str, Any] = {}
        if self.cfg.has_attention:
            win = self._window()
            alen = min(cache_len, win) if win else cache_len
            caches["attn"] = attn_mod.init_kv_cache(
                self.cfg, self.geom, batch, alen, device=device)
        if self.cfg.has_ssm:
            caches["ssm"] = ssm_mod.init_ssm_cache(self.cfg, batch,
                                                   device=device)
        return caches

    def decode_step(self, params: Dict[str, torch.Tensor],
                    caches: Dict[str, Any], tokens: torch.Tensor, t
                    ) -> tuple:
        """One token for the whole batch. tokens: (B,1) int; t is a
        scalar position or a (B,) vector (continuous batching decodes
        every slot at its own position).  Updates `caches` in place and
        returns (logits (B,1,V), caches)."""
        self._unsharded("decode_step")
        cfg = self.cfg
        x = params["embed/tok"][tokens.long()]
        layers = self._layers(params)
        for l in range(cfg.n_layers):
            lp = self._layer(layers, l)
            if cfg.has_attention:
                h = self._norm(lp, x, "layers/attn/norm")
                a, _ = attn_mod.attn_decode(
                    cfg, self.geom, self.pset, lp, h, t,
                    {k: v[l] for k, v in caches["attn"].items()},
                    window=self._window())
                x = x + a
            elif cfg.has_ssm:
                h = self._norm(lp, x, "layers/ssm/norm")
                s, _ = ssm_mod.ssm_decode(
                    cfg, self.pset, lp, h,
                    {k: v[l] for k, v in caches["ssm"].items()})
                x = x + s
            x = self._ffn(lp, x)
        return self.logits(params, x), caches

    def prefill(self, params: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None) -> tuple:
        """Full-sequence forward returning last-position logits + caches.

        `cache_len` sizes the returned KV cache (>= S leaves free slots
        for decode — the continuous engine prefills straight into its
        slot shape); default S."""
        self._unsharded("prefill")
        cfg = self.cfg
        x = self.embed(params, batch)
        B, S = x.shape[:2]
        positions = positions_for(cfg, batch, S)
        win = self._window()
        target = cache_len or S
        alen = min(target, win) if win else target
        layers = self._layers(params)
        per_layer: Dict[str, List[Dict[str, torch.Tensor]]] = {}
        for l in range(cfg.n_layers):
            lp = self._layer(layers, l)
            if cfg.has_attention:
                h = self._norm(lp, x, "layers/attn/norm")
                a, kv = _attn_with_kv(self, lp, h, positions, win)
                per_layer.setdefault("attn", []).append(
                    _kv_to_cache(kv, alen))
                x = x + a
            elif cfg.has_ssm:
                h = self._norm(lp, x, "layers/ssm/norm")
                s, st = _ssm_with_state(self, lp, h)
                per_layer.setdefault("ssm", []).append(st)
                x = x + s
            x = self._ffn(lp, x)
        caches = {name: {k: torch.stack([c[k] for c in per])
                         for k in per[0]}
                  for name, per in per_layer.items()}
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


def _ssm_with_state(model: Model, lp, h):
    """The SSD block and this layer's cache: the final SSD state and the
    conv inputs of the last K-1 steps, both fp32."""
    out, state, conv_state = ssm_mod.ssm_block(model.cfg, model.pset, lp, h)
    return out, {"state": state, "conv": conv_state.float()}
