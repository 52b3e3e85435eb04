"""Operator-level model description (the paper's "MD" input).

OSDP's cost model and search operate on a list of operators, each with
the three memory factors of §3.1 (model-state, activation, extra) and
the parameters needed for the (alpha, beta, gamma) time model.

Granularity: parameters are stored *stacked over layers* (scan-over-
layers), so one `OperatorDesc` describes a whole stacked param group
(e.g. all 126 `ffn_w13` matrices). The paper's finer per-slice plan
granularity (§3.3) is recovered through operator splitting: a
splittable operator with granularity g exposes g independently
decidable slices. For the paper-reproduction benchmarks we also build
per-layer (unstacked) descriptions, matching the paper's n=98..194
operator counts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

BYTES_PER_PARAM = 2          # bf16 working copy
# mixed-precision AdamW model states per parameter:
#   bf16 param (2) + bf16 grad (2) + fp32 master (4) + fp32 m (4) + fp32 v (4)
STATE_BYTES_PER_PARAM = 16
ACT_BYTES = 2                # bf16 activations

# serving-cache layout constants (must match the runtime caches:
# models.attention.init_kv_cache / models.ssm.init_ssm_cache — the
# agreement is asserted against jax.eval_shape by tests/test_serving.py)
KV_POS_BYTES = 4             # int32 absolute-position tag per cache slot
SSM_STATE_BYTES = 4          # fp32 SSD recurrent state
SSM_CONV_K = 4               # depthwise-conv width (models.ssm.CONV_K)


@dataclass(frozen=True)
class OperatorDesc:
    """One decidable operator (stacked param group)."""

    name: str
    param_count: int               # total elements (all layers in the group)
    flops_per_token: float         # fwd FLOPs attributable to this op, per token
    act_bytes_per_token: float     # live activation bytes per token (no remat)
    splittable: bool = False       # supports §3.3 operator splitting
    decidable: bool = True         # False -> tiny op, pinned to DP
    layers: int = 1                # how many per-layer instances are stacked
    # How many peer layer instances share this op's recompute working
    # set under *explicit per-slice* remat: a remat'd slice keeps
    # 1/remat_layers of its activations live (one layer's worth).  For
    # stacked groups this equals `layers`; per-layer descriptions set it
    # to the model depth so remat'ing layer i doesn't pretend layer i's
    # activations stay live.  None -> `layers` (the legacy global-flag
    # scaling, which divides by the op's own stack depth).
    remat_layers: Optional[int] = None
    # --- serving-cache terms (inference workloads only) ---------------------
    # Decode-time cache bytes this op pins per *admitted sequence*: the
    # token-scaled part (KV cache: grows with the attended context, so
    # it is capped by a sliding window) and the fixed part (SSM/conv
    # recurrent state: O(1) in sequence length).  Both are per layer
    # instance x `layers`, matching the other per-group terms.
    kv_cache_bytes_per_token: float = 0.0
    cache_bytes_per_seq: float = 0.0
    # whether the runtime shards this op's cache over the TP axis
    # (SSD heads are model-sharded; GQA KV heads are replicated)
    cache_tp_sharded: bool = False
    # memory of the transiently *gathered* weight in ZDP mode (the §3.3
    # "gigantic tensor" peak); defaults to the full param bytes.

    @property
    def param_bytes(self) -> int:
        return self.param_count * BYTES_PER_PARAM

    @property
    def state_bytes(self) -> int:
        return self.param_count * STATE_BYTES_PER_PARAM

    @property
    def eff_remat_layers(self) -> int:
        """Live-fraction divisor for an explicitly remat'd slice."""
        return max(1, self.remat_layers
                   if self.remat_layers is not None else self.layers)


@dataclass(frozen=True)
class ModelDescription:
    model: ModelConfig
    shape: ShapeConfig
    operators: List[OperatorDesc]
    # activation bytes per token that must be stored regardless of remat
    # (layer-boundary checkpoints + embeddings)
    resident_act_bytes_per_token: float

    @property
    def n_operators(self) -> int:
        return len(self.operators)

    @property
    def total_params(self) -> int:
        return sum(op.param_count for op in self.operators)

    def decidable(self) -> List[OperatorDesc]:
        return [op for op in self.operators if op.decidable]

    def cache_bytes_per_seq(self, cache_len: int, tp: int = 1,
                            kv_dtype_bytes: int = ACT_BYTES) -> float:
        """Per-device cache bytes ONE admitted sequence pins when its
        attended context is `cache_len` tokens: the KV term scales with
        the context (capped by the arch's sliding window, matching the
        runtime's rolling cache), the SSM state term is O(1).  `tp`
        divides the model-sharded caches (SSD heads); GQA KV heads are
        replicated over the model axis, so the KV term never shrinks.
        `kv_dtype_bytes` rescales the k/v entries for non-bf16 caches
        (the int32 position tag is dtype-independent)."""
        win = self.model.sliding_window
        eff = min(cache_len, win) if win else cache_len
        total = 0.0
        for op in self.operators:
            t = tp if op.cache_tp_sharded else 1
            kv = op.kv_cache_bytes_per_token
            if kv and kv_dtype_bytes != ACT_BYTES:
                # the int32 position tag (one per layer instance in the
                # group) keeps its size; only the k/v entries rescale
                pos = KV_POS_BYTES * max(1, op.layers)
                kv = (kv - pos) / ACT_BYTES * kv_dtype_bytes + pos
            total += (kv * eff + op.cache_bytes_per_seq) / t
        return total


def _matmul_flops(d_in: int, d_out: int) -> float:
    return 2.0 * d_in * d_out


def describe(model: ModelConfig, shape: ShapeConfig,
             per_layer: bool = False) -> ModelDescription:
    """Build the operator list for (model, shape).

    per_layer=True unrolls the stacked groups into per-layer operators
    (the paper's granularity; used by the paper-repro benchmarks).
    """
    d = model.d_model
    L = model.n_layers
    V = model.padded_vocab
    seq = shape.seq_len
    ops: List[OperatorDesc] = []

    def add(name: str, params: int, flops_tok: float, act_tok: float,
            splittable: bool = False, decidable: bool = True,
            layers: int = 1, remat_layers: Optional[int] = None,
            kv_cache_tok: float = 0.0, cache_seq: float = 0.0,
            cache_tp_sharded: bool = False) -> None:
        ops.append(OperatorDesc(name, params, flops_tok, act_tok,
                                splittable, decidable, layers,
                                remat_layers, kv_cache_tok, cache_seq,
                                cache_tp_sharded))

    def add_layer_group(name: str, params_per_layer: int, flops_tok: float,
                        act_tok: float, splittable: bool = False,
                        decidable: bool = True, kv_cache_tok: float = 0.0,
                        cache_seq: float = 0.0,
                        cache_tp_sharded: bool = False) -> None:
        """A group stacked over L layers (or unrolled if per_layer)."""
        if per_layer:
            # each per-layer op gathers its own slice (layers=1) but
            # shares the one-layer-live recompute set with its L peers
            for i in range(L):
                add(f"layer{i}.{name}", params_per_layer, flops_tok,
                    act_tok, splittable, decidable, remat_layers=L,
                    kv_cache_tok=kv_cache_tok, cache_seq=cache_seq,
                    cache_tp_sharded=cache_tp_sharded)
        else:
            add(f"layers.{name}", params_per_layer * L, flops_tok * L,
                act_tok * L, splittable, decidable, layers=L,
                kv_cache_tok=kv_cache_tok * L, cache_seq=cache_seq * L,
                cache_tp_sharded=cache_tp_sharded)

    nm = 2 if model.norm == "layernorm" else 1   # norm scale (+bias)
    # --- embeddings / head --------------------------------------------------
    if model.encoder_only:
        add("embed.tok", d, 0.0, d * ACT_BYTES)   # mask embedding (stub)
    else:
        add("embed.tok", V * d, 0.0, d * ACT_BYTES, splittable=False)
    if (not model.tie_embeddings and model.is_decoder) or model.encoder_only:
        add("head.out", d * V, _matmul_flops(d, V), V * ACT_BYTES,
            splittable=True)
    add("final_norm", nm * d, 0.0, 0.0, decidable=False)

    # --- attention ----------------------------------------------------------
    if model.has_attention:
        qd, kvd = model.q_dim, model.kv_dim
        bias = (qd + 2 * kvd) if model.qkv_bias else 0
        # the op producing K/V owns the KV cache: k + v (bf16) plus the
        # int32 position tag, per attended token per sequence
        add_layer_group("attn_qkv", d * (qd + 2 * kvd) + bias,
                        _matmul_flops(d, qd + 2 * kvd),
                        (qd + 2 * kvd) * ACT_BYTES, splittable=True,
                        kv_cache_tok=2 * kvd * ACT_BYTES + KV_POS_BYTES)
        add_layer_group("attn_out", qd * d, _matmul_flops(qd, d),
                        d * ACT_BYTES, splittable=True)
        # score computation: param-less, pure gamma cost.
        window = model.sliding_window or seq
        eff_ctx = min(seq, window)
        add_layer_group("attn_scores", 0,
                        2.0 * 2.0 * eff_ctx * model.resolved_head_dim
                        * model.n_heads,
                        2 * model.n_heads * 0 * ACT_BYTES,  # flash: O(1) scores
                        decidable=False)
        add_layer_group("attn_norm", nm * d, 0.0, 0.0, decidable=False)

    # --- SSM (Mamba2 SSD) ---------------------------------------------------
    if model.has_ssm:
        di, ns, nh = model.ssm_d_inner, model.ssm_state, model.ssm_n_heads
        in_dim = 2 * di + 2 * ns + nh
        add_layer_group("ssm_in", d * in_dim, _matmul_flops(d, in_dim),
                        in_dim * ACT_BYTES, splittable=True)
        add_layer_group("ssm_out", di * d, _matmul_flops(di, d),
                        d * ACT_BYTES, splittable=True)
        # A, D, dt_bias, gate norm, depthwise conv (K=4) — tiny; the SSD
        # scan op owns the O(1)-per-sequence recurrent cache: the fp32
        # (nh, hd, ns) state plus the (K-1)-step conv tail, both
        # model-sharded with the SSD heads at decode time
        add_layer_group("ssm_small", 3 * nh + di + 4 * (di + 2 * ns),
                        2.0 * 2.0 * model.ssm_chunk * di  # ssd chunk scan
                        + 2.0 * di * ns * 2,
                        di * ACT_BYTES, decidable=False,
                        cache_seq=(di * ns * SSM_STATE_BYTES
                                   + (SSM_CONV_K - 1) * (di + 2 * ns)
                                   * SSM_STATE_BYTES),
                        cache_tp_sharded=True)
        add_layer_group("ssm_norm", d, 0.0, 0.0, decidable=False)

    # --- FFN / MoE ----------------------------------------------------------
    ff_mult = 3 if model.act == "swiglu" else 2
    if model.is_moe:
        E, k, ff = model.moe_experts, model.moe_top_k, model.d_ff
        add_layer_group("moe_router", d * E, _matmul_flops(d, E),
                        E * ACT_BYTES, decidable=False)
        # experts: flops per token counts only the top-k active experts
        add_layer_group("moe_w13", E * (ff_mult - 1) * d * ff,
                        k * _matmul_flops(d, (ff_mult - 1) * ff),
                        k * (ff_mult - 1) * ff * ACT_BYTES, splittable=True)
        add_layer_group("moe_w2", E * d * ff,
                        k * _matmul_flops(ff, d),
                        k * d * ACT_BYTES, splittable=True)
        if model.moe_dense_residual:
            dff = model.moe_dense_d_ff or ff
            add_layer_group("dense_w13", (ff_mult - 1) * d * dff,
                            _matmul_flops(d, (ff_mult - 1) * dff),
                            (ff_mult - 1) * dff * ACT_BYTES, splittable=True)
            add_layer_group("dense_w2", dff * d, _matmul_flops(dff, d),
                            d * ACT_BYTES, splittable=True)
    elif model.d_ff:
        ff = model.d_ff
        add_layer_group("ffn_w13", (ff_mult - 1) * d * ff,
                        _matmul_flops(d, (ff_mult - 1) * ff),
                        (ff_mult - 1) * ff * ACT_BYTES, splittable=True)
        add_layer_group("ffn_w2", ff * d, _matmul_flops(ff, d),
                        d * ACT_BYTES, splittable=True)
    if model.d_ff or model.is_moe:
        add_layer_group("ffn_norm", nm * d, 0.0, 0.0, decidable=False)

    # remat stores one d_model activation per layer boundary + embedding out
    resident = (L + 1) * d * ACT_BYTES
    return ModelDescription(model, shape, ops, resident)


def sanity_check(desc: ModelDescription) -> None:
    got = desc.total_params
    want = desc.model.param_count()
    # the closed-form and the operator sum must agree (within norm epsilon)
    assert abs(got - want) <= max(64, 0.001 * want), (
        f"{desc.model.name}: operator params {got} != closed-form {want}")
