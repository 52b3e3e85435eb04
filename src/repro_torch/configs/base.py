"""Model / run configuration system.

Every assigned architecture is a `ModelConfig`; input shapes are
`ShapeConfig`s; `RunConfig` binds (arch, shape, mesh, OSDP options).
Configs are plain frozen dataclasses so they hash, print, and diff
cleanly, and so the dry-run can enumerate the full grid.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"

FAMILIES = (DENSE, MOE, SSM, HYBRID, VLM, AUDIO)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (the paper's "model description" MD)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int            # query heads; 0 for attention-free (ssm)
    n_kv_heads: int         # GQA kv heads
    d_ff: int               # FFN hidden (per-expert hidden for MoE)
    vocab_size: int
    head_dim: int = 0       # 0 -> d_model // n_heads
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope: str = "rope"      # "rope" | "mrope" | "none"
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w halves of head_dim/2
    sliding_window: int = 0  # 0 = full attention (native); >0 native SWA
    causal: bool = True      # False for encoder-only
    # --- MoE ---------------------------------------------------------------
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN in parallel w/ MoE
    moe_capacity_factor: float = 1.25
    moe_dense_d_ff: int = 0            # dense-residual hidden (0 -> d_ff)
    # --- SSM (Mamba2 / SSD) ------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- misc --------------------------------------------------------------
    act: str = "swiglu"     # "swiglu" | "gelu"
    norm: str = "rmsnorm"   # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    encoder_only: bool = False
    vocab_pad_multiple: int = 256
    dtype: str = "bfloat16"
    # provenance, e.g. "[hf:Snowflake/snowflake-arctic-base]"
    source: str = ""

    # --- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != SSM

    @property
    def has_ssm(self) -> bool:
        return self.family in (SSM, HYBRID)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def is_decoder(self) -> bool:
        return not self.encoder_only

    def param_count(self) -> int:
        """Exact parameter count of the model as built (padded vocab)."""
        d, L, V = self.d_model, self.n_layers, self.padded_vocab
        nm = 2 if self.norm == "layernorm" else 1   # scale (+bias)
        if self.encoder_only:
            total = d                      # mask embedding (audio stub)
        else:
            total = V * d                  # token embedding
        if not self.tie_embeddings:
            total += V * d                 # lm head
        total += nm * d                    # final norm
        per_layer = 0
        if self.has_attention:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                per_layer += self.q_dim + 2 * self.kv_dim
            per_layer += nm * d            # attn norm
        if self.has_ssm:
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_n_heads
            # in_proj: x(z, x, B, C, dt); out_proj; A, D, dt_bias; gate norm;
            # depthwise causal conv (K=4) over (x, B, C)
            per_layer += (d * (2 * di + 2 * ns * 1 + nh) + di * d
                          + 3 * nh + di + 4 * (di + 2 * ns))
            per_layer += d                 # ssm norm
        # FFN / MoE
        ff_mult = 3 if self.act == "swiglu" else 2
        if self.is_moe:
            per_layer += self.moe_experts * ff_mult * d * self.d_ff
            per_layer += d * self.moe_experts           # router
            if self.moe_dense_residual:
                per_layer += ff_mult * d * (self.moe_dense_d_ff or self.d_ff)
        elif self.d_ff:
            per_layer += ff_mult * d * self.d_ff
        if self.d_ff or self.is_moe:
            per_layer += nm * d            # ffn norm
        return total + L * per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        ff_mult = 3 if self.act == "swiglu" else 2
        inactive_experts = self.moe_experts - self.moe_top_k
        return self.param_count() - L * inactive_experts * ff_mult * d * self.d_ff

    def validate(self) -> None:
        assert self.family in FAMILIES, self.family
        if self.has_attention:
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0, (
                f"{self.name}: GQA requires n_heads % n_kv_heads == 0")
        if self.has_ssm:
            assert self.ssm_state > 0
            assert self.ssm_d_inner % self.ssm_head_dim == 0
        if self.is_moe:
            assert 0 < self.moe_top_k <= self.moe_experts


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def data_parallel(self) -> int:
        """Total data-parallel ways (pod x data)."""
        n = 1
        for s, a in zip(self.shape, self.axes):
            if a in ("pod", "data"):
                n *= s
        return n

    @property
    def model_parallel(self) -> int:
        for s, a in zip(self.shape, self.axes):
            if a == "model":
                return s
        return 1

    @property
    def pipeline_parallel(self) -> int:
        for s, a in zip(self.shape, self.axes):
            if a == "pipe":
                return s
        return 1

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class DeviceInfo:
    """The paper's "device information" DI — profiled hardware constants.

    Defaults are the assignment's TPU v5e targets.  This is the *flat*
    device model (one fast + one slow bandwidth); real hierarchies
    (chip -> node -> pod -> cluster, heterogeneous memory) are
    described by `repro.cluster.topology.ClusterSpec`, whose depth-2
    degenerate case reproduces this model exactly.
    """

    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bytes: float = 16 * 2**30       # per-chip HBM capacity
    hbm_bw: float = 819e9               # bytes/s
    ici_bw: float = 50e9                # bytes/s per link
    dci_bw: float = 25e9                # inter-pod (pod axis) bytes/s
    alpha: float = 1e-6                 # collective latency per step (s)
    # gamma: seconds of compute per (FLOP / peak) — 1.0 means roofline;
    # real kernels run below peak, so the cost model uses this efficiency.
    mxu_efficiency: float = 0.55
    # devices sharing the fast (ici_bw) domain — lets topology-aware
    # code infer a node boundary from a flat DeviceInfo (0 = unknown:
    # the whole extent is assumed to sit on ici_bw, the legacy model)
    devices_per_node: int = 0
    # fraction of collective time the runtime can hide under compute
    # (prefetched gathers / async all-reduce).  0 keeps the serial cost
    # model — every committed golden is pinned at 0; per-preset
    # achievable values live in PRESET_OVERLAP and are opt-in via
    # `preset(name, overlap=...)` / `--overlap`.
    overlap: float = 0.0

    def link_bw(self, axis: str) -> float:
        return self.dci_bw if axis == "pod" else self.ici_bw

    @classmethod
    def preset(cls, name: str,
               overlap: Union[float, str, None] = None) -> "DeviceInfo":
        """Catalog of profiled hardware targets (`--device` on the
        launchers and benchmark CLIs).  `overlap` sets the comm/compute
        overlap factor: None keeps the serial model (0.0, the golden-
        pinned default), "auto" takes the preset's achievable value
        from the catalog, a float is used as-is."""
        try:
            dev = PRESET_CATALOG[name].info
        except KeyError:
            raise KeyError(
                f"unknown device preset {name!r}; "
                f"known: {sorted(PRESET_CATALOG)}") from None
        if overlap is None:
            return dev
        if overlap == "auto":
            overlap = PRESET_CATALOG[name].achievable_overlap
        return dataclasses.replace(dev, overlap=float(overlap))


@dataclass(frozen=True)
class DevicePreset:
    """One catalog entry: the datasheet DeviceInfo plus the per-preset
    knobs that stay out of the serial cost model.  `achievable_overlap`
    is what `--overlap auto` opts into (a bare `preset(name)` still
    prices serially — committed goldens depend on it).  Measured
    overrides do NOT live here: a fitted CalibrationProfile layers on
    top via `repro_torch.calibrate.store`, the single override point."""

    info: "DeviceInfo"
    achievable_overlap: float


# The single source of per-device constants.  peak_flops are bf16
# dense; mxu_efficiency is the sustained fraction the cost model's
# gamma term uses (per-family empirical deratings) — the scalar a
# fitted EfficiencyCurve replaces.  achievable_overlap: how much of a
# collective the runtime's prefetched gathers / bucketed async
# all-reduce can hide under compute on that interconnect.
PRESET_CATALOG = {
    "tpu-v5e": DevicePreset(DeviceInfo(
        name="tpu-v5e", peak_flops=197e12, hbm_bytes=16 * 2**30,
        hbm_bw=819e9, ici_bw=50e9, dci_bw=25e9, alpha=1e-6,
        mxu_efficiency=0.55),
        achievable_overlap=0.7),   # ICI schedules well behind the MXU
    "tpu-v4": DevicePreset(DeviceInfo(
        name="tpu-v4", peak_flops=275e12, hbm_bytes=32 * 2**30,
        hbm_bw=1228e9, ici_bw=100e9, dci_bw=25e9, alpha=1e-6,
        mxu_efficiency=0.55),
        achievable_overlap=0.7),
    "a100-80g": DevicePreset(DeviceInfo(
        name="a100-80g", peak_flops=312e12, hbm_bytes=80 * 2**30,
        hbm_bw=2039e9, ici_bw=300e9, dci_bw=25e9, alpha=5e-6,
        mxu_efficiency=0.45, devices_per_node=8),
        achievable_overlap=0.6),   # NCCL copy engines vs SM contention
    "h100-sxm": DevicePreset(DeviceInfo(
        name="h100-sxm", peak_flops=989e12, hbm_bytes=80 * 2**30,
        hbm_bw=3350e9, ici_bw=450e9, dci_bw=50e9, alpha=5e-6,
        mxu_efficiency=0.45, devices_per_node=8),
        achievable_overlap=0.8),   # SHARP offload + faster NVLink
}

DEVICE_PRESETS = tuple(sorted(PRESET_CATALOG))

# legacy view kept for callers that index the overlap table directly;
# derived from the catalog so the constants live in exactly one place
PRESET_OVERLAP = {name: p.achievable_overlap
                  for name, p in PRESET_CATALOG.items()}


# OSDPConfig.checkpointing value that promotes remat from a global
# switch into a per-slice searched decision (DP/ZDP x remat/no-remat)
SELECTIVE = "selective"

# the Search Engine's interchangeable cover-problem solvers: three
# engineered heuristics/exacts plus the explicit ILP oracle (ISSUE 6)
SOLVERS = ("dfs", "knapsack", "greedy", "ilp")
ILP_BACKENDS = ("auto", "milp", "bnb")


@dataclass(frozen=True)
class OSDPConfig:
    """OSDP feature switches for a run."""

    enabled: bool = True
    memory_limit_bytes: float = 16 * 2**30   # per-device M_limit
    search: str = "dfs"                      # one of SOLVERS
    allow_pod_hierarchical: bool = True      # beyond-paper ZDP_POD mode
    operator_splitting: bool = True
    default_slice_granularity: int = 4
    # beyond-paper: per-operator slice granularity from the cost model
    # (the paper fixes g=4 and names auto-tuning as future work, §4.3)
    auto_granularity: bool = False
    # remat (affects ZDP cost, §4.3): True/False force the legacy global
    # setting; "selective" searches remat per slice, jointly with the
    # sharding mode (4-mode axis; beyond paper)
    checkpointing: Union[bool, str] = True
    force_mode: Optional[str] = None         # "DP" | "ZDP": bypass search
    # alias for `search` (the solver-facing name): OSDPConfig(
    # solver="ilp") == OSDPConfig(search="ilp").  When set it overrides
    # the `search` default; setting both to different values is an error.
    solver: Optional[str] = None
    # --- ilp solver knobs (search="ilp" only) ------------------------------
    # anytime mode: > 0 caps each cover solve at this many seconds and
    # accepts the incumbent + proven bound; 0 = solve to optimality
    ilp_time_budget_s: float = 0.0
    ilp_backend: str = "auto"                # one of ILP_BACKENDS

    def __post_init__(self):
        if self.solver is not None:
            if self.search != "dfs" and self.search != self.solver:
                raise ValueError(
                    f"search={self.search!r} and solver={self.solver!r} "
                    f"disagree: `solver` is an alias for `search`, set "
                    f"one of them")
            object.__setattr__(self, "search", self.solver)
        if self.search not in SOLVERS:
            raise ValueError(
                f"search={self.search!r}: unknown solver; "
                f"known: {SOLVERS}")
        if self.ilp_backend not in ILP_BACKENDS:
            raise ValueError(
                f"ilp_backend={self.ilp_backend!r}: "
                f"known: {ILP_BACKENDS}")
        if self.ilp_time_budget_s < 0:
            raise ValueError("ilp_time_budget_s must be >= 0")
        if isinstance(self.checkpointing, str) \
                and self.checkpointing != SELECTIVE:
            raise ValueError(
                f"checkpointing={self.checkpointing!r}: the only "
                f"string value is {SELECTIVE!r} (or use True/False "
                f"for the global setting)")
        if self.force_mode and self.selective_remat:
            raise ValueError(
                "force_mode bypasses the search, so there is no "
                "selective-remat axis to decide: combine force_mode "
                "with checkpointing=True/False")

    @property
    def selective_remat(self) -> bool:
        return self.checkpointing == SELECTIVE

    @property
    def env_checkpointing(self) -> bool:
        """The CostEnv default-remat bit this config implies: selective
        searches start from the no-remat base plan; any other truthy
        value keeps the legacy global-remat behaviour."""
        return bool(self.checkpointing) and not self.selective_remat


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig
    osdp: OSDPConfig = field(default_factory=OSDPConfig)
    # long-context strategy for full-attention archs ("swa" | "native")
    long_context: str = "swa"
    swa_window: int = 8_192
    microbatch: int = 0       # 0 = no microbatching
    seed: int = 0

    @property
    def per_device_batch(self) -> int:
        dp = self.mesh.data_parallel
        if self.shape.global_batch % dp == 0:
            return self.shape.global_batch // dp
        return max(1, self.shape.global_batch // dp)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test variant of the same family: <=2 layers, d_model<=512,
    <=4 experts, tiny vocab — runnable on one CPU device."""
    head_dim = 64
    n_heads = max(2, min(4, cfg.n_heads or 2))
    n_kv = max(1, min(cfg.n_kv_heads or 1, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    small = dict(
        n_layers=2,
        d_model=n_heads * head_dim,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=256,
        vocab_size=512,
        vocab_pad_multiple=16,
        mrope_sections=(16, 8, 8),
    )
    if cfg.is_moe:
        small.update(moe_experts=4, moe_top_k=min(2, cfg.moe_top_k),
                     moe_dense_d_ff=128)
    if cfg.has_ssm:
        small.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
    if cfg.sliding_window:
        small.update(sliding_window=64)
    small.update(overrides)
    out = dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
    out.validate()
    return out
