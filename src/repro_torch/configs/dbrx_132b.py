"""dbrx-132b — Databricks DBRX base. [hf:databricks/dbrx-base]

Fine-grained MoE: 16 experts, top-4 routing.
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family=MOE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe_experts=16,
    moe_top_k=4,
    act="swiglu",
    rope="rope",
    rope_theta=500_000.0,
    source="[hf:databricks/dbrx-base]",
)
