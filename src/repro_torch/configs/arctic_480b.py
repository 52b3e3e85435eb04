"""arctic-480b — Snowflake Arctic base. [hf:Snowflake/snowflake-arctic-base]

MoE 128 experts top-2 with a dense residual MLP in parallel
(Arctic's "dense-MoE hybrid" design).
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family=MOE,
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe_experts=128,
    moe_top_k=2,
    moe_dense_residual=True,
    moe_dense_d_ff=4864,
    act="swiglu",
    rope="rope",
    source="[hf:Snowflake/snowflake-arctic-base]",
)
