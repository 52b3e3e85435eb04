"""moonshot-v1-16b-a3b — Moonlight-16B-A3B. [hf:moonshotai/Moonlight-16B-A3B]

Pool tags it [dense] but the assigned spec line says "MoE 64e top-6";
built exactly to the bracketed spec (64 experts, top-6, d_ff=1408
fine-grained experts). The real Moonlight adds shared experts / MLA —
intentionally not added (see DESIGN.md §5).
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family=MOE,
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe_experts=64,
    moe_top_k=6,
    act="swiglu",
    rope="rope",
    source="[hf:moonshotai/Moonlight-16B-A3B]",
)
