"""hymba-1.5b — NVIDIA Hymba. [arXiv:2411.13676]

Hybrid-head architecture: attention heads and Mamba(SSM) heads run in
PARALLEL inside every layer on the same input, outputs fused via
normalized mean. Most attention is sliding-window (Hymba uses SWA in
all but three layers), which is what makes long_500k feasible.
"""
from repro_torch.configs.base import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=HYBRID,
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,      # padded to 32256 internally (model axis = 16)
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=50,       # d_inner=3200 -> 64 ssm heads
    sliding_window=1024,
    act="swiglu",
    rope="rope",
    source="[arXiv:2411.13676]",
)
