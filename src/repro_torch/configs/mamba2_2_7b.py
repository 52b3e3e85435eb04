"""mamba2-2.7b — Mamba-2 2.7B, SSD (state-space duality). [arXiv:2405.21060]

Attention-free: 64 SSD layers, d_model=2560, d_inner=5120,
ssm_state=128, head_dim=64 -> 80 SSD heads. long_500k runs natively
(decode carries only the (heads, head_dim, state) recurrent state).
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family=SSM,
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                 # Mamba2 blocks have no separate FFN
    vocab_size=50280,       # padded to 50432 internally
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    rope="none",
    act="swiglu",
    source="[arXiv:2405.21060]",
)
