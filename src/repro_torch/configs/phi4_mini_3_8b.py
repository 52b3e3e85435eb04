"""phi4-mini-3.8b — Phi-4-mini. [arXiv:2412.08905]

Dense decoder: RoPE + SwiGLU + GQA, 200k vocab.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family=DENSE,
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    act="swiglu",
    rope="rope",
    source="[arXiv:2412.08905]",
)
