"""qwen1.5-0.5b — Qwen1.5 0.5B. [hf:Qwen/Qwen1.5-0.5B]

Small dense decoder with QKV bias and tied embeddings; the paper's
N&D small-hidden regime where OSDP keeps most operators in DP mode.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family=DENSE,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    act="swiglu",
    rope="rope",
    source="[hf:Qwen/Qwen1.5-0.5B]",
)
