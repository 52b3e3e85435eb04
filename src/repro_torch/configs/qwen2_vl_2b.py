"""qwen2-vl-2b — Qwen2-VL 2B language backbone. [arXiv:2409.12191]

M-RoPE (multimodal rotary: temporal/height/width sections) + dynamic
resolution. The ViT vision encoder is STUBBED per the assignment
carve-out: input_specs() supplies pre-projected patch embeddings that
are merged into the token stream ahead of the text tokens.
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family=VLM,
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope="mrope",
    mrope_sections=(16, 24, 24),   # t/h/w split of head_dim/2 = 64
    rope_theta=1_000_000.0,
    act="swiglu",
    source="[arXiv:2409.12191]",
)

# VLM stub frontend: number of image patch embeddings prepended per
# sequence (dynamic resolution -> fixed budget for the dry-run shapes).
N_PATCHES = 256
