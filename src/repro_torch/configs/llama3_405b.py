"""llama3-405b — Llama 3.1 405B. [arXiv:2407.21783]

Dense GQA decoder, 128k vocab. The paper's W&S regime at extreme
scale: the 16384x53248 FFN matmuls are exactly the "gigantic tensor"
case OSDP's operator splitting targets.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family=DENSE,
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    act="swiglu",
    rope="rope",
    rope_theta=500_000.0,
    source="[arXiv:2407.21783]",
)
