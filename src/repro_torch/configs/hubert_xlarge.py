"""hubert-xlarge — HuBERT X-Large encoder. [arXiv:2106.07447]

Encoder-only (bidirectional, non-causal) transformer backbone, same
arch as wav2vec2. The conv waveform feature extractor is STUBBED per
the assignment carve-out: input_specs() supplies 1280-d frame
embeddings. Masked-prediction head over 504 k-means units.
No decode shapes (encoder-only) — see DESIGN.md §5.
"""
from repro_torch.configs.base import AUDIO, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family=AUDIO,
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,         # k-means targets; padded to 512 internally
    causal=False,
    encoder_only=True,
    rope="none",            # HuBERT uses conv positional embedding (stubbed
                            # into the frame embeddings); backbone is pos-free
    norm="layernorm",
    act="gelu",
    source="[arXiv:2106.07447]",
)
