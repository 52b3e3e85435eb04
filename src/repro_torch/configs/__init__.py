"""Config registry: the 10 assigned architectures + input shapes.

`get_arch(name)` accepts the assignment ids (with dashes/dots).
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    AUDIO, DENSE, HYBRID, MOE, SSM, VLM,
    DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K, SHAPES,
    SINGLE_POD_MESH, MULTI_POD_MESH, DEVICE_PRESETS,
    ILP_BACKENDS, PRESET_CATALOG, PRESET_OVERLAP, SOLVERS,
    DeviceInfo, DevicePreset, MeshConfig, ModelConfig, OSDPConfig,
    RunConfig, ShapeConfig, reduced,
)

from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2vl
from repro_torch.configs.llama3_405b import CONFIG as _llama3
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen15
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4

ARCHS = {
    c.name: c
    for c in (
        _arctic, _dbrx, _moonshot, _hymba, _qwen2vl,
        _llama3, _qwen15, _mamba2, _hubert, _phi4,
    )
}


def get_arch(name: str) -> ModelConfig:
    key = name.strip()
    if key in ARCHS:
        cfg = ARCHS[key]
    else:
        # tolerate underscore / case variants
        norm = key.lower().replace("_", "-")
        matches = [c for n, c in ARCHS.items() if n.lower() == norm]
        if not matches:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
        cfg = matches[0]
    cfg.validate()
    return cfg


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def supported_shapes(model: ModelConfig) -> list[str]:
    """Which assigned shapes run for this arch (skips per DESIGN.md §5)."""
    names = ["train_4k", "prefill_32k"]
    if model.is_decoder:
        names.append("decode_32k")
        names.append("long_500k")  # SWA/SSM path; see DESIGN.md §5
    return names
