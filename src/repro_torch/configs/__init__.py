from repro_torch.configs.base import (
    ModelConfig, MoEConfig, MLAConfig, SSMConfig, HybridConfig, EncDecConfig,
    VLMConfig,
)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.shapes import ShapeSpec

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig",
    "EncDecConfig", "VLMConfig", "ARCH_IDS", "get_config", "ShapeSpec",
]
