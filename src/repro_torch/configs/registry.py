"""Architecture registry: ``--arch <id>`` selection surface.

Twin of ``repro.configs.registry`` for the architectures the port runs so
far: the four dense ones.  The other reference architectures are known by
name and refused until their slice is ported (ROADMAP.md, queue 1)."""
from __future__ import annotations

from repro_torch.configs import chatglm3_6b, llama3_8b, nemotron_4_15b, qwen3_32b

_MODULES = {
    "llama3-8b": llama3_8b,
    "nemotron-4-15b": nemotron_4_15b,
    "chatglm3-6b": chatglm3_6b,
    "qwen3-32b": qwen3_32b,
}

_NOT_PORTED = ("whisper-medium", "deepseek-moe-16b", "deepseek-v2-236b",
               "mamba2-130m", "hymba-1.5b", "pixtral-12b")

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to PyTorch yet; ROADMAP.md queue 1 "
            f"lists when its family comes; ported: {', '.join(ARCH_IDS)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    mod = _MODULES[arch]
    return mod.smoke_config() if smoke else mod.config()
