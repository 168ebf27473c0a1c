from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import naive_attention

__all__ = ["flash_attention", "naive_attention"]
