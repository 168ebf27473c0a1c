from repro_torch.models import decode, layers, lm

__all__ = ["decode", "layers", "lm"]
