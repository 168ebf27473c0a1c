"""PyTorch/CUDA port of the ``repro`` runtime for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports none of
it and no JAX.  Entry points run on the ``cuda`` device unless the caller
passes ``device="cpu"``; see :func:`repro_torch.device.resolve_device`.
"""
