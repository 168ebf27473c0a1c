"""Load a parameter tree of the JAX reference into the port.

The port keeps the reference's tree layout (nested dicts; stacked layer
weights on dim 0; the embedding padded to ``cfg.padded_vocab`` rows), so
the conversion is leaf by leaf with no reshaping.  Leaves arrive as numpy
arrays (``jax.tree.map(np.asarray, params)`` on the reference side);
bfloat16 arrays, which numpy holds as an extension type, go through fp32.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device, dtype):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        dtype = dtype or torch.bfloat16
    t = torch.from_numpy(np.array(a)).to(device)     # a copy: writable
    return t if dtype is None else t.to(dtype)


def params_from_jax(tree, device, dtype=None):
    """Nested dict of arrays -> the same nested dict of tensors on
    ``device``, cast to ``dtype`` when given (else the arrays' own type)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return _leaf(tree, device, dtype)
