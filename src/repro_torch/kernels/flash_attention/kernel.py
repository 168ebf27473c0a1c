"""ctypes launch of the Hopper flash-attention kernel in
``csrc/flash_attention.cu``.  Nothing here checks its arguments: the
wrapper in ``ops.py`` does, and is the only caller."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library().repro_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, out, causal: bool) -> int:
    """Enqueue the kernel on the current stream; returns the CUDA error
    code of the launch (0 on success)."""
    b, sq, h, dh = q.shape
    sk, kvh, dv = k.shape[1], k.shape[2], v.shape[-1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        return _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, sq, sk, h, kvh, dh, dv, int(causal),
                        1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype], stream)
