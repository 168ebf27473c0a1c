"""Public wrapper of the flash-attention kernel.

On CUDA tensors it launches the Hopper kernel (``kernel.py``) or raises;
on CPU tensors it computes the plain version (``ref.py``).  ``LAUNCHES``
counts the kernel's launches, so a run can show that its path went
through the kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import naive_attention

LAUNCHES = 0
MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)
_GRID_MAX = 65535          # the kernel puts heads and batch on grid y and z


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B,Sq,H,dh), k (B,Sk,KV,dh) "
                         "and v (B,Sk,KV,dv)")
    b, sq, h, dh = q.shape
    bk, sk, kvh, dhk = k.shape
    if (bk, sk, kvh) != tuple(v.shape[:3]) or bk != b or dhk != dh:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} are not a multiple of kv heads {kvh}")
    if min(b, sq, sk, h, dh, v.shape[-1]) == 0:
        raise ValueError("flash_attention takes no empty dimension")
    if {q.device, k.device, v.device} != {q.device}:
        raise ValueError("q, k and v lie on different devices")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k and v differ in dtype")


def flash_attention(q, k, v, causal: bool = True):
    """Forward attention, causal or not, with GQA (H = KV * G).

    q: (B,Sq,H,dh), k: (B,Sk,KV,dh), v: (B,Sk,KV,dv) -> (B,Sq,H,dv) in
    q's dtype.  The kernel takes contiguous fp32 or bf16 tensors with dh
    and dv up to 128."""
    global LAUNCHES
    _check(q, k, v)
    if q.device.type == "cpu":
        return naive_attention(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the kernel takes {_DTYPES}, not {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k and v")
    b, _, h, dh = q.shape
    dv = v.shape[-1]
    if dh > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"not dh={dh}, dv={dv}")
    if h > _GRID_MAX or b > _GRID_MAX:
        raise ValueError(f"the kernel takes at most {_GRID_MAX} heads and batch rows")
    out = torch.empty((*q.shape[:3], dv), dtype=q.dtype, device=q.device)
    err = kernel.launch(q, k, v, out, causal)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
