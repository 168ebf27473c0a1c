"""Plain PyTorch version of the flash-attention kernel: the O(S^2)-memory
naive attention, twin of ``repro.models.layers.naive_attention``."""
from __future__ import annotations

import math

import torch


def naive_attention(q, k, v, *, causal=True):
    """q: (B,Sq,H,dh), k: (B,Sk,KV,dh), v: (B,Sk,KV,dv) -> (B,Sq,H,dv).

    Products run in the input type, scores and softmax in fp32, and the
    probabilities are cast back to the input type before the second
    product, as in the reference."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    scores = scores * (1.0 / math.sqrt(dh))
    if causal:
        qpos = torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), v)
    return out.reshape(b, sq, h, v.shape[-1])
