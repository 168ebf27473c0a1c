"""Transformer building blocks for the dense family: norms, RoPE, GQA
attention, MLPs, embedding.  Twin of ``repro.models.layers``.

Conventions
-----------
* Parameters are nested dicts of tensors in the reference's layout, so a
  reference tree loads one-to-one (``repro_torch.convert``).  Init
  functions draw from a ``torch.Generator`` on the target device and return
  the parameters alone; the reference's logical-axes trees serve sharding,
  which the port has not reached yet.
* Activations flow in ``cfg.compute_dtype``; softmax statistics and
  normalization accumulate in fp32.
* Causal attention over a whole sequence goes through the Hopper kernel in
  ``repro_torch.kernels.flash_attention`` (its plain version on the CPU);
  single-token decode attention is plain tensor code, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention


# --------------------------------------------------------------------------- #
# init helpers
# --------------------------------------------------------------------------- #
def dense_init(gen, shape, dtype, scale=None):
    """Normal weights scaled by 1/sqrt(shape[0]), drawn in fp32 on the
    generator's device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) > 1 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


def ones(n, dtype, device):
    return torch.ones((n,), dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------- #
# RoPE (with partial-rotary support for chatglm3's "2d" rope)
# --------------------------------------------------------------------------- #
def rope_freqs(dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta=10000.0, fraction=1.0):
    """x: (..., S, H, dh); positions: (..., S) integer."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)                 # (rot/2,)
    ang = positions.float()[..., None] * freqs               # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def attention_init(gen, cfg):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dt = cfg.param_dtype
    p = {
        "wq": dense_init(gen, (d, h, dh), dt),
        "wk": dense_init(gen, (d, kv, dh), dt),
        "wv": dense_init(gen, (d, kv, dh), dt),
        "wo": dense_init(gen, (h, dh, d), dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = ones(dh, dt, gen.device)
        p["k_norm"] = ones(dh, dt, gen.device)
    return p


def _project(x, w, cd):
    """x (B,S,D) times w (D,N,k) -> (B,S,N,k)."""
    b, s, d = x.shape
    return (x @ w.to(cd).reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def qkv_project(p, x, cfg, positions):
    """x: (B,S,D) -> q (B,S,H,dh), k/v (B,S,KV,dh) with rope + optional qk-norm."""
    cd = cfg.compute_dtype
    q = _project(x, p["wq"], cd)
    k = _project(x, p["wk"], cd)
    v = _project(x, p["wv"], cd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.rope_fraction > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def attn_output(p, attn, cfg):
    b, s, h, dh = attn.shape
    wo = p["wo"].to(cfg.compute_dtype)
    return attn.reshape(b, s, h * dh) @ wo.reshape(h * dh, -1)


def chunked_attention(q, k, v, *, causal=True):
    """Blockwise (flash) attention forward over a whole sequence, positions
    from 0: the kernel's online softmax over key blocks is the reference's
    scan over KV chunks."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal)


def prefill_attention(q, k, v):
    """Causal prefill attention.  The reference walks a triangular schedule
    of block pairs so that no block above the diagonal is computed; the
    kernel's loop over key blocks stops at the diagonal to the same end."""
    return chunked_attention(q, k, v, causal=True)


def decode_attention(q, k_cache, v_cache, cur_len):
    """Single-token decode against a KV cache.

    q: (B,1,H,dh); caches: (B,S,KV,dh); cur_len: number of valid cache
    entries (the new token's KV must already be written)."""
    b, _, h, dh = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kvh, h // kvh, dh)
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float()
    scores = scores * (1.0 / math.sqrt(dh))
    mask = torch.arange(s, device=q.device) < cur_len
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(q.dtype), v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #
def mlp_init(gen, cfg):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp == "swiglu":
        return {"wg": dense_init(gen, (d, f), dt),
                "wu": dense_init(gen, (d, f), dt),
                "wd": dense_init(gen, (f, d), dt)}
    if cfg.mlp == "relu2":
        return {"wu": dense_init(gen, (d, f), dt),
                "wd": dense_init(gen, (f, d), dt)}
    raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported yet")


def mlp_apply(p, x, cfg):
    cd = cfg.compute_dtype
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["wg"].to(cd)) * (x @ p["wu"].to(cd))
    elif cfg.mlp == "relu2":
        r = torch.relu(x @ p["wu"].to(cd))
        h = r * r
    else:
        raise NotImplementedError(f"mlp {cfg.mlp!r} is not ported yet")
    return h @ p["wd"].to(cd)


# --------------------------------------------------------------------------- #
# embedding / unembedding
# --------------------------------------------------------------------------- #
def embed_init(gen, cfg):
    """Vocab padded to cfg.vocab_pad_to, as in the reference."""
    return dense_init(gen, (cfg.padded_vocab, cfg.d_model), cfg.param_dtype,
                      scale=0.02)


def embed_lookup(emb, tokens, cfg):
    return F.embedding(tokens, emb.to(cfg.compute_dtype))


def unembed(emb, x, cfg):
    """Tied unembedding: (B,S,D) @ (V,D)^T -> (B,S,V_padded); padding ids
    masked to -1e30 so sampling never selects them."""
    logits = x @ emb.to(cfg.compute_dtype).T
    if cfg.padded_vocab != cfg.vocab:
        mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits
