"""Prefill + single-token decode with a KV cache, dense family.  Twin of
the dense, unsharded paths of ``repro.models.decode``.

Cache layout (M = max_len, L = n_layers): k, v (L,B,M,KV,dh) in
``cfg.compute_dtype``.  Unlike the reference, which returns a new cache,
``decode_step`` writes the new token's K/V into the cache in place: the
cache of full-width llama3-8b is hundreds of MB, and a copy per step would
be pure traffic.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers, lm


# --------------------------------------------------------------------------- #
# cache specification
# --------------------------------------------------------------------------- #
def cache_spec(cfg, batch, max_len):
    """{name: (shape, dtype)} of the cache."""
    lm._check_family(cfg)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": (kv, cfg.compute_dtype), "v": (kv, cfg.compute_dtype)}


def init_cache(cfg, batch, max_len, device):
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in cache_spec(cfg, batch, max_len).items()}


# --------------------------------------------------------------------------- #
# attention block: prefill (returns the layer's K/V) + decode
# --------------------------------------------------------------------------- #
def _attn_prefill(p, x, cfg, positions):
    h = layers.rms_norm(x, p["ln1"])
    q, k, v = layers.qkv_project(p["attn"], h, cfg, positions)
    att = layers.prefill_attention(q, k, v)
    x = x + layers.attn_output(p["attn"], att, cfg)
    h2 = layers.rms_norm(x, p["ln2"])
    return x + layers.mlp_apply(p["ffn"], h2, cfg), (k, v)


def _attn_decode(p, x, kc, vc, pos, cfg):
    b = x.shape[0]
    h = layers.rms_norm(x, p["ln1"])
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = layers.qkv_project(p["attn"], h, cfg, positions)
    kc[:, pos:pos + 1] = k
    vc[:, pos:pos + 1] = v
    att = layers.decode_attention(q, kc, vc, pos + 1)
    x = x + layers.attn_output(p["attn"], att, cfg)
    h2 = layers.rms_norm(x, p["ln2"])
    return x + layers.mlp_apply(p["ffn"], h2, cfg)


# --------------------------------------------------------------------------- #
# prefill / decode
# --------------------------------------------------------------------------- #
@torch.no_grad()
def prefill(params, batch, cfg, max_len):
    """Run the full context; returns (last-token logits (B,V_padded), cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = init_cache(cfg, b, max_len, tokens.device)
    x = layers.embed_lookup(params["embed"], tokens, cfg)
    positions = lm.positions_for(tokens)
    for i in range(cfg.n_layers):
        x, (k, v) = _attn_prefill(lm.layer_slice(params["blocks"], i), x, cfg,
                                  positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = layers.rms_norm(x[:, -1:], params["ln_f"])
    return layers.unembed(params["embed"], x, cfg)[:, 0], cache


@torch.no_grad()
def decode_step(params, cache, token, pos: int, cfg):
    """token: (B,1) integer; pos: position of the new token.  Writes its K/V
    into ``cache`` in place; returns (logits (B,V_padded), cache)."""
    max_len = cache["k"].shape[2]
    if not 0 <= pos < max_len:
        raise IndexError(f"position {pos} is outside the cache of {max_len}")
    x = layers.embed_lookup(params["embed"], token, cfg)
    for i in range(cfg.n_layers):
        x = _attn_decode(lm.layer_slice(params["blocks"], i), x,
                         cache["k"][i], cache["v"][i], pos, cfg)
    x = layers.rms_norm(x, params["ln_f"])
    return layers.unembed(params["embed"], x, cfg)[:, 0], cache
