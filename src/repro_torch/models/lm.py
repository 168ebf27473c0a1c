"""Decoder-only LM, dense family: init and inference forward.  Twin of the
dense paths of ``repro.models.lm``.

Layer weights are stacked on a leading dimension, as the reference stacks
them for ``lax.scan``; the scan becomes a loop over that dimension."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers


def _check_family(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1)")


# --------------------------------------------------------------------------- #
# parameter trees
# --------------------------------------------------------------------------- #
def _block_init(gen, cfg):
    dev = gen.device
    return {
        "attn": layers.attention_init(gen, cfg),
        "ffn": layers.mlp_init(gen, cfg),
        "ln1": layers.ones(cfg.d_model, cfg.param_dtype, dev),
        "ln2": layers.ones(cfg.d_model, cfg.param_dtype, dev),
    }


def _stacked_init(n, init_fn):
    """Init n layers into tensors stacked along dim 0, one layer at a time,
    so that no second copy of the stack is ever held."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        out = t.new_empty((n, *t.shape))
        out[0] = t
        return out

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    stacked = alloc(init_fn())
    for i in range(1, n):
        fill(stacked, init_fn(), i)
    return stacked


def layer_slice(tree, i):
    """Layer i of a stacked tree (views, no copy)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def init(cfg, seed: int = 0, device=None):
    """Random parameters for ``cfg`` drawn from ``torch.Generator(seed)`` on
    ``device`` (default ``cuda``); the reference's tree layout."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": layers.embed_init(gen, cfg),
        "ln_f": layers.ones(cfg.d_model, cfg.param_dtype, dev),
        "blocks": _stacked_init(cfg.n_layers, lambda: _block_init(gen, cfg)),
    }


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def positions_for(tokens):
    b, s = tokens.shape
    return torch.arange(s, device=tokens.device).expand(b, s)


def _block_apply(p, x, cfg, positions):
    h = layers.rms_norm(x, p["ln1"])
    q, k, v = layers.qkv_project(p["attn"], h, cfg, positions)
    att = layers.chunked_attention(q, k, v, causal=True)
    x = x + layers.attn_output(p["attn"], att, cfg)
    h = layers.rms_norm(x, p["ln2"])
    return x + layers.mlp_apply(p["ffn"], h, cfg)


@torch.no_grad()
def forward(params, batch, cfg):
    """batch: dict(tokens=(B,S) integer).  Returns logits (B,S,V_padded).
    The reference's second output, the MoE auxiliary loss, is 0 for the
    dense family and is left out."""
    _check_family(cfg)
    tokens = batch["tokens"]
    x = layers.embed_lookup(params["embed"], tokens, cfg)
    positions = positions_for(tokens)
    for i in range(cfg.n_layers):
        x = _block_apply(layer_slice(params["blocks"], i), x, cfg, positions)
    x = layers.rms_norm(x, params["ln_f"])
    return layers.unembed(params["embed"], x, cfg)
