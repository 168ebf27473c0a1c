"""The port's dense building blocks against repro.models.layers, in fp32 on
the CPU at 1e-5, on the same numpy-seeded inputs and parameters."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import layers

TOL = 1e-5


def _configs(arch, **overrides):
    """(reference, port) smoke configs of ``arch`` in fp32."""
    ref = dataclasses.replace(ref_get_config(arch, smoke=True),
                              param_dtype=jnp.float32, compute_dtype=jnp.float32,
                              **overrides)
    port = dataclasses.replace(get_config(arch, smoke=True),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32, **overrides)
    return ref, port


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm():
    x, scale = _normal(2, 5, 64), _normal(64, seed=1)
    _close(layers.rms_norm(_t(x), _t(scale)), ref_layers.rms_norm(x, scale))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(fraction):
    x = _normal(2, 12, 4, 16)
    pos = np.broadcast_to(np.arange(3, 15), (2, 12)).copy()
    _close(layers.apply_rope(_t(x), _t(pos), 10000.0, fraction),
           ref_layers.apply_rope(x, pos, 10000.0, fraction))


def test_qkv_project_with_qk_norm():
    ref_cfg, cfg = _configs("qwen3-32b")
    assert cfg.qk_norm
    p = jax.tree.map(np.asarray, ref_layers.attention_init(
        jax.random.PRNGKey(0), ref_cfg)[0])
    p["q_norm"], p["k_norm"] = _normal(16, seed=2), _normal(16, seed=3)
    x = _normal(2, 10, 64, seed=4)
    pos = np.broadcast_to(np.arange(10), (2, 10)).copy()
    got = layers.qkv_project(params_from_jax(p, "cpu"), _t(x), cfg, _t(pos))
    want = ref_layers.qkv_project(p, x, ref_cfg, pos)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("arch", ["llama3-8b", "nemotron-4-15b"])
def test_mlp_apply(arch):
    ref_cfg, cfg = _configs(arch)
    p = jax.tree.map(np.asarray, ref_layers.mlp_init(jax.random.PRNGKey(0),
                                                     ref_cfg)[0])
    x = _normal(2, 6, 64, seed=1)
    _close(layers.mlp_apply(params_from_jax(p, "cpu"), _t(x), cfg),
           ref_layers.mlp_apply(p, x, ref_cfg))


def test_attn_output():
    ref_cfg, cfg = _configs("llama3-8b")
    p = jax.tree.map(np.asarray, ref_layers.attention_init(
        jax.random.PRNGKey(0), ref_cfg)[0])
    att = _normal(2, 6, 4, 16, seed=1)
    _close(layers.attn_output(params_from_jax(p, "cpu"), _t(att), cfg),
           ref_layers.attn_output(p, att, ref_cfg))


def test_embed_and_unembed_mask_padding():
    ref_cfg, cfg = _configs("llama3-8b", vocab=250)
    assert cfg.padded_vocab == 256
    emb, x = _normal(256, 64) * 0.02, _normal(2, 5, 64, seed=1)
    tokens = np.random.default_rng(2).integers(0, 250, (2, 5))
    _close(layers.embed_lookup(_t(emb), _t(tokens), cfg),
           ref_layers.embed_lookup(emb, tokens, ref_cfg))
    logits = layers.unembed(_t(emb), _t(x), cfg)
    _close(logits, ref_layers.unembed(emb, x, ref_cfg))
    assert bool((logits[..., 250:] == -1e30).all())
    assert int(logits.argmax(-1).max()) < 250


def test_decode_attention():
    q, kc, vc = _normal(2, 1, 4, 16), _normal(2, 12, 2, 16, seed=1), \
        _normal(2, 12, 2, 16, seed=2)
    _close(layers.decode_attention(_t(q), _t(kc), _t(vc), 7),
           ref_layers.decode_attention(q, kc, vc, 7))


def test_prefill_attention():
    q, k, v = _normal(2, 64, 4, 16), _normal(2, 64, 2, 16, seed=1), \
        _normal(2, 64, 2, 16, seed=2)
    _close(layers.prefill_attention(_t(q), _t(k), _t(v)),
           ref_layers.prefill_attention(q, k, v, kv_chunk=16))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention(causal):
    q, k, v = _normal(2, 40, 4, 16), _normal(2, 40, 2, 16, seed=1), \
        _normal(2, 40, 2, 16, seed=2)
    _close(layers.chunked_attention(_t(q), _t(k), _t(v), causal=causal),
           ref_layers.chunked_attention(q, k, v, causal=causal, kv_chunk=16))
