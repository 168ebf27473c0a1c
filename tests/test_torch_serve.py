"""The serving slice end to end on llama3-8b-smoke in fp32: the port's
prefill, decode and serve loop against repro.models.decode and
repro.runtime.serve_loop on the reference's parameters, plus the port's
own decode-vs-forward twin, params_from_jax and make_batch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import decode as ref_decode, lm as ref_lm
from repro.parallel.sharding import make_env
from repro.runtime.serve_loop import ServeConfig as RefServeConfig, serve as ref_serve
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import SyntheticTokens, make_batch
from repro_torch.models import decode, lm
from repro_torch.runtime.serve_loop import ServeConfig, serve

ENV = make_env(None, None)
TOL = 2e-3                     # the bound of tests/test_models.py:81-90
B, CTX, STEPS = 2, 16, 8


def _configs(**overrides):
    ref = dataclasses.replace(ref_get_config("llama3-8b", smoke=True),
                              param_dtype=jnp.float32, compute_dtype=jnp.float32,
                              **overrides)
    port = dataclasses.replace(get_config("llama3-8b", smoke=True),
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32, **overrides)
    return ref, port


@pytest.fixture(scope="module")
def model():
    ref_cfg, cfg = _configs()
    ref_params, _ = ref_lm.init(jax.random.PRNGKey(1), ref_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, CTX + STEPS))
    return ref_cfg, cfg, ref_params, params, tokens


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trip(dtype):
    ref_cfg = dataclasses.replace(ref_get_config("llama3-8b", smoke=True),
                                  vocab=250, param_dtype=getattr(jnp, dtype))
    tree = jax.tree.map(np.asarray, ref_lm.init(jax.random.PRNGKey(0), ref_cfg)[0])
    params = params_from_jax(tree, "cpu")
    assert params["embed"].shape == (256, 64)            # padded rows kept
    flat_ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_ref:
        t = params
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, dtype)
        assert tuple(t.shape) == leaf.shape and t.is_contiguous()
        if "blocks" == path[0].key:
            assert t.shape[0] == ref_cfg.n_layers          # stacked on dim 0
        np.testing.assert_array_equal(t.float().numpy(), leaf.astype(np.float32))


def test_prefill_and_decode_match_reference(model):
    ref_cfg, cfg, ref_params, params, tokens = model
    max_len = CTX + STEPS
    ref_logits, ref_cache = ref_decode.prefill(
        ref_params, {"tokens": jnp.asarray(tokens[:, :CTX])}, ref_cfg, ENV, max_len)
    logits, cache = decode.prefill(params, {"tokens": torch.from_numpy(tokens[:, :CTX])},
                                   cfg, max_len)
    _close(logits, ref_logits)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    for i in range(CTX, CTX + STEPS):
        ref_logits, ref_cache = ref_decode.decode_step(
            ref_params, ref_cache, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(i),
            ref_cfg, ENV)
        logits, cache = decode.decode_step(
            params, cache, torch.from_numpy(tokens[:, i:i + 1]), i, cfg)
        _close(logits, ref_logits)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])


def test_decode_matches_forward(model):
    _, cfg, _, params, tokens = model
    tokens = torch.from_numpy(tokens)
    full = lm.forward(params, {"tokens": tokens}, cfg)
    logits, cache = decode.prefill(params, {"tokens": tokens[:, :CTX]}, cfg,
                                   CTX + STEPS)
    np.testing.assert_allclose(logits.numpy(), full[:, CTX - 1].numpy(),
                               atol=TOL, rtol=TOL)
    for i in range(CTX, CTX + STEPS):
        logits, cache = decode.decode_step(params, cache, tokens[:, i:i + 1], i, cfg)
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                   atol=TOL, rtol=TOL)


def test_serve_matches_reference_greedy_tokens(model):
    ref_cfg, cfg, ref_params, params, tokens = model
    prompt = tokens[:, :CTX]
    want = np.asarray(ref_serve(ref_cfg, ENV, ref_params,
                                {"tokens": jnp.asarray(prompt)},
                                RefServeConfig(max_new_tokens=STEPS))["tokens"])
    got = serve(cfg, params, {"tokens": torch.from_numpy(prompt)},
                ServeConfig(max_new_tokens=STEPS), device="cpu")["tokens"].numpy()

    # the reference's top-1 margin along its own greedy path: a step whose
    # margin is within the tolerance may pick either token, and every later
    # step depends on it, so tokens are compared up to the first such step
    logits, cache = ref_decode.prefill(ref_params, {"tokens": jnp.asarray(prompt)},
                                       ref_cfg, ENV, CTX + STEPS)
    margins = []
    for i in range(STEPS):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if i < STEPS - 1:
            logits, cache = ref_decode.decode_step(
                ref_params, cache, jnp.asarray(want[:, i:i + 1]), jnp.int32(CTX + i),
                ref_cfg, ENV)
    clear = np.cumprod(np.stack(margins, 1) > TOL, axis=1).astype(bool)
    assert clear.sum() >= B * STEPS // 2, "too few steps with a clear margin"
    np.testing.assert_array_equal(got[clear], want[clear])


def test_make_batch_is_deterministic_and_follows_the_grammar():
    cfg = get_config("llama3-8b", smoke=True)
    shape = ShapeSpec("t", 128, 8, "prefill")
    a = make_batch(cfg, shape, step=3, seed=5)["tokens"]
    assert a.shape == (8, 128) and a.dtype == torch.long
    assert torch.equal(a, make_batch(cfg, shape, step=3, seed=5)["tokens"])
    assert not torch.equal(a, make_batch(cfg, shape, step=4, seed=5)["tokens"])
    assert not torch.equal(a, make_batch(cfg, shape, step=3, seed=6)["tokens"])
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    follows = (a[:, 1:] == (a[:, :-1] * 31 + 17) % cfg.vocab).float().mean()
    w = SyntheticTokens(cfg.vocab, 128, 8).markov_weight
    assert abs(float(follows) - w) < 0.05
