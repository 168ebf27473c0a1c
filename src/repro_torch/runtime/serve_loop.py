"""Batched serving driver: prefill + greedy decode.  Twin of
``repro.runtime.serve_loop`` without the governor hook, which arrives with
the port's measurement pipeline (ROADMAP.md queue 1)."""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Decoding is greedy; the reference's unused ``greedy`` and ``seed``
    fields are left out until sampling is ported."""
    max_new_tokens: int = 32


def _wait(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, params, batch, sc: ServeConfig | None = None,
          max_len: int | None = None, device=None) -> dict:
    """Prefill ``batch["tokens"]`` (B,S), then decode greedily on ``device``
    (default ``cuda``), where ``params`` must already lie.  Returns the
    reference's dict: tokens (B, max_new_tokens), prefill_s, decode_s and
    tokens_per_s, with times on the host clock after the device finished."""
    if sc is None:
        sc = ServeConfig()
    dev = resolve_device(device)
    if params["embed"].device != dev:
        raise ValueError(f"params lie on {params['embed'].device}, not {dev}")
    tokens = batch["tokens"].to(dev)
    b, s = tokens.shape
    max_len = max_len or (s + sc.max_new_tokens)

    _wait(dev)
    t0 = time.perf_counter()
    logits, cache = decode.prefill(params, {"tokens": tokens}, cfg, max_len)
    _wait(dev)
    t_prefill = time.perf_counter() - t0

    tok = logits.argmax(-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(sc.max_new_tokens - 1):
        logits, cache = decode.decode_step(params, cache, tok, s + i, cfg)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    _wait(dev)
    t_decode = time.perf_counter() - t0

    return {
        "tokens": torch.cat(out, dim=1),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": (b * (sc.max_new_tokens - 1)) / max(t_decode, 1e-9),
    }
