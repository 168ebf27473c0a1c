"""Deterministic synthetic token pipeline.  Twin of ``repro.data.synthetic``
for token batches.

Step-indexed draws: ``batch_at(step)`` is a pure function of
``(seed, step)``, because its ``torch.Generator`` is seeded from that pair,
so a restarted job resumes with no data state to persist.  The "language"
is the reference's: each token is ``(prev*31+17) % vocab`` with probability
``markov_weight``, else uniform noise.  The random bits are torch's, not
JAX's, so the two packages draw different batches from one seed.
"""
from __future__ import annotations

import dataclasses

import torch

_MIX = 0x9E3779B97F4A7C15          # odd 64-bit constant spreading seeds apart


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed * _MIX + step) % (1 << 63))


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_weight: float = 0.8     # P(next = f(prev)) vs uniform

    def batch_at(self, step: int) -> dict:
        """{"tokens": (B,S) int64 on the CPU}."""
        gen = _generator(self.seed, step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        prev = torch.randint(0, v, (b,), generator=gen)
        noise = torch.randint(0, v, (b, s), generator=gen)
        use_markov = torch.rand((b, s), generator=gen) < self.markov_weight
        toks = torch.empty((b, s), dtype=torch.long)
        for t in range(s):
            prev = torch.where(use_markov[:, t], (prev * 31 + 17) % v, noise[:, t])
            toks[:, t] = prev
        return {"tokens": toks}


def make_batch(cfg, shape, step: int = 0, seed: int = 0) -> dict:
    """Token batch for an (arch config, ShapeSpec) cell."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"batches for family {cfg.family!r} are not ported yet")
    return SyntheticTokens(cfg.vocab, shape.seq_len, shape.global_batch,
                           seed).batch_at(step)
