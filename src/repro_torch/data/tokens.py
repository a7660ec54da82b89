"""Deterministic synthetic LM token pipeline.

The port's own copy of ``repro.data.tokens`` (numpy only; the port imports
nothing of the reference), so both packages draw the same token streams
from the same seed.

Produces reproducible (tokens, targets) batches keyed by (seed, step, shard)
so that checkpoint-restart replays the exact stream — the property the fault
tolerance tests assert. The "corpus" is a fixed-vocabulary Markov-ish stream
generated on host with numpy (no tokenizer dependency); entropy is tunable
so small models show a real, declining loss curve.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # markov order of the synthetic stream
    n_modes: int = 64       # latent transition modes (lower = more learnable)


class SyntheticTokens:
    """Stateless loader: ``batch(step, shard, n_shards)`` is pure."""

    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # low-rank transition structure: token -> mode -> next-token peak
        self._mode_of = rng.integers(0, cfg.n_modes, size=v)
        self._peak_of = rng.integers(0, v, size=cfg.n_modes)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        """Returns (tokens, targets): (local_batch, seq_len) int32."""
        cfg = self.cfg
        local = cfg.global_batch // n_shards
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + shard)
        toks = np.empty((local, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=local)
        noise = rng.random((local, cfg.seq_len))
        rand_tok = rng.integers(0, cfg.vocab_size, size=(local, cfg.seq_len))
        for t in range(cfg.seq_len):
            peak = self._peak_of[self._mode_of[toks[:, t]]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.75,
                                      (peak + (rand_tok[:, t] % 7)) % cfg.vocab_size,
                                      rand_tok[:, t])
        return toks[:, :-1], toks[:, 1:]
