"""The token generator: one general generator that every training traffic
file (``traffic/<name>.json``) parameterises.

A frozen copy of the synthetic LM stream of the system's data pipeline:
``batch_at(step)`` is a pure function of (seed, step), so a step replayed
after a rollback gets the same bytes. Each row is ``seq_len + 1`` tokens
drawn as floor((vocab - 1) * u ** zipf_power), u uniform (a Zipf-like
marginal), with the first half of the row repeated in its second half."""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, global_batch: int, seq_len: int, seed: int,
                 zipf_power: float = 3.0, repeat_half: bool = True) -> None:
        self.vocab_size = vocab_size
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = int(seed) & ((1 << 64) - 1)
        self.zipf_power = zipf_power
        self.repeat_half = repeat_half

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        u = rng.random((self.global_batch, self.seq_len + 1))
        toks = np.floor((self.vocab_size - 1) * u ** self.zipf_power).astype(np.int32)
        if self.repeat_half:
            half = (self.seq_len + 1) // 2
            toks[:, half: 2 * half] = toks[:, :half]
        return toks
