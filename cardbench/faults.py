"""Faults planted under the timed path, to show that the check catches them
(``test_cardbench_faults.py`` on the CPU, ``calibrate.py`` on the card).
Each wraps a piece of the run; a benchmark run never uses them."""
from __future__ import annotations

import numpy as np


def unchanged(step_fn):
    """A step that computes its loss and returns its state unchanged."""
    def step(params, opt_state, batch):
        _, _, loss = step_fn(params, opt_state, batch)
        return params, opt_state, loss
    return step


def half_batch(step_fn):
    """A step that leaves out half of the batch, the mean taken over the rest."""
    def step(params, opt_state, batch):
        tokens = batch["tokens"]
        return step_fn(params, opt_state, {**batch, "tokens": tokens[: len(tokens) // 2]})
    return step


class AlteredToken:
    """The token stream with one token of each batch altered where it is
    produced (row 0, a third of the way in)."""

    def __init__(self, stream) -> None:
        self.stream = stream

    def __getattr__(self, name):
        return getattr(self.stream, name)

    def batch_at(self, step: int) -> np.ndarray:
        toks = self.stream.batch_at(step).copy()
        j = toks.shape[1] // 3
        toks[0, j] = (toks[0, j] + 1) % self.stream.vocab_size
        return toks


STEP_FAULTS = {"unchanged": unchanged, "half_batch": half_batch}
TOKEN_FAULTS = {"altered_token": AlteredToken}
