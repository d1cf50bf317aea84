"""Performance-tuning flags (port of ``repro/models/tuning.py``).

A context-var style switchboard, so one call site can run the same step in
baseline and tuned variants without touching model call signatures:

  decode_seq_constraint — decode attention contracts the query, reshaped to
      (B, S, Nkv, G, H), against the un-repeated K/V cache (the reference's
      flash-decode einsum);
  loss_chunk — compute the LM head + cross-entropy over sequence chunks of
      this size (0 = off), bounding the f32 logits working set;
  microbatch — grad-accumulation microbatches per step (1 = off), dividing
      saved-activation memory;
  constrain_activations — accepted, and read by nothing: the reference
      pins (B, S, D) activations to batch sharding at every block boundary;
  moe_impl — "einsum" (GShard grouped one-hot dispatch, ``layers.moe``) or
      "ep" (the index-based dispatch with expert parallelism over an
      all-to-all, ``parallel/ep_moe.py``). As in the reference, "ep" takes
      that route only under an EP mesh (``ep_mesh(...)``, read by
      ``get_ep_mesh``), a world of one included, and the einsum dispatch
      without one; ``layers.moe`` adds the shared experts outside the route.

The reference's ``constrain*`` helpers (``with_sharding_constraint`` under
the ambient mesh, also applied to the decode cache and query under
``decode_seq_constraint``) have no counterpart: the port keeps every
tensor whole on its device (``parallel/ep_moe.py`` slices its own).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Tuning:
    decode_seq_constraint: bool = False
    loss_chunk: int = 0
    microbatch: int = 1
    constrain_activations: bool = False
    moe_impl: str = "einsum"


_CURRENT = Tuning()


def get_tuning() -> Tuning:
    return _CURRENT


class tuning:
    def __init__(self, **kw) -> None:
        self._kw = kw

    def __enter__(self) -> Tuning:
        global _CURRENT
        self._prev = _CURRENT
        _CURRENT = replace(_CURRENT, **self._kw)
        return _CURRENT

    def __exit__(self, *exc) -> None:
        global _CURRENT
        _CURRENT = self._prev
