"""repro.durable — synchronous durable-execution baseline runtime.

The paper's Figure-9 baseline (Temporal / Durable-Functions / Beldi-style
per-step synchronous persistence) generalized from workflows to every
StateObject service, and the repo's differential-test oracle: a runtime
that persists synchronously before every externally-visible effect is
trivially correct, so any divergence from the speculative stack under
identical ops and faults is a bug in speculation/rollback
(``repro.sim.differential``).
"""
from .runtime import DurableRuntime

__all__ = ["DurableRuntime"]
