"""Step builders, the training launcher and the multi-pod dry run (port of
``repro/launch``)."""
from .steps import (make_prefill_step, make_serve_step, make_step, make_train_step,
                    split_batch)

#: the dry run's names, imported on first use: ``dryrun`` imports
#: ``analysis``, whose modules import this package's ``mesh``
_DRYRUN = ("build_cell", "extrapolate", "scaled_pair", "skip_reason")


def __getattr__(name):
    if name in _DRYRUN:
        from . import dryrun

        return getattr(dryrun, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["make_prefill_step", "make_serve_step", "make_step", "make_train_step",
           "split_batch", *_DRYRUN]
