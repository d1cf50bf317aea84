"""Step builders and the training launcher (port of ``repro/launch``)."""
from .steps import (make_prefill_step, make_serve_step, make_step, make_train_step,
                    split_batch)

__all__ = ["make_prefill_step", "make_serve_step", "make_step", "make_train_step",
           "split_batch"]
