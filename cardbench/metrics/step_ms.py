"""step_ms (step layer, harness spans): the mean of the window's spans
around the system's train step (``launch/steps.py::make_train_step``:
forward, loss, autograd, AdamW), each up to the loss on the host."""


def read(run):
    steps = run.window_spans("step")
    return 1e3 * sum(steps) / len(steps) if steps else None
