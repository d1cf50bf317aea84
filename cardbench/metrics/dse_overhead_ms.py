"""dse_overhead_ms (loop driver and DSE protocol, harness spans): the
window's time outside the train step, the restores and the harness's own
checks, a step: the driver, the data SO's batch, ``train_on`` around the
step, the metrics SO's record, and the refresher's share of the host."""


def read(run):
    steps = run.window_spans("step")
    if not steps:
        return None
    other = sum(steps) + sum(run.window_spans("restore")) + sum(run.window_spans("check"))
    return 1e3 * (run.window_s - other) / len(steps)
