"""device_idle_pct (device, device trace): the share of the traced window
in which no kernel, copy or set ran on the card."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0 or run.trace["n_events"] == 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
