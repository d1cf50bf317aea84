"""train_mfu (step layer, host clock and shapes): the model FLOPs of the
window's net steps (``flops/<family>.py``) over the window's seconds times
the card's float32 peak (``peaks.json``), in percent. The configurations
compute in float32 with TF32 off, so float32 is the peak that bounds them.
Nothing to read on a device the table does not hold."""


def read(run):
    peak = run.peaks.get("float32_flops_per_s")
    if peak is None:
        return None
    return 100.0 * run.net_steps * run.flops_per_step / (run.window_s * peak)
