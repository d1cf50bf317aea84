"""setup_s (end to end, host clock): process start to the window's start;
the version-0 persist that adding the trainer makes is in it."""


def read(run):
    return run.setup_s
