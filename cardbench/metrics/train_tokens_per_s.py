"""train_tokens_per_s (end to end, host clock): net training progress over
the whole window, (trainer step at the window's end - at its start) x
tokens per step / the window's wall seconds. A step rolled back and trained
again counts once, so persists, rollbacks, restores and replays that fall in
the window all lower it."""


def read(run):
    return run.net_steps * run.tokens_per_step / run.window_s
