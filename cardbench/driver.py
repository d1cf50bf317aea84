"""The training loop's driver, as the benchmark runs it.

A frozen copy of the loop body of the system's
``train/loop.py::run_resilient_training``: data SO -> trainer SO ->
metrics SO on a ``LocalCluster``, with its resync after a rollback (seek the
data cursor, re-record the trainer's loss history into the metrics SO) and
its retry on a delayed or rolled-back message. The loop's own function
cannot be called here: it builds its own initial state, runs a step count
rather than a window, and sets one group-commit cadence for every
StateObject. What the copy adds is a hook after every step that returned,
through which the harness ends the window, injects the traffic's kills and
takes its readings.
"""
from __future__ import annotations

from typing import Callable


class Driver:
    def __init__(self, cluster, delay_errors: tuple) -> None:
        self.cluster = cluster
        self.delay_errors = delay_errors
        self.rollbacks = 0
        self.last_world = cluster.get("trainer").runtime.world

    def run(self, after_step: Callable[[int, float], bool]) -> None:
        """Train until ``after_step(step, loss)``, called after each step
        that returned, returns True."""
        cluster = self.cluster
        while True:
            trainer = cluster.get("trainer")
            data_so = cluster.get("data")
            metrics = cluster.get("metrics")
            if trainer.runtime.world > self.last_world:  # a recovery happened
                self.rollbacks += trainer.runtime.world - self.last_world
                self.last_world = trainer.runtime.world
            t_step = trainer.current_step()
            try:
                if data_so.peek_cursor() != t_step:
                    data_so.seek(t_step)  # resync after rollback/restart
                    snap = trainer.history_snapshot()
                    if snap is not None:
                        history, hh = snap
                        have = {s for s, _ in metrics.records}
                        for s, l in history:
                            if s not in have:
                                metrics.record(s, l, hh)
                out = data_so.next_batch()
                if out is None:
                    continue
                step, tokens, hdr = out
                res = trainer.train_on(step, tokens, hdr)
                if res is None:
                    cluster.refresh_all()
                    continue
                if isinstance(res, tuple) and res[0] == "resync":
                    continue
                loss, thdr = res
                metrics.record(step, loss, thdr)
            except self.delay_errors:
                cluster.refresh_all()
                continue
            if after_step(step, loss):
                return
