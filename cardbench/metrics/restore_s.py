"""restore_s (checkpoint and recovery, harness spans): the window's
``cluster.kill`` calls: the crash, the factory's re-init, ``Connect`` and
``TrainerStateObject.Restore`` of the durable version. Nothing to read in
a cell without a kill."""


def read(run):
    spans = run.window_spans("restore")
    return sum(spans) if spans else None
