"""persist_v0_s (checkpoint layer, harness span): adding the trainer SO to
the cluster, which builds it from the seeded weights and persists version 0
synchronously (``np.savez_compressed`` of parameters and moments, written
through ``VersionStore``)."""


def read(run):
    spans = [(b - a) / 1e9 for n, a, b in run.spans.items if n == "persist_v0"]
    return spans[0] if spans else None
