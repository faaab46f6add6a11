"""Kernel launches on the card per image pair in the traced passes: the
host's dispatch of ``match_features`` (driver, sharded matcher, kNN, F-gate).
Moves ``match_pairs_per_s``."""


def read(run):
    n = run.counters["traced_passes"] * run.counters["pairs"]
    if run.trace is None or not n or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / n
