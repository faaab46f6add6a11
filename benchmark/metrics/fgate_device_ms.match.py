"""Device milliseconds per chunk of pairs of every kernel of the traced
passes except kernel 1 (the top-2 kNN: kernels whose names hold
``knn_top2`` or ``knn_colarg``) and copies: the F-gate and the work around
the kNN. Moves ``match_pairs_per_s``."""


def _kernel1(name: str) -> bool:
    return "knn_top2" in name or "knn_colarg" in name


def read(run):
    chunks = run.counters["traced_passes"] * run.counters["chunks"]
    if run.trace is None or not chunks or not run.trace.kernels():
        return None
    return run.trace.kernel_s(lambda n: not _kernel1(n)) / chunks * 1e3
