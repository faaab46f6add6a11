"""Kernel 1's share of its roofline in the traced passes: the least time of
its launches (operations between valid keypoints at the bf16 peak, or bytes
at the HBM rate; ``benchmark/roofline.py``) over their traced device time.
Moves ``match_pairs_per_s``."""


def _kernel1(name: str) -> bool:
    return "knn_top2" in name or "knn_colarg" in name


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s(_kernel1)
    if t <= 0.0:
        return None
    return 100.0 * run.counters["knn_bound_s"] * run.counters["traced_passes"] / t
