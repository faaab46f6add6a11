"""Kernels 5 and 6 (the fixed-order segment sums ``seg_sum_kernel`` and the
fused Schur sums ``schur_sum_kernel``) against their roofline in the traced
solve: the bytes their calls must move at the HBM rate
(``benchmark/roofline.py``), summed over the calls, over their summed traced
device time. Moves ``ba_solve_s``."""


def _sums(name: str) -> bool:
    return "seg_sum_kernel" in name or "schur_sum_kernel" in name


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_s(_sums)
    if t <= 0.0 or not run.counters.get("schur_calls"):
        return None
    return 100.0 * run.counters["schur_bound_s"] / t
