"""The all-reduces' share of their roofline on rank 0 in the traced solve:
the bytes that rank 0 handed ``parallel.mesh.all_sum`` in the traced part
(its ``ALL_REDUCE_BYTES`` counter), as a ring over the cell's ranks moves
them over each link (2 (n - 1) / n of them), over the device time of the
NCCL all-reduce kernels in rank 0's trace, against one NVLink 4 link set's
peak (``benchmark/roofline_collectives.py``). None where the program keeps
no byte counter or the trace holds no all-reduce kernel. Moves
``ba_solve_s``."""

from benchmark import roofline_collectives


def _allreduce(name: str) -> bool:
    return "nccl" in name.lower() and "allreduce" in name.lower()


def read(run):
    nbytes = run.counters.get("allreduce_bytes")
    if run.trace is None or not nbytes:
        return None
    t = run.trace.kernel_s(_allreduce)
    if t <= 0.0:
        return None
    bound = roofline_collectives.ring_allreduce_bound_s(nbytes, run.counters["ranks"])
    return 100.0 * bound / t
