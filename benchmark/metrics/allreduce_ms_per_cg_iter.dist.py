"""Host milliseconds inside the program's ``mesh.all_sum`` spans (the
flattening copy and the ``all_reduce`` call of ``parallel.mesh.all_sum``) on
rank 0 per CG iteration (``ba.pcg.cg_iteration`` spans) of the traced
solve: what the collectives cost the host's dispatch per CG iteration. Under
NCCL the call returns once the reduction is queued; its device time is what
``allreduce_busbw_pct.dist`` reads. None where the program has no such span.
Moves ``ba_solve_s``."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    its = spans.count(run.trace, "ba.pcg.cg_iteration")
    ends = run.trace.window[1]
    inside = [(s, e) for s, e in spans.intervals(run.trace, "mesh.all_sum") if e <= ends]
    if not its or not inside:
        return None
    return sum(e - s for s, e in inside) * 1e-3 / its
