"""Damped trials per LM iteration in the traced solve: the program's
``ba.trial`` spans that ended in the window over the traced LM iterations
(each rejected trial re-runs the PCG solve at a larger damping). Moves
``ba_solve_s``."""

from benchmark import spans


def read(run):
    its = run.counters["traced_iterations"]
    trials = spans.count(run.trace, "ba.trial") if run.trace is not None else 0
    if not trials or not its:
        return None
    return trials / its
