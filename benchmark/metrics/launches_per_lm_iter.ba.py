"""Kernel launches on the card per LM iteration in the traced solve: the
host's dispatch of the solver. Moves ``ba_solve_s``."""


def read(run):
    its = run.counters["traced_iterations"]
    if run.trace is None or not its or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / its
