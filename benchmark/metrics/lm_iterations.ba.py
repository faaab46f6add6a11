"""LM iterations per solve (the solver's ``BAResult.iterations``), the mean
over the window's solves. Moves ``ba_solve_s``."""


def read(run):
    its = run.counters["iterations"]
    return sum(its) / len(its) if its else None
