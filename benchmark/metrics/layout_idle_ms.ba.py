"""Milliseconds per solve in which the card sat idle inside the program's
``ba.layout`` span: the per-solve gather tables (``ba.lm._layout``'s numpy
tables, or ``ba.distributed._layouts``' segment layouts). Moves
``ba_solve_s``."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    n = spans.count(run.trace, "ba.layout")
    idle = spans.idle_s(run.trace, "ba.layout")
    if idle is None or not n:
        return None
    return idle / n * 1e3
