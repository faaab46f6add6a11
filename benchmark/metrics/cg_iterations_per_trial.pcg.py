"""CG iterations per damped LM trial in the traced solve: the program's
``ba.pcg.cg_iteration`` spans over its ``ba.trial`` spans (the host stops
CG at a read every 16 iterations, or at the cap). With
``trials_per_lm_iter.pcg`` it splits ``ba_solve_s`` into work done and the
speed of that work. Moves ``ba_solve_s``."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    trials = spans.count(run.trace, "ba.trial")
    its = spans.count(run.trace, "ba.pcg.cg_iteration")
    if not trials or not its:
        return None
    return its / trials
