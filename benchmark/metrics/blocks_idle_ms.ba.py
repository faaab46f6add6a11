"""Milliseconds per traced LM iteration in which the card sat idle inside
the program's ``ba.blocks`` span: the host's dispatch of the Jacobian and
normal blocks (``_normal_blocks`` or ``_build_pcg_blocks``). Moves
``ba_solve_s``."""

from benchmark import spans


def read(run):
    its = run.counters["traced_iterations"]
    idle = spans.idle_s(run.trace, "ba.blocks") if run.trace is not None else None
    if idle is None or not its:
        return None
    return idle / its * 1e3
