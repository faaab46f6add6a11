"""Milliseconds per traced pass in which the card sat idle inside the
program's ``match.tables`` span: the reads of a pass's results to the host
and the host loop that fills its match tables. Moves ``match_pairs_per_s``."""

from benchmark import spans


def read(run):
    passes = run.counters["traced_passes"]
    idle = spans.idle_s(run.trace, "match.tables") if run.trace is not None else None
    if idle is None or not passes:
        return None
    return idle / passes * 1e3
