"""Milliseconds per chunk of pairs in which the card sat idle inside the
program's ``match.fgate`` span: the host's dispatch of the F-gate (sampling,
hypotheses, classify and refit). Moves ``match_pairs_per_s``."""

from benchmark import spans


def read(run):
    chunks = run.counters["traced_passes"] * run.counters["chunks"]
    idle = spans.idle_s(run.trace, "match.fgate") if run.trace is not None else None
    if idle is None or not chunks:
        return None
    return idle / chunks * 1e3
