"""Share of the traced solve's host window in which no kernel, copy or fill
ran on the card. Moves ``ba_solve_s``."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
