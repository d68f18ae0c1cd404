"""``device.idle_share``: the share of the traced window (the first call's
start to the last call's end) in which no kernel or copy ran, in %."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - run.trace.busy_s() / (hi - lo))
