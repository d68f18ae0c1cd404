"""``call_p95_ms``: the 95th percentile of the wall time of every call in the
window (``statistics.quantiles``, inclusive), on the host's clock."""

import statistics


def read(run):
    times = run.call_ms()
    if len(times) < 2:
        return times[0] if times else None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
