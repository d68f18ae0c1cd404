"""The host's time inside the program's own spans (``svt.plan``,
``svt.build``, ``svt.stage``, ``svt.launch``, ``svt.fetch``: host events of
the ``torch.profiler`` trace, on the clock of the device's activities) in
which no kernel or copy ran: each stage's share of ``host.exposed_ms``."""

from __future__ import annotations

import bisect

from svt_bench.trace import Trace


def exposed_s(trace: Trace, name: str, calls: list) -> list[float] | None:
    """For every call ``(start, end)``, the seconds inside the instances of
    the span ``name`` that start in it, cut to the call, in which the device
    ran nothing; None where the trace holds no such span."""
    instances = sorted((start, end) for start, end, what in trace.host if what == name)
    if not instances:
        return None
    starts = [start for start, _ in instances]
    out = []
    for lo, hi in calls:
        total = 0.0
        for start, end in instances[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]:
            start, end = max(start, lo), min(end, hi)
            total += (end - start) - trace.covered_s(start, end)
        out.append(total)
    return out


def mean_exposed_ms(trace: Trace | None, name: str) -> float | None:
    """The mean over the window's calls of ``exposed_s``, in ms; None
    without a trace or without the span."""
    if trace is None or not trace.calls:
        return None
    exposed = exposed_s(trace, name, trace.calls)
    if exposed is None:
        return None
    return 1e3 * sum(exposed) / len(exposed)
