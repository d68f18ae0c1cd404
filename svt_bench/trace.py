"""What a ``torch.profiler`` trace of the window holds, in seconds on one
clock: the device's activities (kernels and copies), the host's events, and
the harness's own span around every call (``CALL_SPAN``).

The union of the device intervals is the arithmetic of the port's
``probes/common.py::profiled``, copied here so that the yardstick cannot
move with the program.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools

CALL_SPAN = "svtb.call"  # the harness's record_function range around each call
COPY_PREFIXES = ("Memcpy", "Memset")


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


@dataclasses.dataclass
class Trace:
    """Intervals ``(start, end, name)`` in seconds from the first call's
    start: ``device`` (sorted by start), ``host`` (every host event but the
    call spans) and ``calls`` (the call spans, in order)."""

    device: list
    host: list
    calls: list

    @property
    def window(self) -> tuple[float, float]:
        return self.calls[0][0], self.calls[-1][1]

    @functools.cached_property
    def union(self) -> list[tuple[float, float]]:
        """The device's activities merged into disjoint busy intervals, in
        time order."""
        out: list[list[float]] = []
        for start, end, _ in self.device:
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(start, end) for start, end in out]

    @functools.cached_property
    def _union_ends(self) -> list[float]:
        return [end for _, end in self.union]

    def covered_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi] in which the device ran something."""
        union = self.union
        busy, i = 0.0, bisect.bisect_right(self._union_ends, lo)
        while i < len(union) and union[i][0] < hi:
            busy += min(union[i][1], hi) - max(union[i][0], lo)
            i += 1
        return busy

    def busy_s(self) -> float:
        """Seconds of the window in which the device ran something."""
        return self.covered_s(*self.window)

    def gaps(self) -> list[tuple[float, float]]:
        """The window's idle intervals, in time order."""
        lo, hi = self.window
        edges = [lo] + [t for start, end in self.union if end > lo and start < hi
                        for t in (start, end)] + [hi]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost host event running
        then; ``python`` where none runs inside a call (the interpreter's own
        work), ``between calls`` outside them."""
        event = None
        for start, end, name in self.host:
            if start <= t <= end and (event is None or end - start < event[0]):
                event = (end - start, name)
        if event:
            return event[1]
        return "python" if any(s <= t <= e for s, e in self.calls) else "between calls"

    def exposed_s(self) -> list[float]:
        """For every call, its seconds in which no device activity ran: the
        host's time that the device does not hide, whatever order the call
        launches its work in."""
        return [(hi - lo) - self.covered_s(lo, hi) for lo, hi in self.calls]

    def device_sums(self, kernels_only: bool = False) -> dict[str, float]:
        """Seconds by device activity name inside the window."""
        lo, hi = self.window
        sums: dict[str, float] = {}
        for start, end, name in self.device:
            if end <= lo or start >= hi or (kernels_only and is_copy(name)):
                continue
            sums[name] = sums.get(name, 0.0) + (end - start)
        return sums


def from_profiler(prof) -> Trace | None:
    """The trace of a finished ``torch.profiler.profile``; None where it
    holds no call span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    raw = []  # (start, end) in integer nanoseconds, so no digit is lost
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        raw.append((start, start + e.duration_ns(), e.name(), e.device_type() == cuda))
    calls = sorted((s, t) for s, t, name, on_dev in raw if name == CALL_SPAN and not on_dev)
    if not calls:
        return None
    t0 = calls[0][0]

    def sec(ns):
        return (ns - t0) * 1e-9

    # the call span's range mirrored on the device's timeline is no device activity
    device = sorted((sec(s), sec(t), name) for s, t, name, on_dev in raw
                    if on_dev and name != CALL_SPAN)
    host = [(sec(s), sec(t), name) for s, t, name, on_dev in raw
            if not on_dev and name != CALL_SPAN]
    return Trace(device=device, host=host, calls=[(sec(s), sec(t)) for s, t in calls])
