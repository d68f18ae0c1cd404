"""Profiling helpers, the port of ``spec_viterbi_tpu/utils/profiling.py``.

- :func:`trace`: a ``torch.profiler`` region (the host's activity, and the
  card's kernels when a CUDA device is present) written as a Chrome trace
  under a directory, in place of the JAX package's ``jax.profiler`` trace;
- :class:`StepTimer`: wall-clock step accounting with median and
  percentile summaries, copied as it is;
- :func:`span`: a named host range around one stage of a call, which a
  ``torch.profiler`` trace records on its own clock, beside the card's
  kernels and copies. ``FusedStructuredDecoder`` and the scheduler open
  ``svt.plan``, ``svt.build``, ``svt.stage``, ``svt.launch`` and
  ``svt.fetch``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

# A plain host op (``cpu_op``), not ``record_function``: the profiler mirrors
# that range onto the device's timeline, where a trace reader takes it for
# device work.
_RECORD = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager that records ``name`` as a host range while a
    ``torch.profiler`` runs, and nothing otherwise. ``name`` is a fixed
    string: a trace groups its ranges by name."""
    return _RECORD(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: ``with trace("traces"): decode(...)`` writes
    ``log_dir/trace_<pid>_<ns>.json`` (open it in Perfetto or
    ``chrome://tracing``). Yields the ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock accumulator: ``with timer.step(): ...`` per iteration."""

    def __init__(self):
        self.times_ms: list[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times_ms.append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> dict:
        if not self.times_ms:
            return {"count": 0}
        a = np.asarray(self.times_ms)
        return {
            "count": int(a.size),
            "median_ms": float(np.median(a)),
            "mean_ms": float(a.mean()),
            "p90_ms": float(np.percentile(a, 90)),
            "min_ms": float(a.min()),
            "max_ms": float(a.max()),
        }
