"""Timing/reporting helpers — parity with ``benchmark/benchmark_helper.h``.

A copy of ``spec_viterbi_tpu/bench/harness.py``, but for ``block_output``.
Same measurement semantics as the reference: ``TIMES_TO_RUN = 10`` wall-clock
runs (``benchmark_helper.h:14``), sorted (``:45-66``), median, and a `.dat`
TSV writer emitting a header row then ``states<TAB>time…`` rows from a map
keyed by state count (``:68-89``). Times are milliseconds.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

TIMES_TO_RUN = 10


def get_func_run_time_ms(func: Callable[[], None]) -> float:
    """Wall-clock one call, in ms (steady_clock analog, benchmark_helper.h:37-43)."""
    t0 = time.perf_counter()
    func()
    return (time.perf_counter() - t0) * 1e3


def get_sorted_run_times(
    func: Callable[[], None], times_to_run: int = TIMES_TO_RUN
) -> list[float]:
    """Run ``func`` N times; sorted ms times (benchmark_helper.h:45-66)."""
    return sorted(get_func_run_time_ms(func) for _ in range(times_to_run))


def get_median(sorted_times: list[float]) -> float:
    """Median of pre-sorted run times (benchmark_helper.h:58-66)."""
    n = len(sorted_times)
    if n == 0:
        raise ValueError("no run times")
    mid = n // 2
    if n % 2:
        return sorted_times[mid]
    return 0.5 * (sorted_times[mid - 1] + sorted_times[mid])


def print_benchmarks_to_file_as_dat(
    file_name: str,
    headers: Iterable[str],
    benchmarks: Mapping[int, list[float]],
) -> None:
    """TSV `.dat` writer (benchmark_helper.h:68-89): header row, then one
    ``states<TAB>t0<TAB>t1…`` row per model, ascending by state count."""
    with open(file_name, "w") as f:
        f.write("\t".join(headers) + "\n")
        for states in sorted(benchmarks):
            row = [str(states)] + [_fmt(t) for t in benchmarks[states]]
            f.write("\t".join(row) + "\n")


def _fmt(t: float) -> str:
    return repr(round(float(t), 6))


def sum_dat_columns(path: str) -> dict[str, float]:
    """Column sums of a `.dat` file (benchmark/sum_dat.py:1-14 parity).

    NaN cells (the spec benchmark's over-memory-budget markers,
    ``bench_viterbi.py``) are skipped rather than poisoning the column sum;
    a column whose every cell is NaN sums to NaN so the gap stays visible.
    """
    with open(path) as f:
        headers = f.readline().split("\t")
        headers = [h.strip() for h in headers]
        sums = np.zeros(len(headers))
        seen = np.zeros(len(headers), dtype=bool)
        for line in f:
            vals = np.array([float(x) for x in line.split("\t")])
            finite = ~np.isnan(vals)
            sums[: len(vals)] += np.where(finite, vals, 0.0)
            seen[: len(vals)] |= finite
    sums = np.where(seen, sums, np.nan)
    return dict(zip(headers, sums.tolist()))


def block_output(out) -> None:
    """Wait for the device computation that produced ``out`` (a tensor)
    to finish: a synchronize of its CUDA device; nothing on the CPU."""
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
