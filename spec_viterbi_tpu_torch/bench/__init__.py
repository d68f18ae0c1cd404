"""Benchmark harness: median-of-N timing, `.dat` TSV outputs, dataset
sweeps (the reference's ``benchmark/`` layer), and the headline line
(``python -m spec_viterbi_tpu_torch.bench``)."""

from spec_viterbi_tpu_torch.bench.harness import (
    TIMES_TO_RUN,
    get_func_run_time_ms,
    get_median,
    get_sorted_run_times,
    print_benchmarks_to_file_as_dat,
    sum_dat_columns,
)

__all__ = [
    "TIMES_TO_RUN",
    "get_func_run_time_ms",
    "get_median",
    "get_sorted_run_times",
    "print_benchmarks_to_file_as_dat",
    "sum_dat_columns",
]
