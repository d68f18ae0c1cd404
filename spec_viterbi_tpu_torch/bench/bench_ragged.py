"""Ragged-serving benchmark: bucketed vs whole-batch decode of a
length-skewed workload.

The port of ``spec_viterbi_tpu/bench/bench_ragged.py``, with the same
``HEADERS``. No reference analog: the reference decodes sequences
serially (``bench_Viterbi.h:53-56``), so raggedness costs it nothing. A
batched decoder pays the global max length for every lane unless it
buckets; this benchmark measures that on the length profile of a
``.ess`` file, replicated ``copies`` times, with fresh seeded symbols.

Columns (`.dat` TSV, one row per model):

- ``whole_e2e`` / ``bucket_e2e``: ``decode_batch`` wall ms including
  host↔device transfers;
- ``whole_compute`` / ``bucket_compute``: pre-staged decode ms (batches
  staged on the device, every call enqueued, one synchronize);
- ``path_whole_e2e`` / ``path_bucket_e2e``: ``decode_path_batch`` wall ms
  (scores, int16 backpointers, the backtrace), NaN where the whole-batch
  pointer tensor exceeds the memory budget or the card's memory. On a
  CUDA device each path column's peak allocated memory is printed on its
  own line (``path_peak``), beside the budget.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from spec_viterbi_tpu_torch.bench.harness import block_output, get_median, print_benchmarks_to_file_as_dat
from spec_viterbi_tpu_torch.io import read_emit_seq, read_hmm
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder, fused_eligible
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.utils.batching import bucket_plan

HEADERS = (
    "States",
    "whole_e2e",
    "bucket_e2e",
    "whole_compute",
    "bucket_compute",
    "path_whole_e2e",
    "path_bucket_e2e",
)


def _workload(lens, emit_num, seed):
    r = np.random.default_rng(seed)
    return [r.integers(0, emit_num, size=t).astype(np.int32) for t in lens]


def _staged(fd: FusedStructuredDecoder, seqs, bucketed: bool) -> list:
    if not bucketed:
        return [fd.prepare(seqs)]
    plan = bucket_plan([len(s) for s in seqs]) or [(list(range(len(seqs))), None)]
    return [fd.prepare([seqs[i] for i in idx], t_pad=t) for idx, t in plan]


def _run_staged(fd: FusedStructuredDecoder, handles) -> None:
    last = None
    for st, ln, m in handles:
        last = fd._run(st, ln, masked=m)
    block_output(last)


def benchmark_ragged(
    chmm_path: str,
    ess_path: str,
    copies: int = 32,
    times_to_run: int = 3,
    device: torch.device | str = "cuda",
):
    """Returns ``(states_num, [whole_e2e, bucket_e2e, whole_comp,
    bucket_comp, path_whole_e2e, path_bucket_e2e])`` medians in ms
    (``HEADERS`` order)."""
    device = torch.device(device)
    hmm = read_hmm(chmm_path)
    sop = StructuredOperator.from_hmm(hmm)
    if not fused_eligible(sop):
        raise ValueError("ragged bench needs a fused-eligible model")
    fd = FusedStructuredDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device=device
    )
    lens = [len(s) for s in read_emit_seq(ess_path)] * copies

    # the variants' repetitions interleave (whole, bucket, whole, ...), so
    # a drift in the host's speed biases neither; every repetition decodes
    # its own seeded symbols
    e2e_times: dict[bool, list[float]] = {False: [], True: []}
    for bucketed in (False, True):
        voff = 5000 if bucketed else 0
        fd.decode_batch(_workload(lens, hmm.emit_num, 999 + voff), bucketed=bucketed)
    for rep in range(times_to_run):
        for bucketed in (False, True):
            voff = 5000 if bucketed else 0
            seqs = _workload(lens, hmm.emit_num, rep + voff)
            t0 = time.perf_counter()
            fd.decode_batch(seqs, bucketed=bucketed)
            e2e_times[bucketed].append((time.perf_counter() - t0) * 1e3)
    results = [get_median(sorted(e2e_times[False])), get_median(sorted(e2e_times[True]))]

    # pre-staged compute: every repetition's batches staged first
    staged: dict[bool, list] = {}
    for bucketed in (False, True):
        voff = 5000 if bucketed else 0
        staged[bucketed] = [
            _staged(fd, _workload(lens, hmm.emit_num, 100 + rep + voff), bucketed)
            for rep in range(times_to_run)
        ]
        _run_staged(fd, _staged(fd, _workload(lens, hmm.emit_num, 777 + voff), bucketed))
    comp_times: dict[bool, list[float]] = {False: [], True: []}
    for rep in range(times_to_run):
        for bucketed in (False, True):
            t0 = time.perf_counter()
            _run_staged(fd, staged[bucketed][rep])
            comp_times[bucketed].append((time.perf_counter() - t0) * 1e3)
    results += [get_median(sorted(comp_times[False])), get_median(sorted(comp_times[True]))]
    del staged

    # exact paths: the whole batch pays the global max length per lane and
    # per pointer byte, and may exceed the budget (refused before any
    # launch) or the card; either makes the column NaN. Any other failure
    # is a fault of decode_path_batch and propagates.
    path_times: dict[bool, list[float] | None] = {False: [], True: []}
    for bucketed in (False, True):
        voff = 7000 if bucketed else 2000
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        try:
            fd.decode_path_batch(_workload(lens, hmm.emit_num, 998 + voff), bucketed=bucketed)
        except torch.cuda.OutOfMemoryError:
            path_times[bucketed] = None
        except ValueError as exc:
            if "budget" not in str(exc):
                raise
            path_times[bucketed] = None
        if device.type == "cuda":
            print(json.dumps({
                "path_peak": "path_bucket_e2e" if bucketed else "path_whole_e2e",
                "states": hmm.states_num, "lanes": len(lens),
                "ran": path_times[bucketed] is not None,
                "max_memory_allocated": torch.cuda.max_memory_allocated(device),
                "budget_bytes": fd.MAX_PATH_BYTES,
                "total_memory": torch.cuda.get_device_properties(device).total_memory,
            }), flush=True)
    for rep in range(times_to_run):
        for bucketed in (False, True):
            if path_times[bucketed] is None:
                continue
            voff = 7000 if bucketed else 2000
            seqs = _workload(lens, hmm.emit_num, rep + voff)
            t0 = time.perf_counter()
            fd.decode_path_batch(seqs, bucketed=bucketed)
            path_times[bucketed].append((time.perf_counter() - t0) * 1e3)
    results += [
        get_median(sorted(path_times[b])) if path_times[b] else float("nan")
        for b in (False, True)
    ]
    return hmm.states_num, results


def benchmark_ragged_to_dat_file(
    chmm_paths: list[str],
    ess_path: str,
    out_file: str,
    copies: int = 32,
    times_to_run: int = 3,
    device: torch.device | str = "cuda",
) -> dict[int, list[float]]:
    bench: dict[int, list[float]] = {}
    for path in chmm_paths:
        states, row = benchmark_ragged(
            path, ess_path, copies=copies, times_to_run=times_to_run, device=device
        )
        bench[states] = row
        print(f"{path}: {['%.1f' % t for t in row]}", flush=True)
        # per-model flush: an interrupted sweep keeps its completed rows
        print_benchmarks_to_file_as_dat(out_file, HEADERS, bench)
    print_benchmarks_to_file_as_dat(out_file, HEADERS, bench)
    return bench
