"""Dataset-level benchmark sweeps — parity with ``benchmark/bench_Viterbi.h``
and ``benchmark/bench_Viterbi_spec.h``.

The port of ``spec_viterbi_tpu/bench/bench_viterbi.py``, with its headers,
row layout, memory policy and per-model flush. Shape preserved from the
reference:

- iterate every ``*.chmm`` in a models directory (``bench_Viterbi.h:37-48``),
- timed unit = decode **all** sequences of the dataset once
  (``bench_Viterbi.h:51-57``), here as batched device work with the
  sequences staged on the device up front, so the timed region is decode
  compute ending in one synchronize,
- median of N runs into a map keyed by state count (``:58-60``),
- spec benchmarks time ``spec_with`` (prep) and the decode separately,
  emitting paired ``<impl>_<L>_prep`` / ``<impl>_<L>`` columns
  (``bench_Viterbi_spec.h:33-47,67-84``).

The reference's "backend" axis (GraphBLAS/CUSP/cuASR) maps to this
package's execution modes (dense / structured; on ``cuda`` the structured
mode rides the fused kernels). A failing cell raises; NaN marks only a
cell over the memory budget.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from spec_viterbi_tpu_torch.bench import harness
from spec_viterbi_tpu_torch.hmm import validate_obs_seq
from spec_viterbi_tpu_torch.io import read_emit_seq, read_hmm
from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder
from spec_viterbi_tpu_torch.models.spec_structured import StructuredSpecializedViterbi
from spec_viterbi_tpu_torch.models.specializer import SpecializedViterbi

DEFAULT_MODES = ("dense", "structured")

# The column configuration of the JAX package's committed `.dat` files,
# kept so the port's files carry the same columns.
ARTIFACT_MODES = DEFAULT_MODES
ARTIFACT_LEVELS = (1, 2)
ARTIFACT_STRUCT_LEVELS = (1, 2, 3)


def nonspec_headers(modes: tuple[str, ...] = DEFAULT_MODES) -> list[str]:
    """Column contract of a non-spec ``.dat`` (``bench_Viterbi.h:31``)."""
    return ["States", *modes]


def spec_headers(
    levels: tuple[int, ...] = ARTIFACT_LEVELS,
    struct_levels: tuple[int, ...] = ARTIFACT_STRUCT_LEVELS,
) -> list[str]:
    """Column contract of a spec ``.dat``: paired prep/decode columns per
    impl × level (``bench_Viterbi_spec.h:29-47``)."""
    headers = ["States"]
    for name, impl_levels in (("spec", levels), ("spec_struct", struct_levels)):
        for level in impl_levels:
            headers += [f"{name}_{level}_prep", f"{name}_{level}"]
    return headers


def _iter_models(chmm_dir: str, max_states: int | None = None):
    for path in sorted(glob.glob(os.path.join(chmm_dir, "*.chmm"))):
        hmm = read_hmm(path)
        if max_states is not None and hmm.states_num > max_states:
            continue
        yield path, hmm


def _skip_reason(path: str, hmm, max_sym: int, bench: dict) -> str | None:
    if hmm.emit_num <= max_sym:
        # mismatched model/dataset alphabets raise at decode; the sweep
        # over all models skips such pairs explicitly instead
        return (f"skipping {os.path.basename(path)}: alphabet {hmm.emit_num} "
                f"does not cover dataset symbols (max {max_sym})")
    if hmm.states_num in bench:
        # .dat rows are keyed by state count (benchmark_helper.h:68-89); a
        # second same-size model would corrupt the table
        return (f"skipping {os.path.basename(path)}: a model with "
                f"{hmm.states_num} states was already benchmarked")
    return None


def benchmark_viterbi_impls_to_dat_file(
    chmm_dir: str,
    ess_path: str,
    out_path: str,
    modes: tuple[str, ...] = DEFAULT_MODES,
    times_to_run: int = harness.TIMES_TO_RUN,
    max_states: int | None = None,
    verbose: bool = True,
    device: torch.device | str = "cuda",
) -> dict[int, list[float]]:
    """Non-spec benchmark: one column per execution mode in ``modes``
    (``bench_Viterbi.h:17-69``); ``ViterbiDecoder`` ``prepare_batch`` once,
    ``run_batch`` timed. Models of more than ``max_states`` states are
    left out; ``verbose`` prints each model and its row."""
    seqs = read_emit_seq(ess_path)
    max_sym = max((int(s.max()) for s in seqs if len(s)), default=-1)
    headers = nonspec_headers(modes)
    bench: dict[int, list[float]] = {}
    for path, hmm in _iter_models(chmm_dir, max_states):
        reason = _skip_reason(path, hmm, max_sym, bench)
        if reason:
            print(f"[bench] {reason}")
            continue
        if verbose:
            print(f"[bench] {os.path.basename(path)} ({hmm.states_num} states)")
        row: list[float] = []
        for mode in modes:
            dec = ViterbiDecoder(hmm, mode=mode, device=device)
            handle = dec.prepare_batch(seqs)

            def run():
                harness.block_output(dec.run_batch(handle))

            run()  # warm-up outside the timed runs
            row.append(harness.get_median(harness.get_sorted_run_times(run, times_to_run)))
        bench[hmm.states_num] = row
        if verbose:
            print(f"[bench]   -> {row}")
        # per-model flush: an interrupted sweep keeps its completed rows
        harness.print_benchmarks_to_file_as_dat(out_path, headers, bench)
    harness.print_benchmarks_to_file_as_dat(out_path, headers, bench)
    return bench


def _spec_decode_runner(spec, seqs):
    """Pre-staged decode-all-sequences runner for a specialized decoder.

    The timed unit mirrors the reference (decode every sequence of the
    dataset once, ``bench_Viterbi_spec.h:74-84``), but the sequences are
    staged on the device up front and the batched work is enqueued back to
    back, ending in one synchronize. By form:

    - the structured specializer: factored, one fused decode of the batch
      (``prepare`` / ``run_prepared``); composed, one batched decode per
      exact-length bucket (its radix has no identity symbol to pad with);
    - the dense specializer: at level 1 on a structured model, its
      delegate's ``prepare_batch`` / ``run_batch``; otherwise the batched,
      gathered decode, one ``svt_minplus`` launch a chunk for the whole
      group, with the sequences grouped and identity-padded as
      ``run_spec_batch`` groups them. Decoding one sequence at a time
      (``run_spec``) would instead take one launch a chunk a sequence,
      50 × 1,749 at level 2 on 50 sequences of 3,500 symbols.

    Dispatch is on the class: both specializers have a
    ``_decode_batch_uniform``, with different inputs.
    """
    if isinstance(spec, StructuredSpecializedViterbi):
        if spec._fused is not None:
            handle = spec._fused.prepare(seqs)
            return lambda: harness.block_output(spec._fused.run_prepared(handle))
        by_len: dict[int, list] = {}
        for s in seqs:
            by_len.setdefault(len(s), []).append(validate_obs_seq(s, spec.emit_num))
        batches = [
            torch.as_tensor(np.stack(group, axis=1), device=spec.device)
            for _, group in sorted(by_len.items())
        ]

        def run():
            outs = [spec._decode_batch_uniform(b) for b in batches]
            harness.block_output(outs[-1])

        return run
    if not isinstance(spec, SpecializedViterbi):
        raise TypeError(f"not a specializer: {type(spec).__name__}")
    if spec._delegate is not None:
        handle = spec._delegate.prepare_batch(seqs)
        return lambda: harness.block_output(spec._delegate.run_batch(handle))
    valid = [validate_obs_seq(s, spec.emit_num) for s in seqs]
    staged = [spec._stage_uniform(batch) for _, batch in spec._padded_groups(valid)]

    def run():
        outs = [spec._decode_staged(st) for st in staged]
        harness.block_output(outs[-1])

    return run


def benchmark_viterbi_spec_impls_to_dat_file(
    chmm_dir: str,
    ess_path: str,
    out_path: str,
    levels: tuple[int, ...] = (1, 2),
    times_to_run: int = harness.TIMES_TO_RUN,
    max_states: int | None = None,
    max_spec_bytes: int = 8 << 30,
    prep_times_to_run: int | None = None,
    verbose: bool = True,
    struct_levels: tuple[int, ...] | None = None,
    device: torch.device | str = "cuda",
) -> dict[int, list[float]]:
    """Spec benchmark with paired prep/decode columns
    (``bench_Viterbi_spec.h:16-93``).

    ``max_spec_bytes`` enforces the reference's memory policy deliberately
    (its GPU backends stop at level 1 for the 20-symbol corpus,
    ``bench_Viterbi_spec.h:37-47``): a level whose operators need more
    (``spec_memory_bytes``) gets NaN columns for that model.

    ``struct_levels`` extends the structured specializer past the dense
    levels (defaults to ``levels``): its store grows O(E^L·N) instead of
    O(E^L·N²), so it reaches level 3 where the dense one cannot.
    ``max_states`` and ``verbose`` as in
    :func:`benchmark_viterbi_impls_to_dat_file`.
    """
    seqs = read_emit_seq(ess_path)
    impls = (
        ("spec", SpecializedViterbi, levels),
        ("spec_struct", StructuredSpecializedViterbi, struct_levels or levels),
    )
    headers = spec_headers(levels, struct_levels or levels)

    max_sym = max((int(s.max()) for s in seqs if len(s)), default=-1)
    bench: dict[int, list[float]] = {}
    for path, hmm in _iter_models(chmm_dir, max_states):
        reason = _skip_reason(path, hmm, max_sym, bench)
        if reason:
            print(f"[bench-spec] {reason}")
            continue
        if verbose:
            print(f"[bench-spec] {os.path.basename(path)} ({hmm.states_num} states)")
        row: list[float] = []
        for name, cls, impl_levels in impls:
            for level in impl_levels:
                need = cls.spec_memory_bytes(hmm.states_num, hmm.emit_num, level)
                if need > max_spec_bytes:
                    row += [float("nan"), float("nan")]
                    continue
                spec = cls(level=level, device=device)

                def prep():
                    spec.spec_with(hmm)
                    # the dense build runs asynchronously on the device:
                    # without a wait the column would time the enqueue
                    if getattr(spec, "tuple_ops", None) is not None:
                        harness.block_output(spec.tuple_ops)

                prep()  # warm-up
                prep_t = harness.get_median(
                    harness.get_sorted_run_times(prep, prep_times_to_run or times_to_run)
                )
                run = _spec_decode_runner(spec, seqs)
                run()  # warm-up
                run_t = harness.get_median(harness.get_sorted_run_times(run, times_to_run))
                row += [prep_t, run_t]
                del spec, run
        bench[hmm.states_num] = row
        if verbose:
            print(f"[bench-spec]   -> {row}")
        # per-model flush: an interrupted sweep keeps its completed rows
        harness.print_benchmarks_to_file_as_dat(out_path, headers, bench)
    harness.print_benchmarks_to_file_as_dat(out_path, headers, bench)
    return bench
