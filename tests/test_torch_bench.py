"""The port's benchmark layer against the JAX package's, on the CPU.

The harness (median, `.dat` writer, column sums) must give the JAX
harness's results and bytes; the sweeps and the ragged bench keep the
JAX modules' headers and the memory policy (NaN only over budget); the
headline prints ``bench.py``'s keys plus ``device`` and ``model``. Timings
on the CPU here are of no interest and are not checked; device times come
only from a run on the card.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spec_viterbi_tpu.bench import bench_ragged as ref_ragged
from spec_viterbi_tpu.bench import bench_viterbi as ref_bv
from spec_viterbi_tpu.bench import harness as ref_harness

import spec_viterbi_tpu_torch as port
from spec_viterbi_tpu_torch.bench import bench_ragged, bench_viterbi, harness, headline
from spec_viterbi_tpu_torch.io import generate_profile_hmm, generate_random_hmm, write_chmm, write_ess

torch.set_num_threads(1)

BENCH_PY_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_mode", "us_per_step",
                 "floor_us_per_step", "floor_utilization"}
NAN = float("nan")
MAPS = {
    "plain": {200: [2.0, 3.0], 100: [1.0, 5.0]},
    "nan_rows": {100: [1.0, NAN, NAN], 200: [2.0, 5.0, NAN], 50: [NAN, NAN, NAN]},
    "fractions": {7: [1 / 3, 2.0000004, 1e-7], 2407: [123456.7891234, 0.0, 9.5]},
}


@pytest.mark.parametrize("times", [[1.0, 2.0, 9.0], [1.0, 2.0, 3.0, 9.0], [4.5], [0.25, 0.5]])
def test_median_matches_jax(times):
    assert harness.get_median(times) == ref_harness.get_median(times)
    with pytest.raises(ValueError):
        harness.get_median([])
    assert harness.TIMES_TO_RUN == ref_harness.TIMES_TO_RUN


@pytest.mark.parametrize("name", sorted(MAPS))
def test_dat_writer_byte_equal_and_sums_match_jax(tmp_path, name):
    bench = MAPS[name]
    headers = ["States"] + [f"c{i}" for i in range(len(next(iter(bench.values()))))]
    ours, theirs = tmp_path / "port.dat", tmp_path / "jax.dat"
    harness.print_benchmarks_to_file_as_dat(str(ours), headers, bench)
    ref_harness.print_benchmarks_to_file_as_dat(str(theirs), headers, bench)
    assert ours.read_bytes() == theirs.read_bytes()
    got, want = harness.sum_dat_columns(str(ours)), ref_harness.sum_dat_columns(str(theirs))
    assert list(got) == list(want) == headers
    for k in headers:
        assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k]))


def test_run_times_and_block_output():
    calls = []
    times = harness.get_sorted_run_times(lambda: calls.append(1), times_to_run=3)
    assert len(calls) == 3 and times == sorted(times) and all(t >= 0 for t in times)
    harness.block_output(torch.zeros(2, 2))  # a CPU tensor: nothing to wait for


def test_headers_and_constants_match_jax():
    assert bench_viterbi.nonspec_headers() == ref_bv.nonspec_headers()
    assert bench_viterbi.spec_headers() == ref_bv.spec_headers()
    assert bench_viterbi.spec_headers((1,), (1, 2, 3)) == ref_bv.spec_headers((1,), (1, 2, 3))
    assert (bench_viterbi.ARTIFACT_MODES, bench_viterbi.ARTIFACT_LEVELS,
            bench_viterbi.ARTIFACT_STRUCT_LEVELS) == (
        ref_bv.ARTIFACT_MODES, ref_bv.ARTIFACT_LEVELS, ref_bv.ARTIFACT_STRUCT_LEVELS)
    assert bench_viterbi.DEFAULT_MODES == ref_bv.DEFAULT_MODES
    assert bench_ragged.HEADERS == ref_ragged.HEADERS


def _dataset(tmp_path, seed=0):
    """Two tiny FS-class profile models, a 3-symbol model the workload's
    alphabet does not fit (skipped), and a ragged workload."""
    d = tmp_path / "models"
    d.mkdir()
    write_chmm(generate_profile_hmm(20, seed=seed), str(d / "a.chmm"))
    write_chmm(generate_profile_hmm(44, seed=seed + 1), str(d / "b.chmm"))
    write_chmm(generate_random_hmm(12, trans_per_state=3, emit_range=3, seed=seed), str(d / "c.chmm"))
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 20, size=t).astype(np.int32) for t in (3, 17, 40, 33, 9, 1)]
    seqs[0][0] = 19  # the largest symbol, past model c's alphabet
    write_ess(seqs, str(tmp_path / "work.ess"))
    return str(d), str(tmp_path / "work.ess")


def _read_dat(path):
    lines = open(path).read().splitlines()
    rows = {int(r.split("\t")[0]): [float(x) for x in r.split("\t")[1:]] for r in lines[1:]}
    return lines[0].split("\t"), rows


def test_nonspec_sweep(tmp_path, capsys):
    models, ess = _dataset(tmp_path)
    out = str(tmp_path / "nonspec.dat")
    bench = bench_viterbi.benchmark_viterbi_impls_to_dat_file(models, ess, out, times_to_run=1,
                                                              device="cpu")
    assert "skipping c.chmm" in capsys.readouterr().out
    headers, rows = _read_dat(out)
    assert headers == ref_bv.nonspec_headers()
    assert sorted(rows) == sorted(bench) == [22, 46]
    assert all(len(r) == 2 and all(math.isfinite(t) and t > 0 for t in r) for r in rows.values())


def test_spec_sweep_memory_policy(tmp_path):
    """Every cell is finite except those the memory policy marks: a level
    whose ``spec_memory_bytes`` exceeds ``max_spec_bytes`` gets NaN."""
    models, ess = _dataset(tmp_path)
    out = str(tmp_path / "spec.dat")
    levels, struct_levels, budget = (1, 2), (1, 2, 3), 40 << 20
    bench = bench_viterbi.benchmark_viterbi_spec_impls_to_dat_file(
        models, ess, out, levels=levels, struct_levels=struct_levels, times_to_run=1,
        max_spec_bytes=budget, device="cpu")
    headers, rows = _read_dat(out)
    assert headers == ref_bv.spec_headers(levels, struct_levels)
    assert sorted(rows) == sorted(bench) == [22, 46]
    cls = {"spec": port.SpecializedViterbi, "spec_struct": port.StructuredSpecializedViterbi}
    nan_cells = 0
    for states, row in rows.items():
        for col, t in zip(headers[1:], row):
            name, level = col.removesuffix("_prep").rsplit("_", 1)
            over = cls[name].spec_memory_bytes(states, 20, int(level)) > budget
            assert math.isnan(t) == over, (states, col, t)
            nan_cells += over
    assert 0 < nan_cells < len(headers[1:]) * len(rows)  # both sides of the policy


def test_spec_runner_dispatches_on_class(tmp_path):
    """Each form's runner decodes what ``run_spec_batch`` decodes: the
    dense specializer's staged groups and the composed form's exact-length
    buckets give the scores ``run_spec_batch`` gives."""
    hmm = generate_random_hmm(30, trans_per_state=6, emit_range=4, seed=2)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, size=t).astype(np.int32) for t in (5, 9, 9, 30)]
    dense = port.SpecializedViterbi(level=2, device="cpu")
    dense.spec_with(hmm)
    groups = dense._padded_groups(seqs)
    got = [dense._decode_staged(dense._stage_uniform(b)) for _, b in groups]
    want = dense.run_spec_batch(seqs)
    for (idxs, _), v in zip(groups, got):
        for j, i in enumerate(idxs):
            np.testing.assert_array_equal(v[j, : hmm.states_num].numpy(), want[i])
    struct = port.StructuredSpecializedViterbi(level=2, device="cpu")
    struct.spec_with(hmm)
    for spec in (dense, struct):
        bench_viterbi._spec_decode_runner(spec, seqs)()
    with pytest.raises(TypeError, match="not a specializer"):
        bench_viterbi._spec_decode_runner(port.ViterbiDecoder(hmm, device="cpu"), seqs)


def test_benchmark_ragged_cpu(tmp_path):
    models, ess = _dataset(tmp_path)
    path = os.path.join(models, "b.chmm")
    states, row = bench_ragged.benchmark_ragged(path, ess, copies=30, times_to_run=1, device="cpu")
    assert states == 46 and len(row) == len(bench_ragged.HEADERS) - 1
    assert all(math.isfinite(t) and t > 0 for t in row)
    out = str(tmp_path / "ragged.dat")
    bench = bench_ragged.benchmark_ragged_to_dat_file([path], ess, out, copies=2, times_to_run=1,
                                                      device="cpu")
    headers, rows = _read_dat(out)
    assert tuple(headers) == ref_ragged.HEADERS and sorted(rows) == sorted(bench) == [46]
    with pytest.raises(ValueError, match="fused-eligible"):
        bench_ragged.benchmark_ragged(os.path.join(models, "c.chmm"), ess, device="cpu")


def test_headline_keys_on_cpu():
    hmm, seqs, model, work = headline.load_inputs(None, None, seed=4)
    assert hmm.states_num == 2407 and len(seqs) == headline.WORK_SEQS
    assert model == "generate_profile_hmm(2405, seed=4)" and "seed 4" in work
    small = generate_profile_hmm(30, seed=4)
    rng = np.random.default_rng(4)
    work_seqs = [rng.integers(0, 20, size=24).astype(np.int32) for _ in range(3)]
    line = headline.run(small, work_seqs, device="cpu", model="tiny", lanes=8, n_batches=2,
                        t_len=24, runs=1)
    assert set(line) == BENCH_PY_KEYS | {"device", "model"}
    assert line["metric"] == "decoded_obs_symbols_per_s_per_chip_2405"
    assert line["unit"] == "symbols/s" and line["device"] == "cpu" and line["model"] == "tiny"
    assert line["value"] > 0 and line["vs_baseline"] >= 1.0 and line["us_per_step"] > 0
    # the floor is measured only on a card
    assert line["floor_us_per_step"] is None and line["floor_utilization"] is None
    json.dumps(line)


def test_headline_refuses_a_wrong_decode(monkeypatch):
    small = generate_profile_hmm(30, seed=5)
    seqs = [np.arange(12, dtype=np.int32) % 20 for _ in range(2)]
    real = port.ViterbiDecoder.decode_batch
    monkeypatch.setattr(port.ViterbiDecoder, "decode_batch",
                        lambda self, s, **kw: [v + 1.0 for v in real(self, s, **kw)])
    with pytest.raises(RuntimeError, match="differ"):
        headline.run(small, seqs, device="cpu", model="tiny", lanes=4, n_batches=1, t_len=12,
                     runs=1)


def test_headline_refuses_a_wrong_timed_batch(monkeypatch):
    """The gate also runs the timed ``run_batch`` shape: a fault that only
    a ``lanes``-wide structured batch shows is refused."""
    small = generate_profile_hmm(30, seed=5)
    seqs = [np.arange(12, dtype=np.int32) % 20 for _ in range(2)]
    real = port.ViterbiDecoder.run_batch

    def faulty(self, handle):
        out = real(self, handle)
        # the workload's own batch pads to 8 lanes; only the 16-lane one is wrong
        return out + 1.0 if self.mode == "structured" and out.shape[0] >= 16 else out

    monkeypatch.setattr(port.ViterbiDecoder, "run_batch", faulty)
    with pytest.raises(RuntimeError, match="timed structured batch"):
        headline.run(small, seqs, device="cpu", model="tiny", lanes=16, n_batches=1, t_len=12,
                     runs=1)


def test_headline_inputs_from_files(tmp_path):
    models, ess = _dataset(tmp_path)
    path = os.path.join(models, "a.chmm")
    hmm, seqs, model, work = headline.load_inputs(path, ess, seed=0)
    assert hmm.states_num == 22 and model == path and work == ess and len(seqs) == 6
    packed = headline.packed_work(seqs, lanes=5, n_batches=2, t_len=16)
    assert len(packed) == 2 and all(len(b) == 5 for b in packed)
    assert all(len(s) == min(16, len(seqs[i % 6])) for b in packed for i, s in enumerate(b))


def test_bench_main_needs_a_card_and_loads_no_jax():
    """Without CUDA the entry point exits 1 and prints no result; the bench
    and the structured specializer import no jax."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would measure")
    code = (
        "import sys, spec_viterbi_tpu_torch.bench, spec_viterbi_tpu_torch.bench.headline, "
        "spec_viterbi_tpu_torch.bench.bench_viterbi, spec_viterbi_tpu_torch.bench.bench_ragged, "
        "spec_viterbi_tpu_torch.bench.__main__, spec_viterbi_tpu_torch.models.spec_structured, "
        "spec_viterbi_tpu_torch.ops.structured_compose\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'spec_viterbi_tpu'))\n"
        "assert not bad, bad\n"
        "from spec_viterbi_tpu_torch.bench.__main__ import main\n"
        "sys.exit(main([]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout == "" and "no CUDA device" in proc.stderr
