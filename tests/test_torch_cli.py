"""The port's CLI against the JAX package's, on the CPU.

Each subcommand runs through the port's ``main([..., "--device", "cpu"])``
and the JAX ``cli.main([...])`` on seeded ``.chmm``/``.ess`` files written
here. Where the JAX route runs XLA (the scheduler's batch route, ``--mode``,
``--spec-level``, ``--time-parallel``) stdout is equal line for line;
where it runs Pallas in interpret mode (``--stream-chunk``) the ``min=``
and ``best=`` values agree within ±1.0 and the paths are equal. ``info``
and ``sum-dat`` print the same bytes; ``gen-chmm``, ``gen-ess``,
``fasta-to-ess`` and ``hmmer-to-chmm`` write the same bytes. The JAX
readers take their Python tokenizer here (their native library is not
built), the port's its native parser.
"""

import json
import re

import numpy as np
import pytest
import torch

from test_torch_io_tools import write_fasta, write_hmmer_profile

from spec_viterbi_tpu import cli as ref_cli
from spec_viterbi_tpu.bench import bench_ragged as ref_ragged
from spec_viterbi_tpu.bench import bench_viterbi as ref_bv
from spec_viterbi_tpu.bench import harness as ref_harness
from spec_viterbi_tpu.native import loader as ref_loader

from spec_viterbi_tpu_torch import almost_equal, cli
from spec_viterbi_tpu_torch.bench import harness
from spec_viterbi_tpu_torch.io import generate_profile_hmm, write_chmm, write_ess

torch.set_num_threads(1)

SCORES = re.compile(r"^seq (\d+): \[(.*)\] min=(\S+)$")
PATH = re.compile(r"^seq (\d+): best=(\S+) path=(\[.*\])$")


@pytest.fixture(autouse=True)
def jax_python_readers(monkeypatch):
    """The JAX readers parse with their Python tokenizer."""
    monkeypatch.setattr(ref_loader, "_load", lambda: None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    hmm = generate_profile_hmm(100, seed=7)  # 102 states, FS class
    write_chmm(hmm, d / "model.chmm")
    rng = np.random.default_rng(8)
    seqs = [rng.integers(0, 20, size=int(t)).astype(np.int32) for t in (40, 9, 40, 1, 23, 40, 2)]
    write_ess(seqs, d / "ragged.ess")
    write_ess([rng.integers(0, 20, size=600).astype(np.int32)], d / "one.ess")
    return d


def run(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


def both(argv, capsys, port_extra=("--device", "cpu")):
    want = run(ref_cli.main, argv, capsys)
    got = run(cli.main, [*argv, *port_extra], capsys)
    return got, want


# (arguments after the .chmm and .ess, which .ess, does the JAX side run XLA)
DECODES = {
    "auto": ([], "ragged", True),
    "auto_path": (["--path"], "ragged", True),
    "structured": (["--mode", "structured"], "ragged", True),
    "dense": (["--mode", "dense"], "ragged", True),
    "dense_path": (["--mode", "dense", "--path"], "ragged", True),
    "spec_level_2": (["--spec-level", "2"], "ragged", True),
    "time_parallel": (["--time-parallel", "4"], "one", True),
    "time_parallel_tree_path": (["--time-parallel", "4", "--compose", "tree", "--path"], "one", True),
    "stream": (["--stream-chunk", "7"], "ragged", False),
    "stream_path": (["--stream-chunk", "16", "--path"], "ragged", False),
}


@pytest.mark.parametrize("case", sorted(DECODES))
def test_decode_matches_jax(files, capsys, case):
    extra, which, xla = DECODES[case]
    got, want = both(["decode", str(files / "model.chmm"), str(files / f"{which}.ess"), *extra], capsys)
    got, want = got.splitlines(), want.splitlines()
    n = {"ragged": 7, "one": 1}[which]
    assert len(got) == len(want) == n
    if xla:
        assert got == want
        return
    for g, w in zip(got, want):
        if "--path" in extra:
            (gi, gb, gp), (wi, wb, wp) = PATH.match(g).groups(), PATH.match(w).groups()
            assert gi == wi and gp == wp and abs(float(gb) - float(wb)) <= 1.0
        else:
            (gi, gh, gm), (wi, wh, wm) = SCORES.match(g).groups(), SCORES.match(w).groups()
            assert gi == wi and abs(float(gm) - float(wm)) <= 1.0
            pairs = [(float(a), float(b)) for a, b in zip(gh.split(" "), wh.split(" ")) if a != "..."]
            assert len(pairs) == 8 and all(almost_equal(a, b) for a, b in pairs)


def test_decode_prints_the_scheduler_line(files, capsys):
    assert cli.main(["decode", str(files / "model.chmm"), str(files / "ragged.ess"),
                     "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert err.startswith("[scheduler] batch: single-device batched decode (7 seqs)")


def test_decode_refusals_match_jax(files, capsys):
    argv = ["decode", str(files / "model.chmm"), str(files / "ragged.ess"), "--stream-chunk", "4",
            "--mode", "dense"]
    assert ref_cli.main(argv) == 2
    want = capsys.readouterr().err
    assert cli.main([*argv, "--device", "cpu"]) == 2
    assert capsys.readouterr().err == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["decode", str(files / "model.chmm"), str(files / "ragged.ess")])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["decode", str(files / "model.chmm"), str(files / "ragged.ess"), "--device", "cuda"])


def test_info_and_sum_dat_byte_equal(files, capsys, tmp_path):
    got, want = both(["info", str(files / "model.chmm")], capsys, ())
    assert got == want and "fingerprint:" in got
    dat = tmp_path / "x.dat"
    ref_harness.print_benchmarks_to_file_as_dat(str(dat), ["States", "a", "b"],
                                                {102: [1.5, float("nan")], 50: [0.25, 3.0]})
    got, want = both(["sum-dat", str(dat)], capsys, ())
    assert got == want


def test_data_tooling_writes_the_same_bytes(tmp_path, capsys):
    fa = write_fasta(tmp_path / "in.fasta", seed=3)
    hm = write_hmmer_profile(tmp_path / "in.hmm", 12, seed=4)
    jobs = (
        (["gen-chmm", "{}.chmm", "--states", "37", "--trans-per-state", "4", "--emit-range", "6",
          "--start-probs", "3", "--seed", "9"]),
        (["gen-ess", "{}.ess", "--count", "5", "--length", "31", "--emit-range", "6", "--seed", "2"]),
        (["fasta-to-ess", str(fa), "{}.ess"]),
        (["hmmer-to-chmm", str(hm), "{}.chmm"]),
    )
    for job in jobs:
        outs = []
        for tag, main in (("jax", ref_cli.main), ("port", cli.main)):
            argv = [a.format(tmp_path / f"{job[0]}_{tag}") if "{}" in a else a for a in job]
            printed = run(main, argv, capsys)
            out = next(a for a in argv if a.startswith(str(tmp_path / job[0])))
            outs.append((printed.replace(f"_{tag}.", "."), open(out, "rb").read()))
        assert outs[0] == outs[1], job[0]


def test_parser_covers_the_jax_parser():
    def flags(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd")
        return {name: {o for a in p._actions for o in a.option_strings} | {a.dest for a in p._actions
                                                                           if not a.option_strings}
                for name, p in sub.choices.items()}

    ours, theirs = flags(cli.build_parser()), flags(ref_cli.build_parser())
    assert set(ours) == set(theirs) and len(ours) == 10  # the JAX parser's ten subcommands
    for name in theirs:
        assert theirs[name] <= ours[name], name
    computing = {"bench", "decode", "bench-ragged", "bench-scaling"}
    assert {name for name in ours if "--device" in ours[name]} == computing
    # the corpus paths are required arguments, with no default
    for name, dests in (("bench", ("--chmm-dir", "--ess-dir")), ("bench-ragged", ("--chmm", "--ess"))):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args([name])
        sub = next(a for a in cli.build_parser()._actions if a.dest == "cmd").choices[name]
        assert all(a.required and a.default is None for a in sub._actions if a.option_strings[:1]
                   and a.option_strings[0] in dests)


def _bench_dir(tmp_path):
    d = tmp_path / "models"
    d.mkdir()
    write_chmm(generate_profile_hmm(20, seed=1), d / "a.chmm")  # 22 states
    write_chmm(generate_profile_hmm(44, seed=2), d / "b.chmm")  # 46 states
    rng = np.random.default_rng(3)
    write_ess([rng.integers(0, 20, size=int(t)).astype(np.int32) for t in (3, 17, 40, 9)],
              tmp_path / "work.ess")
    return d


def test_bench_modes_and_max_states_reach_the_sweeps(tmp_path, capsys):
    """``--modes structured --max-states 30``: one column, the 22-state
    row alone, in both sweeps; the JAX sweep's column and row layout."""
    models = _bench_dir(tmp_path)
    out = tmp_path / "out"
    trace = tmp_path / "trace"
    argv = ["bench", "--chmm-dir", str(models), "--ess-dir", str(tmp_path), "--datasets", "work",
            "--out-dir", str(out), "--times", "1", "--modes", "structured", "--max-states", "30",
            "--levels", "1", "--struct-levels", "1", "--trace", str(trace), "--device", "cpu"]
    printed = run(cli.main, argv, capsys)
    assert "b.chmm" not in printed and "a.chmm (22 states)" in printed
    lines = (out / "Viterbi_bench_work.dat").read_text().splitlines()
    assert lines[0].split("\t") == ref_bv.nonspec_headers(("structured",)) == ["States", "structured"]
    assert [r.split("\t")[0] for r in lines[1:]] == ["22"] and float(lines[1].split("\t")[1]) > 0
    spec = (out / "Viterbi_spec_bench_work.dat").read_text().splitlines()
    assert spec[0].split("\t") == ref_bv.spec_headers((1,), (1,))
    assert [r.split("\t")[0] for r in spec[1:]] == ["22"]
    assert sorted(harness.sum_dat_columns(str(out / "Viterbi_bench_work.dat"))) == ["States", "structured"]
    assert len(list(trace.glob("trace_*.json"))) == 1


def test_bench_ragged_and_scaling(tmp_path, capsys):
    models = _bench_dir(tmp_path)
    out = tmp_path / "ragged.dat"
    run(cli.main, ["bench-ragged", "--chmm", str(models / "a.chmm"), str(models / "b.chmm"),
                   "--ess", str(tmp_path / "work.ess"), "--copies", "2", "--times", "1",
                   "--out", str(out), "--device", "cpu"], capsys)
    lines = out.read_text().splitlines()
    assert tuple(lines[0].split("\t")) == ref_ragged.HEADERS
    assert [r.split("\t")[0] for r in lines[1:]] == ["22", "46"]
    printed = run(cli.main, ["bench-scaling", str(models / "b.chmm"), str(tmp_path / "work.ess"),
                             "--times", "1", "--local-shards", "2", "--device", "cpu"], capsys)
    rows = [json.loads(x) for x in printed.splitlines()]
    assert [r["devices"] for r in rows] == [1, 2] and all(r["local"] for r in rows)
    assert rows[0]["efficiency_vs_1"] == 1.0 and all(r["throughput_sym_s"] > 0 for r in rows)
    want_keys = {"devices", "throughput_sym_s", "efficiency_vs_1"}
    assert all(want_keys <= set(r) for r in rows)
