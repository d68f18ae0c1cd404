"""The port's host remnants against the JAX package's, on the CPU.

FASTA and HMMER3 conversion (a seeded FASTA with X, soft-masked residues
and line wraps; small HMMER3/b profiles written here from the grammar
``read_hmmer_msv`` parses), the native C++ parser (built here with the
host's compiler; equal to the port's Python tokenizer and the JAX one,
rejecting what the JAX parser rejects, under ASan/UBSan), the scalar
helpers of ``hmm.py``, the profiling helpers, ``populate_empty``, and the
coverage of the JAX package's exports.
"""

import json
import os

import numpy as np
import pytest

from test_torch_host import ref_from_port

import spec_viterbi_tpu as ref_pkg
import spec_viterbi_tpu.io as ref_io
import spec_viterbi_tpu.utils as ref_utils
from spec_viterbi_tpu import hmm as ref_hmm
from spec_viterbi_tpu.io import chmm as ref_chmm
from spec_viterbi_tpu.io import ess as ref_ess
from spec_viterbi_tpu.io import fasta as ref_fasta
from spec_viterbi_tpu.io import hmmer as ref_hmmer
from spec_viterbi_tpu.utils import hostmem as ref_hostmem
from spec_viterbi_tpu.utils import profiling as ref_profiling

import spec_viterbi_tpu_torch as port
import spec_viterbi_tpu_torch.io as port_io
import spec_viterbi_tpu_torch.utils as port_utils
from spec_viterbi_tpu_torch import hmm as port_hmm
from spec_viterbi_tpu_torch.io import chmm, ess, fasta, hmmer
from spec_viterbi_tpu_torch.io.generators import (
    generate_profile_hmm,
    generate_random_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.native import loader
from spec_viterbi_tpu_torch.utils import hostmem, profiling

HMM_FIELDS = ("trans_rows", "trans_cols", "trans_probs", "emissions",
              "start_probabilities_cols", "start_probabilities")
AMINO = "ACDEFGHIKLMNPQRSTVWY"


def assert_hmm_equal(a, b):
    assert (a.states_num, a.emit_num) == (b.states_num, b.emit_num)
    for f in HMM_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), f


# ---- FASTA -------------------------------------------------------------


def write_fasta(path, seed=0, records=5):
    """A seeded multi-record FASTA: X codes, soft-masked (lower-case)
    stretches, 60-column wraps and blank lines."""
    rng = np.random.default_rng(seed)
    lines = []
    for r in range(records):
        seq = "".join(rng.choice(list(AMINO + "X"), size=int(rng.integers(1, 170))))
        lo = int(rng.integers(0, len(seq)))
        seq = seq[:lo] + seq[lo : lo + 7].lower() + seq[lo + 7 :]
        lines.append(f">record_{r} seeded")
        lines += [seq[i : i + 60] for i in range(0, len(seq), 60)]
        if r % 2:
            lines.append("")
    path.write_text("\n".join(lines) + "\n")
    return path


def test_fasta_matches_jax(tmp_path):
    src = write_fasta(tmp_path / "in.fasta")
    got, want = fasta.fasta_to_sequences(src), ref_fasta.fasta_to_sequences(src)
    assert len(got) == len(want) == 5
    assert all(g.dtype == w.dtype == np.int32 and np.array_equal(g, w) for g, w in zip(got, want))
    assert any((g == 0).sum() for g in got)  # X maps to 0
    assert fasta.AMINO2NUM == ref_fasta.AMINO2NUM
    fasta.fasta_to_ess(src, tmp_path / "port.ess")
    ref_fasta.fasta_to_ess(src, tmp_path / "jax.ess")
    assert (tmp_path / "port.ess").read_bytes() == (tmp_path / "jax.ess").read_bytes()
    bad = tmp_path / "bad.fasta"
    bad.write_text(">r\nACDB\n")
    for mod in (fasta, ref_fasta):
        with pytest.raises(ValueError, match="unsupported residue 'B' in record 0"):
            mod.fasta_to_sequences(bad)


# ---- HMMER3 --------------------------------------------------------------


def write_hmmer_profile(path, length, seed=0):
    """A HMMER3/b profile of ``length`` match nodes in the grammar
    ``read_hmmer_msv`` reads: header lines up to ``LENG``, the ``COMPO``
    line, node 0's insert emissions and B transitions, then per node its
    match emissions (node index first), insert emissions and transitions,
    and ``//``. Values are seeded neg-ln probabilities."""
    rng = np.random.default_rng(seed)

    def vals(k, lo=0.5, hi=4.5):
        return "  ".join(f"{x:.5f}" for x in rng.uniform(lo, hi, size=k))

    lines = ["HMMER3/b [3.1b2 | February 2015]", "NAME  synthetic", "ACC   SYN0001.1",
             f"LENG  {length}", "ALPH  amino", "STATS LOCAL MSV      -9.8  0.71",
             "HMM          " + "        ".join(AMINO),
             "            m->m     m->i     m->d     i->m     i->i     d->m     d->d",
             f"  COMPO   {vals(20)}", f"          {vals(20)}",
             f"          {vals(3, 0.01, 0.2)}  {vals(2)}  0.00000        *"]
    for k in range(1, length + 1):
        lines.append(f"      {k}   {vals(20)}  {k} - - -")
        lines.append(f"          {vals(20)}")
        lines.append(f"          {vals(7, 0.01, 3.0)}" if k < length else
                     f"          {vals(2, 0.01, 3.0)}        *  {vals(2)}  0.00000        *")
    lines.append("//")
    path.write_text("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("length", [2, 17, 60])
def test_hmmer_matches_jax(tmp_path, length):
    src = write_hmmer_profile(tmp_path / "p.hmm", length, seed=length)
    got_l, got_e, got_t = hmmer.read_hmmer_msv(src)
    want_l, want_e, want_t = ref_hmmer.read_hmmer_msv(src)
    assert (got_l, got_e, got_t) == (want_l, want_e, want_t) and got_l == length
    got, want = hmmer.hmmer_to_hmm(src), ref_hmmer.hmmer_to_hmm(src)
    assert_hmm_equal(got, want)
    assert got.states_num == length + 2 and got.trans_num == 4 * length + 1
    # quirk 2: the B→M1 entry goes in raw (no e^(−x)); quirk 1: it lands
    # on the M1→M2 edge
    if length > 1:
        raw = float(open(src).read().split("COMPO")[1].splitlines()[2].split()[0])
        edge = (got.trans_rows == 1) & (got.trans_cols == 2)
        assert got.trans_probs[edge][0] == port_hmm.to_modified_prob_np(np.asarray([hmmer._fixed(raw)]))[0]
    hmmer.hmmer_to_chmm(src, tmp_path / "port.chmm")
    ref_hmmer.hmmer_to_chmm(src, tmp_path / "jax.chmm")
    assert (tmp_path / "port.chmm").read_bytes() == (tmp_path / "jax.chmm").read_bytes()


def test_hmmer_rejects_what_jax_rejects(tmp_path):
    no_compo = tmp_path / "x.hmm"
    no_compo.write_text("HMMER3/b\nLENG 3\n")
    short = write_hmmer_profile(tmp_path / "short.hmm", 4)
    short.write_text(short.read_text().replace("LENG  4", "LENG  5"))
    for path, msg in ((no_compo, "no COMPO line"), (short, "LENG 5 but parsed 4 nodes")):
        for mod in (hmmer, ref_hmmer):
            with pytest.raises(ValueError, match=msg):
                mod.hmmer_to_hmm(path)


# ---- the native parser -----------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded .chmm models (FS class, residual entries, a random model)
    and .ess sets (ragged, an empty sequence)."""
    d = tmp_path_factory.mktemp("corpus")
    models = {
        "profile": generate_profile_hmm(150, seed=3),
        "tie": generate_tie_heavy_hmm(90, seed=4),
        "random": generate_random_hmm(70, trans_per_state=4, emit_range=9, seed=5),
    }
    for name, h in models.items():
        chmm.write_chmm(h, d / f"{name}.chmm")
    rng = np.random.default_rng(6)
    sets = {"ragged": [rng.integers(0, 20, size=int(t)).astype(np.int32) for t in (1, 700, 33, 0, 64)],
            "uniform": [rng.integers(0, 20, size=300).astype(np.int32) for _ in range(8)]}
    for name, seqs in sets.items():
        ess.write_ess(seqs, d / f"{name}.ess")
    return d, models, sets


def test_native_builds_here():
    assert loader.compiler() is not None  # these tests need a C++ compiler on PATH
    assert loader.native_available()
    lib = loader.build()
    assert lib.parent == loader.BUILD_DIR and lib.name.startswith("libsvt_native_")


@pytest.mark.parametrize("name", ["profile", "tie", "random"])
def test_native_chmm_matches_tokenizers(corpus, name):
    d, _, _ = corpus
    path = str(d / f"{name}.chmm")
    got = loader.read_hmm_native(path)
    assert got is not None
    tokens = open(path).read().split()
    assert_hmm_equal(got, chmm._parse_tokens(tokens, path))
    assert_hmm_equal(got, ref_chmm._parse_tokens(tokens, path))


@pytest.mark.parametrize("name", ["ragged", "uniform"])
def test_native_ess_matches_tokenizers(corpus, name):
    d, _, sets = corpus
    path = str(d / f"{name}.ess")
    got = loader.read_ess_native(path)
    tokens = open(path).read().split()
    for other in (ess._parse_tokens(tokens, path), ref_ess._parse_tokens(tokens, path), sets[name]):
        assert len(got) == len(other)
        assert all(g.dtype == np.int32 and np.array_equal(g, w) for g, w in zip(got, other))


def test_native_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.ess"
    bad.write_text("2\n0 2\n1 1\n5 2\n0 0\n")  # the second header says 5, not 1
    assert loader.read_ess_native(str(bad)) is None
    with pytest.raises(ValueError, match="expected sequence number is 1, but read 5"):
        port.read_emit_seq(bad)
    assert loader.read_hmm_native("/nonexistent/x.chmm") is None
    assert loader.read_ess_native("/nonexistent/x.ess") is None
    with pytest.raises(FileNotFoundError):
        port.read_hmm("/nonexistent/x.chmm")
    hostile = tmp_path / "hostile.chmm"
    hostile.write_text("2000000000\n0\n20\n")
    assert loader.read_hmm_native(str(hostile)) is None
    with pytest.raises(ValueError, match="truncated"):
        port.read_hmm(hostile)
    hostile_ess = tmp_path / "hostile.ess"
    hostile_ess.write_text("1\n0 9000000000\n")
    assert loader.read_ess_native(str(hostile_ess)) is None


def test_public_readers_take_the_native_path(corpus, monkeypatch):
    d, models, sets = corpus
    monkeypatch.delenv("SVT_DISABLE_NATIVE", raising=False)
    before = dict(loader.parses)
    h = port.read_hmm(d / "profile.chmm")
    seqs = port.read_emit_seq(d / "ragged.ess")
    assert loader.parses == {"hmm": before["hmm"] + 1, "ess": before["ess"] + 1}
    monkeypatch.setenv("SVT_DISABLE_NATIVE", "1")
    assert loader.library() is None
    h_py, seqs_py = port.read_hmm(d / "profile.chmm"), port.read_emit_seq(d / "ragged.ess")
    assert loader.parses == {"hmm": before["hmm"] + 1, "ess": before["ess"] + 1}  # not counted
    assert_hmm_equal(h, h_py)
    assert all(np.array_equal(a, b) for a, b in zip(seqs, seqs_py))
    assert h.fingerprint() == ref_from_port(h).fingerprint()


def test_native_build_falls_back_only_without_a_compiler(corpus, monkeypatch):
    d, _, _ = corpus
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setenv("CXX", "no-such-c++-compiler")
    assert loader.compiler() is None and loader.library() is None
    before = dict(loader.parses)
    assert port.read_hmm(d / "tie.chmm").states_num > 0  # the Python tokenizer
    assert loader.parses == before
    # a compiler that is there but fails raises, with its output
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native build failed"):
        loader.library()
    with pytest.raises(RuntimeError, match="native build failed"):
        port.read_hmm(d / "tie.chmm")


def test_native_parser_under_sanitizers(corpus, tmp_path):
    d, models, sets = corpus
    bad, bad_ess = tmp_path / "hostile.chmm", tmp_path / "hostile.ess"
    bad.write_text("2000000000\n0\n20\n")
    bad_ess.write_text("1\n0 9000000000\n")
    out = loader.run_sanitizer_check(str(d / "profile.chmm"), models["profile"].states_num,
                                     str(d / "ragged.ess"), len(sets["ragged"]), str(bad), str(bad_ess))
    assert "native sanitizer checks OK" in out


# ---- hmm.py, profiling, hostmem -----------------------------------------------


def test_scalar_helpers_match_jax():
    rng = np.random.default_rng(0)
    ps = [0.0, -0.5, 1.0, 0.5, 1e-300, *rng.uniform(0, 1, size=20).tolist()]
    for p in ps:
        assert port.to_modified_prob(p) == ref_hmm.to_modified_prob(p)
    assert port.ZERO_PROB == ref_hmm.ZERO_PROB == float("inf")
    inf = float("inf")
    pairs = [(inf, inf), (inf, 5.0), (5.0, inf), (-inf, -inf), (1.0, 2.0), (1.0, 2.0000001),
             (3.0, 1.5), *zip(rng.uniform(0, 9, 20).tolist(), rng.uniform(0, 9, 20).tolist())]
    for x, y in pairs:
        for delta in (1.0, 0.25):
            assert port.almost_equal(x, y, delta) == ref_hmm.almost_equal(x, y, delta), (x, y, delta)
    h = generate_profile_hmm(150, seed=0)
    assert h.padded_states == ref_from_port(h).padded_states == 256


def test_step_timer_matches_jax():
    times = [3.0, 1.0, 7.5, 2.25, 9.0, 0.5]
    a, b = profiling.StepTimer(), ref_profiling.StepTimer()
    assert a.summary() == b.summary() == {"count": 0}
    a.times_ms, b.times_ms = list(times), list(times)
    assert a.summary() == b.summary()
    with a.step():
        pass
    assert len(a.times_ms) == len(times) + 1 and a.times_ms[-1] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    out = tmp_path / "traces"
    with profiling.trace(str(out)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert prof is not None
    files = list(out.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_populate_empty_matches_jax():
    assert hostmem.POPULATE_THRESHOLD_BYTES == ref_hostmem.POPULATE_THRESHOLD_BYTES
    for shape, dtype in (((3, 5), np.float32), ((1024, 1024, 9), np.float32), ((5 << 20,), np.int64)):
        got, want = hostmem.populate_empty(shape, dtype), ref_hostmem.populate_empty(shape, dtype)
        assert got.shape == want.shape == shape and got.dtype == want.dtype == np.dtype(dtype)
        if got.nbytes >= hostmem.POPULATE_THRESHOLD_BYTES:
            assert not got.any()  # freshly mapped pages: zero contents
            got[-1] = 7
            assert got.flags.writeable and got[-1].all()
        del got, want


def test_compose_level_with_populate_empty(monkeypatch):
    """The level-2 compose gives the same stacks with either slab
    allocator (``populate_empty`` forced onto its mmap path)."""
    from spec_viterbi_tpu_torch.ops import structured_compose as sc
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator

    h = generate_profile_hmm(60, seed=2)
    sop = StructuredOperator.from_hmm(h)
    l1 = sc.batched_level1(sop, h.emission_matrix(pad_to=sop.n))
    monkeypatch.setattr(hostmem, "POPULATE_THRESHOLD_BYTES", 0)
    want = sc.batched_compose_level(l1, l1)
    got = sc.batched_compose_level(l1, l1, alloc=hostmem.populate_empty)
    assert got[0] == want[0]
    assert all(np.array_equal(g, w) for g, w in zip(got[1:], want[1:]))


# ---- exports -------------------------------------------------------------------

JAX_ONLY = {"enable_persistent_cache"}  # XLA's compile cache


@pytest.mark.parametrize("pair", ["package", "io", "utils"])
def test_exports_cover_jax(pair):
    ours, theirs = {"package": (port, ref_pkg), "io": (port_io, ref_io), "utils": (port_utils, ref_utils)}[pair]
    missing = set(theirs.__all__) - set(ours.__all__) - JAX_ONLY
    assert not missing
    for name in ours.__all__:
        assert getattr(ours, name) is not None
    assert os.path.basename(ours.__file__) == "__init__.py"
