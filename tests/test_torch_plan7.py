"""The full Plan7 profile on the port's normal path, on the CPU.

The converter's fold against a brute-force enumeration of the delete
chains, the HMMER3 reader on a hand-written profile, ``decode_auto``
against the benchmark's two plain references (``svt_bench/reference.py``
on the folded arrays, bit for bit; ``svt_bench/plan7_reference.py`` over
explicit M, I and D states, within float32's error bound), and the
decomposition against the JAX package's. Only the last test imports JAX.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from svt_bench import plan7_reference, reference
from svt_bench.structures import plan7_profile

from spec_viterbi_tpu_torch.io.generators import generate_plan7_hmm, generate_plan7_profile
from spec_viterbi_tpu_torch.io.hmmer import (
    BACKGROUND_FREQUENCIES,
    PLAN7_TRANSITIONS,
    plan7_to_hmm,
    read_hmmer_plan7,
)
from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.scheduler import decode_auto

torch.set_num_threads(1)


def brute_force_fold(profile) -> dict:
    """``{(src, dst): float32 cost}`` of the folded model, each delete
    chain Mk → Dk+1 → … → Dj-1 → Mj enumerated and summed one term after
    another in float64 (the costs are the converter's own −log2 of each
    probability), then rounded once."""
    big_l = profile.length
    cost = {name: -np.log2(profile.trans[:, i]) for i, name in enumerate(PLAN7_TRANSITIONS)}
    c_state = 2 * big_l
    edges = {}

    def add(s, d, value):
        assert (s, d) not in edges
        if np.isfinite(value):
            edges[(s, d)] = np.float32(value)

    add(0, 0, -np.log2(profile.n_loop))
    for k in range(1, big_l + 1):
        add(0, k, -np.log2(profile.entry[k - 1]))
        add(k, 0, -np.log2(profile.exit_n[k - 1]))
        add(k, c_state, -np.log2(profile.exit_c[k - 1]))
    for k in range(1, big_l):
        add(k, k + 1, cost["mm"][k - 1])
        add(k, big_l + k, cost["mi"][k - 1])
        add(big_l + k, k + 1, cost["im"][k - 1])
        add(big_l + k, big_l + k, cost["ii"][k - 1])
    add(c_state, c_state, -np.log2(profile.c_loop))
    for k in range(1, big_l - 1):
        for j in range(k + 2, big_l + 1):
            total = float(cost["md"][k - 1])  # Mk → Dk+1
            for i in range(k + 1, j - 1):  # Di → Di+1
                total += float(cost["dd"][i - 1])
            total += float(cost["dm"][j - 2])  # Dj-1 → Mj
            add(k, j, total)
    return edges


def coo(hmm) -> dict:
    keys = list(zip(hmm.trans_rows.tolist(), hmm.trans_cols.tolist()))
    assert len(set(keys)) == len(keys)
    assert hmm.trans_probs.dtype == np.float32
    return dict(zip(keys, hmm.trans_probs.tolist()))


@pytest.mark.parametrize("length", [6, 9])
def test_fold_equals_brute_force(length):
    profile = generate_plan7_profile(length, seed=length + 100)
    hmm = plan7_to_hmm(profile)
    want = brute_force_fold(profile)
    got = coo(hmm)
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] and np.signbit(got[k]) == np.signbit(want[k]) for k in want)
    assert hmm.states_num == 2 * length + 1
    assert hmm.trans_num == (length - 2) * (length - 1) // 2 + 7 * length - 2
    # one folded transition Mk → Mj for every j ≥ k + 2
    folded = [(s, d) for s, d in want if 1 <= s and d <= length and d >= s + 2]
    assert len(folded) == (length - 2) * (length - 1) // 2


def test_generator_is_the_benchmark_structure_and_seeded():
    a, b = generate_plan7_hmm(30, seed=5), generate_plan7_hmm(30, seed=5)
    c = generate_plan7_hmm(30, seed=6)
    assert a.fingerprint() == b.fingerprint() != c.fingerprint()
    arrays = plan7_profile.build({"match_states": 30, "symbols": 20}, 5)
    for key, field in (("src", "trans_rows"), ("dst", "trans_cols"), ("cost", "trans_probs"),
                       ("emissions", "emissions"), ("start_states", "start_probabilities_cols"),
                       ("start_cost", "start_probabilities")):
        want = getattr(a, field)
        assert arrays[key].dtype == want.dtype and np.array_equal(arrays[key], want), key
    params = plan7_profile.profile({"match_states": 30, "symbols": 20}, 5)
    for key, value in dataclasses.asdict(generate_plan7_profile(30, seed=5)).items():
        assert np.array_equal(params[key], value), key
    with pytest.raises(ValueError, match="at least 2 nodes"):
        generate_plan7_profile(1)


# a HMMER3 profile of four nodes; emission values are filled in per line
HMMER3_LENG4 = """\
HMMER3/f [3.1b2 | February 2015]
NAME  toy4
ACC   TOY00004.1
DESC  a hand-written four-node profile
LENG  4
ALPH  amino
RF    no
MM    no
CONS  yes
CS    no
MAP   yes
NSEQ  3
EFFN  1.500000
CKSUM 1234
STATS LOCAL MSV      -8.1234  0.71000
STATS LOCAL VITERBI  -8.9876  0.71000
STATS LOCAL FORWARD  -3.4567  0.71000
HMM          A        C        D        E        F        G        H        I        K        L        M        N        P        Q        R        S        T        V        W        Y
            m->m     m->i     m->d     i->m     i->i     d->m     d->d
  COMPO   {compo}
          {ins0}
          0.02020  4.60517  4.60517  0.61958  0.77255  0.00000        *
      1   {m1}      1 a - - -
          {i1}
          0.10536  2.99573  2.52573  0.35667  1.20397  0.51083  0.91629
      2   {m2}      2 c - - -
          {i2}
          0.05129  3.50656  3.21888  0.22314  1.60944  0.69315  0.69315
      3   {m3}      3 d - - -
          {i3}
          0.22314  2.30259  2.81341  0.91629  0.51083  0.10536  2.30259
      4   {m4}      4 e - - -
          {i4}
          0.00000        *        *  0.00000        *  0.00000        *
//
"""


def _emission_line(node: int, kind: int) -> str:
    return "  ".join(f"{1.2 + 0.13 * a + 0.07 * node + 0.5 * kind:.5f}" for a in range(20))


def test_reader_round_trips_a_hand_written_profile(tmp_path):
    fields = {"compo": _emission_line(0, 2), "ins0": _emission_line(0, 1)}
    for k in range(1, 5):
        fields[f"m{k}"] = _emission_line(k, 0)
        fields[f"i{k}"] = _emission_line(k, 1)
    path = tmp_path / "toy4.hmm"
    path.write_text(HMMER3_LENG4.format(**fields))
    profile = read_hmmer_plan7(path)
    assert profile.length == 4
    def probs(tokens):  # e^(−x) of neg-ln tokens, as HMMER writes them
        return [math.exp(-float(x)) for x in tokens]

    for k in range(1, 5):
        assert profile.match_emissions[k - 1].tolist() == probs(fields[f"m{k}"].split())
    assert profile.insert_emissions.shape == (3, 20)
    assert profile.insert_emissions[2].tolist() == probs(fields["i3"].split())
    # nodes 1..3, in the file's order MM MI MD IM II DM DD; node 4's leads to E
    assert profile.trans.shape == (3, 7)
    assert profile.trans[1].tolist() == probs(
        "0.05129 3.50656 3.21888 0.22314 1.60944 0.69315 0.69315".split())
    move = 3.0 / 7.0
    assert profile.n_loop == profile.c_loop == 1.0 - move
    np.testing.assert_array_equal(profile.entry, np.full(4, move * 2.0 / 20.0))
    np.testing.assert_array_equal(profile.n_emissions, BACKGROUND_FREQUENCIES)

    hmm = plan7_to_hmm(profile)
    assert (hmm.states_num, hmm.emit_num, hmm.trans_num) == (9, 20, 29)
    assert coo(hmm) == brute_force_fold(profile)
    # M1 → D2 → D3 → M4: MD(1) + DD(2) + DM(3), from the file's neg-ln
    chain = (2.52573 + 0.69315 + 0.10536) / np.log(2.0)
    assert coo(hmm)[(1, 4)] == pytest.approx(chain, rel=1e-6)
    # I1..I3 are states 5..7 and emit the insert rows; C (8) the background
    assert hmm.emissions[:, 6].tolist() == (
        -np.log2(profile.insert_emissions[1])).astype(np.float32).tolist()

    broken = tmp_path / "short.hmm"
    broken.write_text(path.read_text().replace("LENG  4", "LENG  5"))
    with pytest.raises(ValueError, match="LENG 5 but parsed 4 nodes"):
        read_hmmer_plan7(broken)


def _arrays(hmm) -> dict:
    return {"states": hmm.states_num, "symbols": hmm.emit_num, "src": hmm.trans_rows,
            "dst": hmm.trans_cols, "cost": hmm.trans_probs, "emissions": hmm.emissions,
            "start_states": hmm.start_probabilities_cols,
            "start_cost": hmm.start_probabilities}


def _ragged(count, top, seed):
    rng = np.random.default_rng(seed)
    lengths = np.r_[1, 2, rng.integers(1, top, size=count - 2)]
    return [rng.integers(0, 20, size=int(t)).astype(np.int32) for t in lengths]


@pytest.mark.parametrize("length,mode", [(6, "structured"), (12, "structured"), (40, "dense")])
def test_decode_auto_matches_both_references(length, mode):
    profile = generate_plan7_profile(length, seed=2**31 + length)
    hmm = plan7_to_hmm(profile)
    assert ViterbiDecoder(hmm, device="cpu").mode == mode
    seqs = _ragged(13, 70, seed=length)
    got = decode_auto(hmm, seqs, device="cpu")
    arrays = _arrays(hmm)
    want = reference.decode(reference.Model(arrays, "cpu"), seqs, block=5)
    assert all(g.dtype == np.float32 and np.array_equal(g, w) for g, w in zip(got, want))

    # the semantics: within float32's error bound of the float64 recurrence
    # over explicit M, I and D states (plan7_reference.f32_bound says why)
    plan7 = plan7_reference.decode(dataclasses.asdict(profile), seqs)
    bf16 = reference.decode(reference.Model(arrays, "cpu", torch.bfloat16), seqs)
    for s, g, p, b in zip(seqs, got, plan7, bf16):
        finite = np.isfinite(p)
        assert np.array_equal(np.isfinite(g), finite)
        bound = plan7_reference.f32_bound(len(s), p)
        assert np.abs(g[finite] - p[finite]).max() <= bound
        # the control: bfloat16 scores fail the same bound
        if len(s) >= 5:
            assert np.abs(b[finite].astype(np.float64) - p[finite]).max() > bound


def test_dense_paths_match_the_reference():
    hmm = generate_plan7_hmm(40, seed=4)
    seqs = _ragged(6, 30, seed=7)
    got = decode_auto(hmm, seqs, paths=True, device="cpu")
    want = reference.decode(reference.Model(_arrays(hmm), "cpu"), seqs, paths=True)
    for (gs, gp), (ws, wp) in zip(got, want):
        assert np.array_equal(gs, ws) and np.array_equal(gp, wp)


@pytest.mark.parametrize("length", [6, 40, 500])
def test_decomposition_matches_jax(length):
    import spec_viterbi_tpu.hmm as ref_hmm
    from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator

    hmm = generate_plan7_hmm(length, seed=length)
    ref = ref_hmm.HMM(**{f: getattr(hmm, f) for f in (
        "states_num", "emit_num", "trans_rows", "trans_cols", "trans_probs", "emissions",
        "start_probabilities_cols", "start_probabilities")})
    port, jax_op = StructuredOperator.from_hmm(hmm), RefOperator.from_hmm(ref)
    for f in ("n", "states_num", "diag_offsets", "row_idx", "col_idx", "nnz"):
        assert getattr(port, f) == getattr(jax_op, f), f
    for f in ("diag_vals", "row_vals", "col_vals", "res_src", "res_dst", "res_vals"):
        x, y = getattr(port, f), getattr(jax_op, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert port.cost_ratio() == jax_op.cost_ratio()
    if length == 500:  # the benchmark's size: dense mode, 442 dense source rows
        assert len(port.row_idx) == 442 and port.cost_ratio() >= 0.125
