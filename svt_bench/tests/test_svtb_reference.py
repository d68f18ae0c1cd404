"""The plain reference against a brute-force dense (min,+) recurrence, and the
frozen structure against the program's generator it was copied from."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from svt_bench import reference
from svt_bench.structures import msv_profile


def brute(arrays: dict, seq: np.ndarray):
    """Scores and path of one sequence by the dense recurrence: every
    candidate ``v[i] + A[i, j]`` in float32, the lowest source on a tie."""
    n = arrays["states"]
    a = np.full((n, n), np.inf, np.float32)
    np.minimum.at(a, (arrays["src"], arrays["dst"]), arrays["cost"])
    pi = np.full(n, np.inf, np.float32)
    np.minimum.at(pi, arrays["start_states"], arrays["start_cost"])
    em = arrays["emissions"]
    v = (em[seq[0]] + pi).astype(np.float32)
    ptr = []
    for o in seq[1:]:
        cand = v[:, None] + a  # [src, dst]
        ptr.append(np.argmin(cand, axis=0))
        v = (em[o] + cand.min(axis=0)).astype(np.float32)
    path = [int(np.argmin(v))]
    for p in reversed(ptr):
        path.append(int(p[path[-1]]))
    return v, np.array(path[::-1])


def random_model(n: int, symbols: int, seed: int, levels: bool) -> dict:
    """A seeded sparse model; with ``levels`` every cost is 0, 1 or 2, so
    equal candidates are common, and some states are unreachable."""
    rng = np.random.default_rng(seed)
    m = 4 * n
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    if levels:
        cost = rng.choice(np.float32([0.0, 1.0, 2.0]), m)
        em = rng.choice(np.float32([0.0, 1.0, 2.0, np.inf]), (symbols, n))
    else:
        cost = rng.uniform(0.1, 6.0, m).astype(np.float32)
        em = rng.uniform(0.1, 6.0, (symbols, n)).astype(np.float32)
    return {"states": n, "symbols": symbols, "src": src, "dst": dst, "cost": cost,
            "emissions": em, "start_states": np.array([0, 1]),
            "start_cost": np.float32([0.5, 1.0])}


@pytest.mark.parametrize("levels", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_matches_dense_brute_force(seed, levels):
    arrays = random_model(23, 5, seed, levels)
    rng = np.random.default_rng(seed + 100)
    seqs = [rng.integers(0, 5, size=int(t)) for t in rng.integers(1, 30, size=9)]
    model = reference.Model(arrays, "cpu")
    got = reference.decode(model, seqs, paths=True, block=4)
    scores_only = reference.decode(model, seqs, paths=False, block=5)
    for seq, (scores, path), alone in zip(seqs, got, scores_only):
        want_s, want_p = brute(arrays, seq)
        assert np.array_equal(scores, want_s)
        assert np.array_equal(alone, want_s)
        assert np.array_equal(path, want_p)


def test_reference_on_the_profile_structure():
    arrays = msv_profile.build({"match_states": 30, "symbols": 20}, seed=2**33 + 5)
    rng = np.random.default_rng(4)
    seqs = [rng.integers(0, 20, size=int(t)) for t in (1, 2, 17, 40)]
    got = reference.decode(reference.Model(arrays, "cpu"), seqs, paths=True)
    for seq, (scores, path) in zip(seqs, got):
        want_s, want_p = brute(arrays, seq)
        assert np.array_equal(scores, want_s) and np.array_equal(path, want_p)


def test_bfloat16_reference_differs():
    """The control's precision is visibly coarser at the cells' lengths."""
    arrays = msv_profile.build({"match_states": 30, "symbols": 20}, seed=9)
    seq = [np.random.default_rng(1).integers(0, 20, size=300)]
    f32 = reference.decode(reference.Model(arrays, "cpu"), seq)[0]
    bf16 = reference.decode(reference.Model(arrays, "cpu", torch.bfloat16), seq)[0]
    assert np.count_nonzero(f32 != bf16) > 0


def test_structure_is_the_programs_generator():
    from spec_viterbi_tpu_torch.io.generators import generate_profile_hmm

    for big_l, seed in ((2, 0), (40, 7), (500, 2**31 + 11)):
        hmm = generate_profile_hmm(big_l, seed=seed)
        arrays = msv_profile.build({"match_states": big_l, "symbols": 20}, seed)
        assert arrays["states"] == hmm.states_num
        for key, want in (("src", hmm.trans_rows), ("dst", hmm.trans_cols),
                          ("cost", hmm.trans_probs), ("emissions", hmm.emissions),
                          ("start_states", hmm.start_probabilities_cols),
                          ("start_cost", hmm.start_probabilities)):
            assert arrays[key].dtype == want.dtype and np.array_equal(arrays[key], want), key


@pytest.mark.parametrize("name,states,transitions", [("msv2405", 2407, 9621), ("msv500", 502, 2001)])
def test_configurations_build_their_published_sizes(name, states, transitions):
    from svt_bench.harness import load_json

    config = load_json("configs", name)
    arrays = msv_profile.build(config, seed=1)
    assert arrays["states"] == config["states"] == states
    assert len(arrays["src"]) == config["transitions"] == transitions
    assert arrays["emissions"].shape == (config["symbols"], states)
