"""The port's ``SpecializedViterbi`` against the JAX package's, bit for bit.

The level-1 stack, every level's tuple stack and both decodes form the
same f32 candidates as the JAX specializer (each rounded once, min exact),
so they are bit-equal to it. Against the numpy oracle, levels of 2 and
more agree within ``almost_equal_vec`` (±1.0 in −log2 space): the
reference's own contract, since a tuple operator reassociates the sums.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spec_viterbi_tpu.hmm as ref_hmm
from spec_viterbi_tpu.models import specializer as ref_spec
from spec_viterbi_tpu.models.oracle import viterbi_scores_oracle
from spec_viterbi_tpu.utils.cache import OperatorCache as RefCache

import spec_viterbi_tpu_torch as port
from spec_viterbi_tpu_torch.io import generate_profile_hmm, generate_random_hmm
from spec_viterbi_tpu_torch.models import specializer

torch.set_num_threads(1)

FIELDS = ("states_num", "emit_num", "trans_rows", "trans_cols", "trans_probs", "emissions",
          "start_probabilities_cols", "start_probabilities")


def _ref(hmm):
    return ref_hmm.HMM(**{f: getattr(hmm, f) for f in FIELDS})


def _model():
    """About 40 states and 4 symbols, dense-class (no level-1 delegate)."""
    return generate_random_hmm(42, trans_per_state=24, emit_range=4, seed=6)


def _quiet(spec, hmm):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        spec.spec_with(hmm)
    return spec


def _seqs(hmm, level, seed):
    """Lengths 1, 2, multiples of the level (after the first symbol) and
    not, ragged across quantization groups (64 and 96)."""
    rng = np.random.default_rng(seed)
    lengths = [1, 2, 1 + level, 1 + 3 * level, 2 + 3 * level, 40, 63, 64, 65, 90]
    return [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lengths]


def test_build_level1_and_add_level_match_jax():
    hmm = _model()
    n = 128
    a_t = hmm.transposed_transition_matrix(pad_to=n)
    pi, em = hmm.start_vector(pad_to=n), hmm.emission_matrix(pad_to=n)
    start, ops = specializer._build_level1(torch.from_numpy(a_t), torch.from_numpy(pi),
                                           torch.from_numpy(em))
    r_start, r_ops = ref_spec._build_level1(jnp.asarray(a_t), jnp.asarray(pi), jnp.asarray(em))
    np.testing.assert_array_equal(start.numpy(), np.asarray(r_start))
    np.testing.assert_array_equal(ops.numpy(), np.asarray(r_ops))
    assert ops.shape == (hmm.emit_num + 1, n, n)
    eye = ops[hmm.emit_num]
    assert torch.equal(eye.diagonal(), torch.zeros(n)) and int(torch.isinf(eye).sum()) == n * n - n
    r_ops_t = jnp.transpose(r_ops, (0, 2, 1))
    t, r_t = ops, r_ops
    for level in (2, 3):
        t, r_t = specializer._add_level(ops, t), ref_spec._add_level(r_ops_t, r_t)
        assert t.shape == ((hmm.emit_num + 1) ** level, n, n)
        np.testing.assert_array_equal(t.numpy(), np.asarray(r_t))


@pytest.mark.parametrize("level", [1, 2, 3])
def test_run_spec_matches_jax_and_oracle(level):
    hmm = _model()
    spec = _quiet(port.SpecializedViterbi(level=level, device="cpu"), hmm)
    ref = _quiet(ref_spec.SpecializedViterbi(level=level), _ref(hmm))
    assert spec._delegate is None and ref._delegate is None
    assert spec.get_level() == level
    np.testing.assert_array_equal(spec.tuple_ops.numpy(), np.asarray(ref.tuple_ops))
    seqs = _seqs(hmm, level, level)
    batch = spec.run_spec_batch(seqs)
    for s, got_b, want_b in zip(seqs, batch, ref.run_spec_batch(seqs)):
        got = spec.run_spec(s)
        np.testing.assert_array_equal(got, np.asarray(ref.run_spec(s)))
        np.testing.assert_array_equal(got_b, np.asarray(want_b))
        if level <= 2:  # a tail of one symbol: the identity padding is exact
            np.testing.assert_array_equal(got_b, got)
        else:  # the padded tuple applies the tail as one product
            assert port.almost_equal_vec(got_b, got)
        assert port.almost_equal_vec(got, viterbi_scores_oracle(_ref(hmm), s))
    assert spec.run_spec_batch([]) == []


def test_level1_delegate():
    """A structured model at level 1 delegates to the port's decoder (the
    fused kernels on cuda, the plain loop here); ``use_kernels=False``
    reaches the delegate as JAX's ``use_pallas=False`` does."""
    hmm = generate_profile_hmm(50, seed=2)
    seqs = _seqs(hmm, 1, 9)
    want = [viterbi_scores_oracle(_ref(hmm), s) for s in seqs]
    for use_kernels in (None, False):
        spec = port.SpecializedViterbi(level=1, use_kernels=use_kernels, device="cpu")
        spec.spec_with(hmm)
        assert isinstance(spec._delegate, port.ViterbiDecoder)
        assert spec._delegate.mode == "structured" and spec._delegate._use_kernels is use_kernels
        assert spec.ops is None and spec.tuple_ops is None
        for g, w in zip(spec.run_spec_batch(seqs), want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(spec.run_spec(seqs[5]), want[5])
    ref = ref_spec.SpecializedViterbi(level=1)
    ref.spec_with(_ref(hmm))
    assert ref._delegate is not None
    for g, w in zip(ref.run_spec_batch(seqs), want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_slowdown_warning_and_memory_model():
    big = generate_random_hmm(states_num=160, trans_per_state=2, emit_range=2, seed=3)
    spec = port.SpecializedViterbi(level=2, device="cpu")
    with pytest.warns(UserWarning, match="level=1"):
        spec.spec_with(big)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port.SpecializedViterbi(level=2, device="cpu").spec_with(_model())  # 128 / 14 < 10
    for states, level in ((902, 2), (902, 1), (2407, 2), (40, 3)):
        assert (port.SpecializedViterbi.predicted_dense_decode_slowdown(states, level)
                == ref_spec.SpecializedViterbi.predicted_dense_decode_slowdown(states, level))
    for states, emit, level in ((2407, 20, 2), (40, 4, 3), (100, 20, 1)):
        assert (port.SpecializedViterbi.spec_memory_bytes(states, emit, level)
                == ref_spec.SpecializedViterbi.spec_memory_bytes(states, emit, level))
    assert port.SpecializedViterbi.spec_memory_bytes(2407, 20, 2) == 441 * 2432 * 2432 * 4


def test_errors_match_jax():
    hmm = _model()
    for mod in (port, ref_spec):
        kw = {"device": "cpu"} if mod is port else {}
        with pytest.raises(ValueError, match="level must be >= 1"):
            mod.SpecializedViterbi(level=0, **kw)
        fresh = mod.SpecializedViterbi(level=2, **kw)
        with pytest.raises(RuntimeError, match="spec_with"):
            fresh.run_spec(np.zeros(3, np.int32))
        with pytest.raises(RuntimeError, match="spec_with"):
            fresh.run_spec_batch([np.zeros(3, np.int32)])
    profile = generate_profile_hmm(20, seed=1)
    for level, model in ((2, hmm), (1, hmm), (1, profile)):
        spec = _quiet(port.SpecializedViterbi(level=level, device="cpu"), model)
        bad = np.array([0, model.emit_num], dtype=np.int32)
        with pytest.raises(ValueError, match="out of range"):
            spec.run_spec(bad)
        with pytest.raises(ValueError, match="out of range"):
            spec.run_spec_batch([np.array([0, 1], np.int32), bad])


def test_cache_round_trip_between_packages(tmp_path):
    """A stack the JAX specializer stored loads into the port's (and back),
    and gives the same scores as a cold build."""
    hmm = _model()
    s = _seqs(hmm, 2, 4)[7]
    ref = _quiet(ref_spec.SpecializedViterbi(level=2, cache=RefCache(str(tmp_path))), _ref(hmm))
    cache = port.OperatorCache(str(tmp_path))
    assert cache.load(hmm.fingerprint(), 2, 128) is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no warning on the read-only memmaps
        warm = port.SpecializedViterbi(level=2, cache=cache, device="cpu")
        warm.spec_with(hmm)
    np.testing.assert_array_equal(warm.run_spec(s), np.asarray(ref.run_spec(s)))
    other = tmp_path / "port"
    cold = _quiet(port.SpecializedViterbi(level=2, cache=port.OperatorCache(str(other)),
                                          device="cpu"), hmm)
    back = _quiet(ref_spec.SpecializedViterbi(level=2, cache=RefCache(str(other))), _ref(hmm))
    np.testing.assert_array_equal(np.asarray(back.run_spec(s)), cold.run_spec(s))
