"""The port's structured specializer against the JAX package's, bit for bit.

- The copied ``structured_compose`` builds the same offsets and bit-equal
  ``dv``/``uu``/``ww`` stacks as the JAX module at levels 1-3.
- The composed form (the CPU, ``use_kernels=False``, operators outside the
  fused class) forms the same f32 candidates as the JAX composed form
  (``use_pallas=False``), each rounded once, min exact: bit-equal.
- The factored form (the fused decoder, here through its plain versions)
  is bit-equal to the non-specialized decode.
- Against the numpy oracle both agree within ``almost_equal_vec`` (±1.0 in
  −log2 space, the reference's contract: a tuple operator reassociates
  the sums).

Two seeded models: an FS-class profile model (60 states, 20 symbols) and
a model outside the fused class (40 states, 4 symbols, 12 residual
entries, more than ``MAX_FUSED_RESIDUAL``).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spec_viterbi_tpu.hmm as ref_hmm
from spec_viterbi_tpu.models.oracle import viterbi_scores_oracle
from spec_viterbi_tpu.models.spec_structured import StructuredSpecializedViterbi as RefSSV
from spec_viterbi_tpu.ops import structured_compose as ref_sc
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.utils.cache import OperatorCache as RefCache

import spec_viterbi_tpu_torch as port
from spec_viterbi_tpu_torch.hmm import HMM, to_modified_prob_np
from spec_viterbi_tpu_torch.io import generate_profile_hmm
from spec_viterbi_tpu_torch.ops import fused
from spec_viterbi_tpu_torch.ops import structured_compose as sc
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator

torch.set_num_threads(1)

FIELDS = ("states_num", "emit_num", "trans_rows", "trans_cols", "trans_probs", "emissions",
          "start_probabilities_cols", "start_probabilities")
LEVELS = (1, 2, 3)


def _ref(hmm):
    return ref_hmm.HMM(**{f: getattr(hmm, f) for f in FIELDS})


def _residual_hmm(seed: int = 5) -> HMM:
    """40 states, 4 symbols: the +1 diagonal, a dense source row (state
    0), a dense destination column (state 39) and 12 scattered entries
    that fall to the residual."""
    rng = np.random.default_rng(seed)
    n = 40
    entries = {(i, i + 1) for i in range(n - 1)}
    entries |= {(0, j) for j in range(n)} | {(i, n - 1) for i in range(n)}
    extra = set()
    while len(extra) < 12:
        s, d = (int(x) for x in rng.integers(1, n - 1, size=2))
        if d - s != 1 and (s, d) not in entries:
            extra.add((s, d))
    pairs = sorted(entries | extra)
    starts = np.array([0, 3, 17], np.int64)
    return HMM(
        states_num=n,
        emit_num=4,
        trans_rows=np.array([p[0] for p in pairs], np.int64),
        trans_cols=np.array([p[1] for p in pairs], np.int64),
        trans_probs=to_modified_prob_np(rng.uniform(0.01, 1.0, size=len(pairs))),
        emissions=to_modified_prob_np(rng.uniform(0.01, 1.0, size=(4, n))),
        start_probabilities_cols=starts,
        start_probabilities=to_modified_prob_np(rng.uniform(0.1, 1.0, size=starts.size)),
    )


MODELS = {
    "profile": lambda: generate_profile_hmm(58, seed=3),
    "residual": _residual_hmm,
}


def _seqs(hmm, seed: int):
    """Ragged lengths: 1, 2, multiples of 2 and 3 after the first symbol
    and not, and two of one length (one exact-length bucket)."""
    rng = np.random.default_rng(seed)
    lengths = [1, 2, 3, 4, 5, 7, 13, 13, 40, 41]
    return [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lengths]


def _operator(hmm):
    sop = StructuredOperator.from_hmm(hmm)
    return sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)


def test_models_are_on_both_sides_of_the_fused_class():
    profile, _, _ = _operator(MODELS["profile"]())
    residual, _, _ = _operator(MODELS["residual"]())
    assert fused.fused_eligible(profile) and profile.residual_nnz == 0
    assert residual.residual_nnz == 12 > fused.MAX_FUSED_RESIDUAL
    assert not fused.fused_eligible(residual)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_batched_levels_bit_equal_to_jax(name, level):
    hmm = MODELS[name]()
    sop, em, _ = _operator(hmm)
    ref_sop = RefOperator.from_hmm(_ref(hmm), pad_to=sop.n)
    got = sc.batched_levels(sop, em, level)
    want = ref_sc.batched_levels(ref_sop, em, level)
    for g, w in zip(got, want):  # level 1, then level L
        assert g[0] == w[0]  # offsets
        for a, b in zip(g[1:], w[1:]):  # dv, uu, ww
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert got[1][1].shape[0] == hmm.emit_num**level


@pytest.mark.parametrize("name", sorted(MODELS))
def test_pairwise_algebra_matches_jax(name):
    """``from_structured``, ``compose``, ``apply_components`` and
    ``to_dense`` of the copy against the JAX module, on symbol operators."""
    hmm = MODELS[name]()
    sop, em, _ = _operator(hmm)
    ref_sop = RefOperator.from_hmm(_ref(hmm), pad_to=sop.n)

    def sym_ops(mod, op, o):
        return [
            mod.Diag(c.offset, c.vals + em[o]) if isinstance(c, mod.Diag) else mod.Rank1(c.u + em[o], c.w)
            for c in mod.from_structured(op)
        ]

    got = sc.compose(sym_ops(sc, sop, 1), sym_ops(sc, sop, 0))
    want = ref_sc.compose(sym_ops(ref_sc, ref_sop, 1), sym_ops(ref_sc, ref_sop, 0))
    assert [type(c).__name__ for c in got] == [type(c).__name__ for c in want]
    v = np.random.default_rng(1).uniform(0, 5, sop.n).astype(np.float32)
    np.testing.assert_array_equal(sc.apply_components(got, v), ref_sc.apply_components(want, v))
    np.testing.assert_array_equal(sc.to_dense(got, sop.n), ref_sc.to_dense(want, sop.n))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_composed_form_bit_equal_to_jax(name, level):
    hmm = MODELS[name]()
    spec = port.StructuredSpecializedViterbi(level=level, device="cpu")
    spec.spec_with(hmm)
    assert spec._fused is None and spec.get_level() == level
    ref = RefSSV(level=level, use_pallas=False)
    ref.spec_with(_ref(hmm))
    assert spec.tuple_offsets == ref.tuple_offsets and spec.l1_offsets == ref.l1_offsets
    assert spec.num_components == ref.num_components
    seqs = _seqs(hmm, level)
    batch = spec.run_spec_batch(seqs)
    for s, got_b, want_b in zip(seqs, batch, ref.run_spec_batch(seqs)):
        got = spec.run_spec(s)
        np.testing.assert_array_equal(got, np.asarray(ref.run_spec(s)))
        np.testing.assert_array_equal(got_b, np.asarray(want_b))
        np.testing.assert_array_equal(got_b, got)  # exact-length buckets: no padding
    assert spec.run_spec_batch([]) == []


@pytest.mark.parametrize("level", (1, 3))
def test_factored_form_bit_equal_to_decoder(level):
    """The fused decoder's plain versions stand in for its kernels here;
    ``use_kernels=False`` keeps the composed form on every device."""
    hmm = MODELS["profile"]()
    sop, em, pi = _operator(hmm)
    spec = port.StructuredSpecializedViterbi(level=level, device="cpu")
    spec.spec_with(hmm)
    spec._fused = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
    dec = port.ViterbiDecoder(hmm, mode="structured", device="cpu")
    seqs = _seqs(hmm, 7) + [s[:41] for s in _seqs(hmm, 8)[-2:]]
    want = dec.decode_batch(seqs)
    for g, w in zip(spec.run_spec_batch(seqs), want):
        np.testing.assert_array_equal(g, w)
    uniform = [s[:40] for s in _seqs(hmm, 9)[-2:]]  # one length: the unmasked FS arm
    for g, w in zip(spec.run_spec_batch(uniform), dec.decode_batch(uniform)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(spec.run_spec(seqs[-1]), want[-1])
    plain = port.StructuredSpecializedViterbi(level=level, use_kernels=False, device="cpu")
    plain.spec_with(hmm)
    assert plain._fused is None


@pytest.mark.parametrize("name", sorted(MODELS))
def test_both_forms_within_the_oracle(name):
    hmm = MODELS[name]()
    sop, em, pi = _operator(hmm)
    seqs = _seqs(hmm, 11)
    want = [viterbi_scores_oracle(_ref(hmm), s) for s in seqs]
    for level in LEVELS:
        spec = port.StructuredSpecializedViterbi(level=level, device="cpu")
        spec.spec_with(hmm)
        for g, w in zip(spec.run_spec_batch(seqs), want):
            assert port.almost_equal_vec(g, w)
        if fused.fused_eligible(sop):
            spec._fused = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
            for g, w in zip(spec.run_spec_batch(seqs), want):
                np.testing.assert_array_equal(g, w)  # factored = sequential = oracle


def test_struct_cache_round_trip(tmp_path):
    """``store_async`` publishes a ``kind="struct"`` entry that a warm
    ``spec_with`` reads (memory-mapped) with bit-equal scores; the JAX
    package reads the port's entry and the port the JAX package's; an entry
    of a foreign schema under the key is rebuilt."""
    hmm = MODELS["residual"]()
    s = _seqs(hmm, 3)[-1]
    cache = port.OperatorCache(str(tmp_path / "port"))
    cold = port.StructuredSpecializedViterbi(level=2, cache=cache, device="cpu")
    cold.spec_with(hmm)
    cold._store_thread.join(timeout=60)
    assert not cold._store_thread.is_alive()
    entry = cache.load(hmm.fingerprint(), 2, 128, kind="struct")
    assert entry is not None and "l1_offsets" in entry
    assert cache.load(hmm.fingerprint(), 2, 128, kind="dense") is None
    warm = port.StructuredSpecializedViterbi(level=2, cache=cache, device="cpu")
    warm.spec_with(hmm)
    assert warm._store_thread is None  # a hit stores nothing
    assert not warm._arrays_host[0].flags.writeable  # the memmap, not a copy
    np.testing.assert_array_equal(warm.run_spec(s), cold.run_spec(s))
    back = RefSSV(level=2, use_pallas=False, cache=RefCache(str(tmp_path / "port")))
    back.spec_with(_ref(hmm))
    np.testing.assert_array_equal(np.asarray(back.run_spec(s)), cold.run_spec(s))

    ref = RefSSV(level=2, use_pallas=False, cache=RefCache(str(tmp_path / "jax")))
    ref.spec_with(_ref(hmm))
    ref._store_thread.join(timeout=60)
    from_jax = port.StructuredSpecializedViterbi(
        level=2, cache=port.OperatorCache(str(tmp_path / "jax")), device="cpu")
    from_jax.spec_with(hmm)
    assert from_jax._store_thread is None
    np.testing.assert_array_equal(from_jax.run_spec(s), np.asarray(ref.run_spec(s)))

    foreign = port.OperatorCache(str(tmp_path / "foreign"))
    foreign.store(hmm.fingerprint(), 2, 128, {"start_ops": np.zeros((4, 128), np.float32)},
                  kind="struct")
    rebuilt = port.StructuredSpecializedViterbi(level=2, cache=foreign, device="cpu")
    rebuilt.spec_with(hmm)
    rebuilt._store_thread.join(timeout=60)
    assert rebuilt._arrays_host[0].flags.writeable  # built, not loaded
    np.testing.assert_array_equal(rebuilt.run_spec(s), cold.run_spec(s))


def test_store_async_round_trip(tmp_path):
    cache = port.OperatorCache(str(tmp_path))
    arrays = {"l1_offsets": np.array([1, -2], np.int64),
              "dv": np.arange(24, dtype=np.float32).reshape(2, 3, 4)}
    t = cache.store_async("f" * 32, 3, 128, arrays, kind="struct")
    t.join(timeout=60)
    assert not t.is_alive()
    got = cache.load("f" * 32, 3, 128, kind="struct")
    assert sorted(got) == sorted(arrays)
    for k, a in arrays.items():
        assert not got[k].flags.writeable and np.array_equal(got[k], a)
    assert not any(name.endswith(".tmp") for name in os.listdir(tmp_path))
    assert RefCache(str(tmp_path)).load("f" * 32, 3, 128, kind="struct") is not None


def test_respecialization_and_errors():
    profile, residual = MODELS["profile"](), MODELS["residual"]()
    spec = port.StructuredSpecializedViterbi(level=2, device="cpu")
    with pytest.raises(RuntimeError, match="spec_with"):
        spec.run_spec(np.zeros(3, np.int32))
    with pytest.raises(RuntimeError, match="spec_with"):
        spec.run_spec_batch([np.zeros(3, np.int32)])
    with pytest.raises(ValueError, match="level must be >= 1"):
        port.StructuredSpecializedViterbi(level=0, device="cpu")
    spec.spec_with(profile)
    spec.spec_with(residual)  # the second model replaces the first
    fresh = port.StructuredSpecializedViterbi(level=2, device="cpu")
    fresh.spec_with(residual)
    s = _seqs(residual, 4)[-1]
    np.testing.assert_array_equal(spec.run_spec(s), fresh.run_spec(s))
    assert spec.states_num == residual.states_num and spec.emit_num == residual.emit_num
    sop, em, pi = _operator(profile)
    factored = port.StructuredSpecializedViterbi(level=2, device="cpu")
    factored.spec_with(profile)
    factored._fused = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
    for form, model in ((spec, residual), (factored, profile)):
        bad = np.array([0, model.emit_num], dtype=np.int32)
        with pytest.raises(ValueError, match="out of range"):
            form.run_spec(bad)
        with pytest.raises(ValueError, match="out of range"):
            form.run_spec_batch([np.array([0, 1], np.int32), bad])
        with pytest.raises(ValueError, match="empty"):
            form.run_spec_batch([np.zeros(0, np.int32)])
    with pytest.raises(ValueError, match="empty"):
        spec.run_spec(np.zeros(0, np.int32))


def test_spec_memory_bytes_matches_jax():
    for states, emit, level in ((2407, 20, 1), (2407, 20, 3), (40, 4, 2)):
        assert (port.StructuredSpecializedViterbi.spec_memory_bytes(states, emit, level)
                == RefSSV.spec_memory_bytes(states, emit, level))


def test_composed_apply_matches_jax_expression():
    """One chunk of the batched composed decode against the JAX
    ``apply_batch`` expression on the same gathered components."""
    from spec_viterbi_tpu_torch.models import spec_structured

    hmm = MODELS["residual"]()
    spec = port.StructuredSpecializedViterbi(level=2, device="cpu")
    spec.spec_with(hmm)
    dv, uu, ww = (a.numpy() for a in spec.arrays[:3])
    rng = np.random.default_rng(2)
    idx = rng.integers(0, dv.shape[0], size=5)
    v = rng.uniform(0, 9, size=(5, 128)).astype(np.float32)
    v[:, 60:] = np.inf
    got = spec_structured._apply_batch(spec.tuple_offsets, torch.from_numpy(dv[idx]),
                                       torch.from_numpy(uu[idx]), torch.from_numpy(ww[idx]),
                                       torch.from_numpy(v)).numpy()
    vt = jnp.asarray(v.T)
    want = jnp.full(vt.shape, jnp.inf)
    for k, d in enumerate(spec.tuple_offsets):
        want = jnp.minimum(want, jnp.asarray(dv[idx][:, k, :]).T + jnp.roll(vt, d, axis=0))
    dots = jnp.min(jnp.asarray(ww[idx]) + vt.T[:, None, :], axis=2)
    want = jnp.minimum(want, jnp.min(jnp.asarray(uu[idx]) + dots[:, :, None], axis=1).T)
    np.testing.assert_array_equal(got, np.asarray(want).T)
