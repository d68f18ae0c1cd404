"""Streaming decode of the port against whole-sequence decodes, the oracle
and the JAX package's stream engines, on seeded models.

The port's carry is exact f32 in +inf space, so chunked feeds reproduce
the one-shot scores and the oracle's bit for bit, for both engines: the
fused engine (``FusedStructuredDecoder``, here on its plain versions) and
the plain engine (``PlainStreamDecoder``, any operator). The JAX XLA
engine is held equal exactly; the JAX fused engine (Pallas, interpret
mode) gives the same paths and scores within ``almost_equal_vec``.
"""

import numpy as np
import pytest
import torch

from test_torch_host import ref_from_port

from spec_viterbi_tpu.hmm import almost_equal_vec
from spec_viterbi_tpu.models.streaming_xla import XLAStreamDecoder as RefXLAStream
from spec_viterbi_tpu.ops import fused_pallas as ref_fused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator

import spec_viterbi_tpu_torch as port
from spec_viterbi_tpu_torch.hmm import HMM, to_modified_prob_np
from spec_viterbi_tpu_torch.io.generators import (
    generate_profile_hmm,
    generate_random_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.models.streaming_xla import PlainStreamDecoder, XLAStreamDecoder
from spec_viterbi_tpu_torch.ops import fused
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator

torch.set_num_threads(1)

PROFILE = generate_profile_hmm(100, seed=13)
TIE = generate_tie_heavy_hmm(300, seed=2)


def _engines(hmm):
    """Both port stream engines for one model."""
    sop = StructuredOperator.from_hmm(hmm)
    em, pi = hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)
    return {
        "fused": fused.FusedStructuredDecoder(sop, em, pi, device="cpu"),
        "plain": PlainStreamDecoder(sop, em, pi, device="cpu"),
    }


def _block(rng, hmm, t, b, emit=None):
    return rng.integers(0, emit or hmm.emit_num, size=(t, b)).astype(np.int32)


def _feed(eng, block, splits, paths=False):
    state = (eng.stream_begin_path if paths else eng.stream_begin)(block[0])
    pos = 1
    for w in splits:
        state = (eng.stream_feed_path if paths else eng.stream_feed)(state, block[pos : pos + w])
        pos += w
    return state


def _assert_path_oracle(hmm, block, scores, paths, lens=None):
    for i in range(block.shape[1]):
        t = block.shape[0] if lens is None else lens[i]
        want_sc, want_pa = port.viterbi_path_oracle(hmm, block[:t, i])
        np.testing.assert_array_equal(scores[i], want_sc)
        np.testing.assert_array_equal(paths[i, :t], want_pa)


@pytest.mark.parametrize("engine", ["fused", "plain"])
@pytest.mark.parametrize("splits", [[1], [40, 1, 19], [7, 13, 23, 17]])
def test_stream_matches_batch(engine, splits):
    eng = _engines(PROFILE)[engine]
    rng = np.random.default_rng(13)
    block = _block(rng, PROFILE, 1 + sum(splits), 5)
    got = eng.stream_scores(_feed(eng, block, splits))
    seqs = [block[:, i] for i in range(5)]
    dec = port.ViterbiDecoder(PROFILE, mode="structured", device="cpu")
    for g, w, s in zip(got, dec.decode_batch(seqs, bucketed=False), seqs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, port.viterbi_scores_oracle(PROFILE, s))


def test_stream_peek_and_continue():
    """stream_scores mid-stream must not perturb the carry."""
    eng = _engines(TIE)["fused"]
    rng = np.random.default_rng(14)
    block = _block(rng, TIE, 30, 3, emit=TIE.emit_num - 1)
    state = eng.stream_feed(eng.stream_begin(block[0]), block[1:11])
    mid = eng.stream_scores(state)
    for i in range(3):
        np.testing.assert_array_equal(mid[i], port.viterbi_scores_oracle(TIE, block[:11, i]))
    final = eng.stream_scores(eng.stream_feed(state, block[11:]))
    for i in range(3):
        np.testing.assert_array_equal(final[i], port.viterbi_scores_oracle(TIE, block[:, i]))


@pytest.mark.parametrize("engine", ["fused", "plain"])
@pytest.mark.parametrize("splits", [[59], [7, 13, 23, 17]])
def test_stream_path_matches_one_shot_and_oracle(engine, splits):
    """Checkpoint/rematerialize path streaming: exact paths, exact scores,
    and the state is not consumed by finalize."""
    eng = _engines(TIE)[engine]
    rng = np.random.default_rng(21)
    block = _block(rng, TIE, 1 + sum(splits), 3, emit=TIE.emit_num - 1)
    state = _feed(eng, block, splits, paths=True)
    scores, paths = eng.stream_path_finalize(state)
    assert paths.shape == (3, block.shape[0]) and paths.dtype == np.int32
    one_shot = _engines(TIE)["fused"].decode_path_batch([block[:, i] for i in range(3)])
    for i, (sc, pa) in enumerate(one_shot):
        np.testing.assert_array_equal(scores[i], sc)
        np.testing.assert_array_equal(paths[i], pa)
    _assert_path_oracle(TIE, block, scores, paths)
    more = _block(rng, TIE, 5, 3, emit=TIE.emit_num - 1)
    scores2, paths2 = eng.stream_path_finalize(eng.stream_feed_path(state, more))
    _assert_path_oracle(TIE, np.concatenate([block, more]), scores2, paths2)


def test_stream_path_matches_jax_engines():
    """The port's engines against the JAX package's on one model and one
    chunking: the XLA engine exactly, the fused engine (Pallas, interpret
    mode) with equal paths and scores within almost_equal_vec."""
    model = ref_from_port(TIE)
    rng = np.random.default_rng(22)
    block = _block(rng, TIE, 40, 4, emit=TIE.emit_num - 1)
    block[20, 1] = TIE.emit_num - 1  # the dead symbol
    ref_sop = RefOperator.from_hmm(model)
    em, pi = model.emission_matrix(pad_to=ref_sop.n), model.start_vector(pad_to=ref_sop.n)
    ref_xla = RefXLAStream(ref_sop, em, pi)
    ref_pallas = ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)
    splits = [20, 19]
    want_sc, want_pa = ref_xla.stream_path_finalize(_feed(ref_xla, block, splits, paths=True))
    p_sc, p_pa = ref_pallas.stream_path_finalize(_feed(ref_pallas, block, splits, paths=True))
    for eng in _engines(TIE).values():
        got_sc, got_pa = eng.stream_path_finalize(_feed(eng, block, splits, paths=True))
        np.testing.assert_array_equal(got_sc, np.asarray(want_sc))
        np.testing.assert_array_equal(got_pa, want_pa)
        np.testing.assert_array_equal(got_pa, p_pa)
        for g, p in zip(got_sc, np.asarray(p_sc)):
            assert almost_equal_vec(g, p[: TIE.states_num])
    got = _engines(TIE)["plain"].stream_scores(_feed(_engines(TIE)["plain"], block, splits))
    np.testing.assert_array_equal(got, np.asarray(ref_xla.stream_scores(_feed(ref_xla, block, splits))))


@pytest.mark.parametrize("engine", ["fused", "plain"])
def test_stream_path_single_symbol(engine):
    """A begin-only stream: the path is the argmin end state."""
    eng = _engines(TIE)[engine]
    scores, paths = eng.stream_path_finalize(eng.stream_begin_path(np.array([0, 1], np.int32)))
    assert paths.shape == (2, 1)
    _assert_path_oracle(TIE, np.array([[0, 1]], np.int32), scores, paths)


def _ragged_feed(eng, seqs, width, paths=False):
    """Stream ragged lanes through fixed-width chunks with per-lane valid
    counts; returns (scores, paths | None)."""
    lens = [len(s) for s in seqs]
    block = np.zeros((max(lens), len(seqs)), np.int32)  # 0-padded tails
    for i, s in enumerate(seqs):
        block[: len(s), i] = s
    state = (eng.stream_begin_path if paths else eng.stream_begin)(block[0])
    pos = 1
    while pos < block.shape[0]:
        w = min(width, block.shape[0] - pos)
        valid = np.clip([ln - pos for ln in lens], 0, w)
        state = (eng.stream_feed_path if paths else eng.stream_feed)(state, block[pos : pos + w], valid=valid)
        pos += w
    if paths:
        return eng.stream_path_finalize(state)
    return eng.stream_scores(state), None


@pytest.mark.parametrize("engine", ["fused", "plain"])
@pytest.mark.parametrize("width", [8, 16])
def test_ragged_lane_stream_scores(engine, width):
    """Per-lane valid counts: each lane's streamed scores equal its own
    whole-sequence decode (finished lanes freeze mid-chunk)."""
    eng = _engines(PROFILE)[engine]
    rng = np.random.default_rng(31 + width)
    seqs = [rng.integers(0, 20, size=t).astype(np.int32) for t in (31, 17, 44, 2, 1)]
    got, _ = _ragged_feed(eng, seqs, width)
    for g, s in zip(got, seqs):
        np.testing.assert_array_equal(g, port.viterbi_scores_oracle(PROFILE, s))


@pytest.mark.parametrize("engine", ["fused", "plain"])
def test_ragged_lane_stream_paths(engine):
    """Ragged path streaming, sliced to each lane's true length: paths and
    scores equal the oracle's (frozen steps are identity pointers)."""
    eng = _engines(TIE)[engine]
    rng = np.random.default_rng(77)
    seqs = [rng.integers(0, TIE.emit_num - 1, size=t).astype(np.int32) for t in (29, 12, 40, 1)]
    scores, paths = _ragged_feed(eng, seqs, 16, paths=True)
    for i, s in enumerate(seqs):
        want_sc, want_pa = port.viterbi_path_oracle(TIE, s)
        np.testing.assert_array_equal(scores[i], want_sc)
        np.testing.assert_array_equal(paths[i, : len(s)], want_pa)
        assert (paths[i, len(s):] == want_pa[-1]).all()


@pytest.mark.parametrize("width", [8, 13])
def test_planned_arms_stream(width):
    """A plan-eligible model streams through the planned arms (feeds:
    the planned masked scores; finalize: the planned path): ragged lanes
    with per-lane valid counts give the oracle's scores and paths, the
    generic arms' bit for bit, and the JAX XLA stream engine's."""
    eng = _engines(PROFILE)["fused"]
    assert eng._fs_ok and eng._scores_arm is eng._fs and eng._path_arm is eng._fs
    generic = _engines(PROFILE)["fused"]
    generic._scores_arm = generic._path_arm = generic._masked
    rng = np.random.default_rng(width)
    seqs = [rng.integers(0, 20, size=t).astype(np.int32) for t in (31, 17, 44, 2, 1, 26)]
    scores, paths = _ragged_feed(eng, seqs, width, paths=True)
    g_scores, g_paths = _ragged_feed(generic, seqs, width, paths=True)
    np.testing.assert_array_equal(scores, g_scores)
    np.testing.assert_array_equal(paths, g_paths)
    s_scores, _ = _ragged_feed(eng, seqs, width)
    np.testing.assert_array_equal(s_scores, scores)
    for i, s in enumerate(seqs):
        want_sc, want_pa = port.viterbi_path_oracle(PROFILE, s)
        np.testing.assert_array_equal(scores[i], want_sc)
        np.testing.assert_array_equal(paths[i, : len(s)], want_pa)
    model = ref_from_port(PROFILE)
    ref_sop = RefOperator.from_hmm(model)
    ref = RefXLAStream(ref_sop, model.emission_matrix(pad_to=ref_sop.n), model.start_vector(pad_to=ref_sop.n))
    block = _block(rng, PROFILE, 1 + 2 * width, 3)
    want_sc, want_pa = ref.stream_path_finalize(_feed(ref, block, [width, width], paths=True))
    got_sc, got_pa = eng.stream_path_finalize(_feed(eng, block, [width, width], paths=True))
    np.testing.assert_array_equal(got_sc, np.asarray(want_sc))
    np.testing.assert_array_equal(got_pa, want_pa)


@pytest.mark.parametrize("engine", ["fused", "plain"])
def test_stream_validation(engine):
    eng = _engines(PROFILE)[engine]
    state = eng.stream_begin(np.array([0, 1, 2], np.int32))
    chunk = np.zeros((5, 3), np.int32)
    with pytest.raises(ValueError, match="chunk"):
        eng.stream_feed(state, np.zeros((4, 2), np.int32))  # wrong lane count
    with pytest.raises(ValueError, match="out of range"):
        eng.stream_feed(state, np.full((2, 3), 99, np.int32))
    with pytest.raises(ValueError, match="empty"):
        eng.stream_begin(np.array([], np.int32))
    with pytest.raises(ValueError, match="valid"):
        eng.stream_feed(state, chunk, valid=np.array([1, 2], np.int32))
    with pytest.raises(ValueError, match="valid"):
        eng.stream_feed(state, chunk, valid=np.array([1, 6, 2], np.int32))
    assert eng.stream_feed(state, np.zeros((0, 3), np.int32)) is state
    eng.MAX_PATH_BYTES = 1024
    with pytest.raises(ValueError, match="budget"):
        eng.stream_feed_path(eng.stream_begin_path(np.array([0, 1, 2], np.int32)), chunk)


def test_streaming_accessor_picks_and_caches_the_engine():
    """streaming(): the fused engine for fused-eligible models, the plain
    engine for use_kernels=False and for operators the kernels refuse;
    cached; scores equal to the oracle's."""
    heavy = generate_random_hmm(37, trans_per_state=9, emit_range=5, num_non_zero_start_probs=6, seed=7)
    assert XLAStreamDecoder is PlainStreamDecoder
    rng = np.random.default_rng(3)
    for hmm, kernels, kind in (
        (PROFILE, None, fused.FusedStructuredDecoder),
        (PROFILE, False, PlainStreamDecoder),
        (heavy, None, PlainStreamDecoder),
    ):
        dec = port.ViterbiDecoder(hmm, use_kernels=kernels, mode="structured", device="cpu")
        eng = dec.streaming()
        assert type(eng) is kind and eng is dec.streaming()
        assert eng.device == torch.device("cpu")
        block = _block(rng, hmm, 12, 2)
        got = eng.stream_scores(eng.stream_feed(eng.stream_begin(block[0]), block[1:]))
        for i in range(2):
            np.testing.assert_array_equal(got[i], port.viterbi_scores_oracle(hmm, block[:, i]))
    assert not fused.fused_eligible(dec._sop)


def test_plain_engine_full_protocol(tmp_path):
    """The plain engine on an operator the kernels refuse (heavy residual):
    exact paths across chunk boundaries, peek, save/load, and the JAX XLA
    engine's scores and paths."""
    hmm = generate_random_hmm(37, trans_per_state=9, emit_range=5, num_non_zero_start_probs=6, seed=7)
    eng = port.ViterbiDecoder(hmm, mode="structured", device="cpu").streaming()
    assert isinstance(eng, PlainStreamDecoder)
    rng = np.random.default_rng(9)
    block = _block(rng, hmm, 41, 3)
    st = eng.stream_feed_path(eng.stream_begin_path(block[0]), block[1:18])
    mid = eng.stream_path_scores(st)
    st = eng.stream_feed_path(st, block[18:])
    p = str(tmp_path / "plain.npz")
    eng.stream_save(st, p)
    scores, paths = eng.stream_path_finalize(eng.stream_load(p))
    _assert_path_oracle(hmm, block, scores, paths)
    for i in range(3):
        np.testing.assert_array_equal(mid[i], port.viterbi_scores_oracle(hmm, block[:18, i]))
    model = ref_from_port(hmm)
    ref_sop = RefOperator.from_hmm(model)
    ref = RefXLAStream(ref_sop, model.emission_matrix(pad_to=ref_sop.n), model.start_vector(pad_to=ref_sop.n))
    want_sc, want_pa = ref.stream_path_finalize(_feed(ref, block, [17, 23], paths=True))
    np.testing.assert_array_equal(scores, np.asarray(want_sc))
    np.testing.assert_array_equal(paths, want_pa)


@pytest.mark.parametrize("engine", ["fused", "plain"])
def test_stream_save_load_roundtrip(tmp_path, engine):
    """A persisted stream resumes bit for bit (scores and paths)."""
    eng = _engines(TIE)[engine]
    rng = np.random.default_rng(51)
    block = _block(rng, TIE, 25, 2, emit=TIE.emit_num - 1)
    st = eng.stream_feed(eng.stream_begin(block[0]), block[1:11])
    p = str(tmp_path / "scores.npz")
    eng.stream_save(st, p)
    st2 = eng.stream_load(p)
    np.testing.assert_array_equal(
        eng.stream_scores(eng.stream_feed(st, block[11:])),
        eng.stream_scores(eng.stream_feed(st2, block[11:])),
    )
    valid = np.array([10, 4], np.int32)
    stp = eng.stream_feed_path(eng.stream_begin_path(block[0]), block[1:11], valid=valid)
    pp = str(tmp_path / "paths.npz")
    eng.stream_save(stp, pp)
    stp2 = eng.stream_load(pp)
    assert torch.equal(stp2.chunks[0].lengths, stp.chunks[0].lengths)
    scores, paths = eng.stream_path_finalize(stp2)
    _assert_path_oracle(TIE, block[:11], scores, paths, lens=valid + 1)


def _ring(step):
    n = 8
    rows = np.arange(n, dtype=np.int64)
    return HMM(
        states_num=n, emit_num=2, trans_rows=rows, trans_cols=(rows + step) % n,
        trans_probs=to_modified_prob_np(np.full(n, 0.5)),
        emissions=to_modified_prob_np(np.full((2, n), 0.5)),
        start_probabilities_cols=np.array([0], np.int64),
        start_probabilities=to_modified_prob_np(np.array([1.0])),
    )


@pytest.mark.parametrize("engine", ["fused", "plain"])
def test_model_key_waits_for_save_or_load(tmp_path, monkeypatch, engine):
    """Neither the decoder nor its stream engine hashes the model when it is
    built; the first save hashes the same values as before (the numpy
    emissions and π), and a state saved for another model is refused."""
    calls = []
    real = fused.model_key
    monkeypatch.setattr(fused, "model_key", lambda *a: calls.append(a[0]) or real(*a))
    kernels = None if engine == "fused" else False
    decs = [port.ViterbiDecoder(_ring(k), use_kernels=kernels, mode="structured", device="cpu")
            for k in (1, 2)]
    e1, e2 = (dec.streaming() for dec in decs)
    assert type(e1) is {"fused": fused.FusedStructuredDecoder, "plain": PlainStreamDecoder}[engine]
    assert calls == []
    p = str(tmp_path / "state.npz")
    e1.stream_save(e1.stream_begin(np.array([0, 1], np.int32)), p)
    prefix = f"torch-{engine}"
    assert calls == [prefix]
    sop = StructuredOperator.from_hmm(_ring(1))
    em, pi = _ring(1).emission_matrix(pad_to=sop.n), _ring(1).start_vector(pad_to=sop.n)
    assert e1._model_key == real(prefix, sop, em, pi)
    assert e1.stream_load(p).b_real == 2
    with pytest.raises(ValueError, match="different model"):
        e2.stream_load(p)
    assert calls == [prefix, prefix]


def test_stream_load_refuses_foreign_states(tmp_path):
    """stream_load refuses a structurally different model (identical value
    bytes, other diagonal offset), the other engine's state, and states
    saved by the JAX package's engines."""
    e1, e2 = _engines(_ring(1)), _engines(_ring(2))
    assert e1["fused"]._model_key != e2["fused"]._model_key
    first = np.array([0], np.int32)
    saved = {}
    for name, eng in e1.items():
        saved[name] = str(tmp_path / f"{name}.npz")
        eng.stream_save(eng.stream_begin(first), saved[name])
    model = ref_from_port(_ring(1))
    ref_sop = RefOperator.from_hmm(model)
    em, pi = model.emission_matrix(pad_to=ref_sop.n), model.start_vector(pad_to=ref_sop.n)
    for name, ref in (("jax_fused", ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)),
                      ("jax_xla", RefXLAStream(ref_sop, em, pi))):
        saved[name] = str(tmp_path / f"{name}.npz")
        ref.stream_save(ref.stream_begin(first), saved[name])
    for name, eng in e1.items():
        eng.stream_load(saved[name])  # its own state loads
        for other in saved:
            if other != name:
                with pytest.raises(ValueError, match="different model"):
                    eng.stream_load(saved[other])
        with pytest.raises(ValueError, match="different model"):
            e2[name].stream_load(saved[name])
