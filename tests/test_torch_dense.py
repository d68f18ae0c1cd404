"""Dense mode of the port's ``ViterbiDecoder`` against the JAX package's
dense decoder (XLA on the CPU) and the numpy oracles, bit for bit.

Each step forms the oracle's candidates ``a_t[i, j] + v[j]`` and takes
their exact min, so every dense entry point must give the same bits as
``viterbi_scores_oracle``/``viterbi_path_oracle`` (paths with the lowest
source on a tie, as ``np.argmin`` takes it), whatever the batching.
"""

import numpy as np
import pytest
import torch

import spec_viterbi_tpu.hmm as ref_hmm
from spec_viterbi_tpu.models.decoder import DeviceHMM as RefDeviceHMM
from spec_viterbi_tpu.models.decoder import ViterbiDecoder as RefDecoder
from spec_viterbi_tpu.models.oracle import viterbi_path_oracle, viterbi_scores_oracle

import spec_viterbi_tpu_torch as port
from spec_viterbi_tpu_torch.io import (
    generate_profile_hmm,
    generate_random_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.models.streaming_xla import PlainStreamDecoder
from spec_viterbi_tpu_torch.ops import tropical

torch.set_num_threads(1)

FIELDS = ("states_num", "emit_num", "trans_rows", "trans_cols", "trans_probs", "emissions",
          "start_probabilities_cols", "start_probabilities")


def _ref(hmm):
    return ref_hmm.HMM(**{f: getattr(hmm, f) for f in FIELDS})


MODELS = {
    "dense_class": lambda: generate_random_hmm(40, trans_per_state=20, emit_range=4, seed=1),
    "tie_heavy": lambda: generate_tie_heavy_hmm(60, seed=2),
    "profile": lambda: generate_profile_hmm(30, seed=3),
}


def _seqs(hmm, seed, count=20, t_max=60):
    """A ragged set: lengths 1..t_max with 1 and 2 present; more than 8
    lanes, so the dense decoder's bucket plan (8-lane blocks) cuts it."""
    rng = np.random.default_rng(seed)
    lengths = [1, 2] + [int(t) for t in rng.integers(3, t_max, size=count - 2)]
    return [rng.integers(0, hmm.emit_num, size=t).astype(np.int32) for t in lengths]


@pytest.fixture(params=sorted(MODELS))
def case(request):
    hmm = MODELS[request.param]()
    return (hmm, _ref(hmm), port.ViterbiDecoder(hmm, mode="dense", device="cpu"),
            RefDecoder(_ref(hmm), mode="dense"))


def test_device_hmm_matches_jax():
    hmm = generate_random_hmm(70, trans_per_state=5, emit_range=6, seed=4)
    for dense in (True, False):
        got = port.DeviceHMM.from_hmm(hmm, dense=dense, device="cpu")
        want = RefDeviceHMM.from_hmm(_ref(hmm), dense=dense)
        assert (got.states_num, got.padded) == (want.states_num, want.padded) == (70, 128)
        for f in ("a_t", "a", "pi", "emissions"):
            x, y = getattr(got, f), getattr(want, f)
            assert (x is None) == (y is None) == (not dense and f in ("a_t", "a")), f
            if x is not None:
                assert x.dtype == torch.float32 and x.device.type == "cpu"
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_dense_scores_match_jax_and_oracle(case):
    hmm, ref, dec, ref_dec = case
    assert dec.mode == ref_dec.mode == "dense"
    seqs = _seqs(hmm, hmm.states_num)
    for s in seqs[:4]:
        got = dec.decode(s)
        np.testing.assert_array_equal(got, np.asarray(ref_dec.decode(s)))
        np.testing.assert_array_equal(got, viterbi_scores_oracle(ref, s))
    tropical.reset_launches()
    for bucketed in (True, False):
        got = dec.decode_batch(seqs, bucketed=bucketed)
        want = ref_dec.decode_batch(seqs, bucketed=bucketed)
        assert len(got) == len(want) == len(seqs)
        for g, w, s in zip(got, want, seqs):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, viterbi_scores_oracle(ref, s))
    assert tropical.launches == {"minplus": 0}


def test_dense_prepare_and_run_batch_match_jax(case):
    hmm, _, dec, ref_dec = case
    seqs = _seqs(hmm, 7, count=5, t_max=30)
    for t_pad in (None, 48):
        out = dec.run_batch(dec.prepare_batch(seqs, t_pad=t_pad))
        want = np.asarray(ref_dec.run_batch(ref_dec.prepare_batch(seqs, t_pad=t_pad)))
        assert isinstance(out, torch.Tensor) and out.shape == want.shape == (8, dec.dev.padded)
        np.testing.assert_array_equal(out.numpy(), want)


def test_dense_paths_match_jax_and_oracle(case):
    hmm, ref, dec, ref_dec = case
    seqs = _seqs(hmm, 11, count=6, t_max=40)
    got = dec.decode_path_batch(seqs)
    for (sc, p), s in zip(got, seqs):
        rsc, rp = ref_dec.decode_path(s)
        osc, op = viterbi_path_oracle(ref, s)
        assert p.dtype == np.int32 and p.shape == (len(s),)
        np.testing.assert_array_equal(sc, np.asarray(rsc))
        np.testing.assert_array_equal(p, np.asarray(rp))
        np.testing.assert_array_equal(sc, osc)
        np.testing.assert_array_equal(p, op)
    sc, p = dec.decode_path(seqs[3])
    np.testing.assert_array_equal(p, got[3][1])


def test_auto_resolves_like_jax():
    for hmm, want in ((generate_profile_hmm(40, seed=5), "structured"),
                      (generate_random_hmm(40, trans_per_state=20, emit_range=4, seed=1), "dense")):
        dec = port.ViterbiDecoder(hmm, mode="auto", device="cpu")
        ref_dec = RefDecoder(_ref(hmm), mode="auto")
        assert dec.mode == ref_dec.mode == want
        assert (dec.dev.a is None) == (want == "structured")
        # on the CPU a structured decoder holds the plain engine and no other
        assert dec._fused is None and (dec._plain is None) == (want == "dense")
        s = _seqs(hmm, 3, count=3)[2]
        np.testing.assert_array_equal(dec.decode(s), np.asarray(ref_dec.decode(s)))


def test_dense_streaming_is_the_plain_engine():
    """``streaming()`` on a dense decoder builds the decomposition on demand
    and hands out the plain engine, even for a fused-eligible operator (the
    JAX decoder, whose dense mode has no operator, takes its XLA engine)."""
    for hmm in (generate_random_hmm(40, trans_per_state=20, emit_range=4, seed=1),
                generate_profile_hmm(30, seed=3)):
        dec = port.ViterbiDecoder(hmm, mode="dense", device="cpu")
        eng = dec.streaming()
        assert type(eng) is PlainStreamDecoder and dec.streaming() is eng
        ref_eng = RefDecoder(_ref(hmm), mode="dense").streaming()
        assert type(ref_eng).__name__ == "XLAStreamDecoder"
        rng = np.random.default_rng(8)
        block = rng.integers(0, hmm.emit_num, size=(25, 3)).astype(np.int32)
        states = [e.stream_begin(block[0]) for e in (eng, ref_eng)]
        for lo, hi in ((1, 10), (10, 25)):
            states = [e.stream_feed(st, block[lo:hi]) for e, st in zip((eng, ref_eng), states)]
        got, want = (np.asarray(e.stream_scores(st)) for e, st in zip((eng, ref_eng), states))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, : hmm.states_num],
                                      np.stack(dec.decode_batch(list(block.T))))


def test_dense_mode_checks_inputs():
    hmm = generate_random_hmm(30, trans_per_state=25, seed=2)
    with pytest.raises(ValueError, match="mode"):
        port.ViterbiDecoder(hmm, mode="fast", device="cpu")
    dec = port.ViterbiDecoder(hmm, mode="dense", device="cpu")
    bad = np.array([0, hmm.emit_num, 1], dtype=np.int32)
    good = np.array([0, 1], dtype=np.int32)
    for call in (lambda: dec.decode(bad), lambda: dec.decode_batch([good, bad]),
                 lambda: dec.decode_path(bad), lambda: dec.decode_path_batch([bad]),
                 lambda: dec.prepare_batch([bad])):
        with pytest.raises(ValueError, match="out of range"):
            call()
    for call in (lambda: dec.decode([]), lambda: dec.decode_path([])):
        with pytest.raises(ValueError, match="empty"):
            call()


@pytest.mark.parametrize("seed", [12, 13])
def test_dense_ragged_tie_heavy_matches_jax_and_oracle(seed):
    """The one-launch step on the tie-heavy model: ragged ``decode_batch``
    (bucketed and whole, so lanes freeze at every length and padded lanes
    of length 0 ride along), ``run_batch`` with its padded lanes, and
    ``decode_path`` bit-equal to the JAX decoder and to the oracles."""
    hmm = generate_tie_heavy_hmm(45, seed=seed)
    ref = _ref(hmm)
    dec = port.ViterbiDecoder(hmm, mode="dense", device="cpu")
    ref_dec = RefDecoder(ref, mode="dense")
    seqs = _seqs(hmm, seed, count=13, t_max=50)
    for bucketed in (True, False):
        for g, w, s in zip(dec.decode_batch(seqs, bucketed=bucketed),
                           ref_dec.decode_batch(seqs, bucketed=bucketed), seqs):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, viterbi_scores_oracle(ref, s))
    out = dec.run_batch(dec.prepare_batch(seqs[:5]))  # 3 padded lanes of length 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_dec.run_batch(ref_dec.prepare_batch(seqs[:5]))))
    for s in seqs[:4]:
        sc, p = dec.decode_path(s)
        rsc, rp = ref_dec.decode_path(s)
        osc, op = viterbi_path_oracle(ref, s)
        np.testing.assert_array_equal(sc, np.asarray(rsc))
        np.testing.assert_array_equal(p, np.asarray(rp))
        np.testing.assert_array_equal(sc, osc)
        np.testing.assert_array_equal(p, op)


def test_dense_loops_take_one_step_call_a_step(monkeypatch):
    """Each dense loop calls its step entry once a step, from one carry of
    a ping-pong pair into the other (no carry allocated in the loop), and
    ``decode_path``'s step writes its pointers into the rows of one
    preallocated tensor."""
    hmm = generate_random_hmm(30, trans_per_state=20, emit_range=4, seed=6)
    dec = port.ViterbiDecoder(hmm, mode="dense", device="cpu")
    calls = {"dense_step": [], "dense_step_mv": []}
    for name in calls:
        real = getattr(tropical, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name].append(args)
            return _real(*args, **kw)

        monkeypatch.setattr(tropical, name, spy)
    seqs = _seqs(hmm, 6, count=5, t_max=30)
    t_len = max(map(len, seqs))
    dec.run_batch(dec.prepare_batch(seqs))
    steps = calls["dense_step"]
    assert len(steps) == t_len - 1
    assert [c[5] for c in steps] == list(range(1, t_len))
    carries = {c[1].data_ptr() for c in steps} | {c[6].data_ptr() for c in steps}
    assert len(carries) == 2 and all(c[1].data_ptr() != c[6].data_ptr() for c in steps)
    s = seqs[2]
    dec.decode(s)
    dec.decode_path(s)
    mv = calls["dense_step_mv"]
    assert len(mv) == 2 * (len(s) - 1)
    assert len({c[1].data_ptr() for c in mv[: len(s) - 1]}) == 2
    rows = [c[5] for c in mv[len(s) - 1 :]]
    assert all(r.shape == (hmm.states_num + (-hmm.states_num) % 128,) for r in rows)
    assert [r.data_ptr() - rows[0].data_ptr() for r in rows] == [
        t * rows[0].numel() * 4 for t in range(len(s) - 1)]
