"""One staging function for every engine, on the CPU: ``fused.stage_batch``
in the fused layout and in the padded layout of the dense and plain
``ViterbiDecoder.prepare_batch``, held bit for bit against frozen copies of
the staging they replaced (``validate_obs_seq`` a sequence, then the flat
upload and ``min(off + t, last)`` gather; or ``pad_batch`` and a host
transpose), with the same refusals and the same counts. No jax import.
"""

import numpy as np
import pytest
import torch

from spec_viterbi_tpu_torch.hmm import validate_obs_seq
from spec_viterbi_tpu_torch.io.generators import generate_plan7_hmm, generate_profile_hmm
from spec_viterbi_tpu_torch.models.decoder import SUBLANE, ViterbiDecoder
from spec_viterbi_tpu_torch.ops import fused, tropical
from spec_viterbi_tpu_torch.utils.batching import pad_batch

torch.set_num_threads(1)

EMIT = 20


def old_stage_batch(seqs, emit_num, t_pad=None):
    """The fused engines' staging before the one-pass packing: a check a
    sequence, then the flat symbols, ``off`` and ``last`` uploaded and
    expanded through an int64 index."""
    seqs = [validate_obs_seq(s, emit_num) for s in seqs]
    if any(len(s) == 0 for s in seqs):
        raise ValueError("cannot decode an empty sequence")
    t_min = max(2, t_pad or 2)
    b = len(seqs)
    t_total = max(t_min, max(len(s) for s in seqs))
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    off = np.zeros(b, dtype=np.int64)
    np.cumsum(lengths[: b - 1], out=off[1:])
    last = off + lengths - 1
    flat = torch.as_tensor(np.concatenate(seqs))
    t_iota = torch.arange(t_total, dtype=torch.int64)[:, None]
    idx = torch.minimum(torch.as_tensor(off)[None, :] + t_iota, torch.as_tensor(last)[None, :])
    masked = len({len(s) for s in seqs}) > 1 or max(len(s) for s in seqs) < t_min
    return flat[idx], torch.as_tensor(lengths), masked


def old_prepare_padded(seqs, emit_num, t_pad=None):
    """The dense and plain engines' staging before: a check a sequence,
    ``pad_batch`` to ``SUBLANE`` lanes and a host transpose."""
    seqs = [validate_obs_seq(s, emit_num) for s in seqs]
    batch, lengths = pad_batch(seqs, SUBLANE, t_pad=t_pad)
    return torch.as_tensor(batch.T.copy()), torch.as_tensor(lengths)


def _seqs(lengths, seed=0, emit=EMIT):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, emit, size=int(t)).astype(np.int32) for t in lengths]


# (lengths, t_pad): uniform, ragged, a t_pad overshoot on each, length-1
# lanes, one lane, lane counts off the multiple of 8
CASES = {
    "uniform": ([30] * 16, None),
    "uniform_t_pad": ([30] * 16, 48),
    "uniform_t_pad_equal": ([30] * 16, 30),
    "ragged": ([3, 30, 17, 1, 44, 2, 9, 30, 12, 5], None),
    "ragged_t_pad": ([3, 30, 17, 1, 44, 2, 9], 64),
    "length_one_lanes": ([1] * 5, None),
    "length_one_and_two": ([1, 2, 1], None),
    "one_lane": ([37], None),
    "one_lane_of_one": ([1], None),
    "thirteen_lanes": ([25] * 13, None),
    "thirteen_ragged": ([25, 3, 1, 8] * 3 + [40], None),
}


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous()
            assert torch.equal(g, w)
        else:
            assert g is w


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_layout_equals_the_old_staging(case):
    lengths, t_pad = CASES[case]
    seqs = _seqs(lengths)
    _assert_same(fused.stage_batch(seqs, EMIT, "cpu", t_pad), old_stage_batch(seqs, EMIT, t_pad))


@pytest.mark.parametrize("case", sorted(CASES))
def test_padded_layout_equals_pad_batch_transposed(case):
    lengths, t_pad = CASES[case]
    seqs = _seqs(lengths)
    got = fused.stage_batch(seqs, EMIT, "cpu", t_pad, lane_multiple=SUBLANE)
    want = old_prepare_padded(seqs, EMIT, t_pad)
    _assert_same(got[:2], want)
    assert got[2] is (len(set(lengths)) > 1 or max(lengths) != (t_pad or max(lengths)))


@pytest.mark.parametrize("case", ["uniform", "ragged", "ragged_t_pad", "thirteen_ragged"])
@pytest.mark.parametrize("min_bytes", [1, 600, 4096])
def test_padded_layout_in_lane_chunks(monkeypatch, case, min_bytes):
    """The padded layout laid out through one scratch in lane chunks of
    every size, from a lane a chunk up, gives the same handle."""
    monkeypatch.setattr(fused, "CHUNK_MIN_BYTES", min_bytes)
    lengths, t_pad = CASES[case]
    seqs = _seqs(lengths, seed=3)
    got = fused.stage_batch(seqs, EMIT, "cpu", t_pad, lane_multiple=SUBLANE)
    _assert_same(got[:2], old_prepare_padded(seqs, EMIT, t_pad))


@pytest.mark.parametrize("lanes,t", [(512, 2100), (64, 2000)])
@pytest.mark.parametrize("ragged", [False, True])
def test_padded_layout_at_quarter_chunks(lanes, t, ragged):
    """At sizes past the chunk floor, the quarter-batch chunks (four for a
    uniform batch, more where the chunk is gathered) give the same
    handle."""
    rng = np.random.default_rng(lanes)
    lengths = rng.integers(1, t + 1, size=lanes) if ragged else [t] * lanes
    seqs = _seqs(lengths, seed=5)
    got = fused.stage_batch(seqs, EMIT, "cpu", None, lane_multiple=SUBLANE)
    _assert_same(got[:2], old_prepare_padded(seqs, EMIT))


def _dense():
    dec = ViterbiDecoder(generate_plan7_hmm(40, seed=1), device="cpu")
    assert dec.mode == "dense"
    return dec


def _plain():
    dec = ViterbiDecoder(generate_profile_hmm(30, seed=2), mode="structured", device="cpu")
    assert dec._fused is None and dec._plain is not None
    return dec


@pytest.mark.parametrize("engine", ["dense", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_batch_equals_the_old_staging(engine, case):
    dec = _dense() if engine == "dense" else _plain()
    lengths, t_pad = CASES[case]
    seqs = _seqs(lengths, emit=dec.hmm.emit_num)
    _assert_same(dec.prepare_batch(seqs, t_pad=t_pad), old_prepare_padded(seqs, dec.hmm.emit_num, t_pad))


def _cast_inputs():
    """Each input beside the int32 arrays it stands for, through
    ``np.asarray(seq, dtype=np.int32)``'s casts."""
    base = _seqs([7, 3, 12, 1])
    return {
        "int64": [s.astype(np.int64) for s in base],
        "uint8": [s.astype(np.uint8) for s in base],
        "list": [s.tolist() for s in base],
        "tuple": [tuple(s.tolist()) for s in base],
        "float64": [s.astype(np.float64) + 0.75 for s in base],
        "int64_wrapping": [s.astype(np.int64) + (1 << 32) for s in base],
        "strided": [np.repeat(s, 2)[::2] for s in base],
        "scalars": [np.int32(3), 7, base[0]],
        "mixed": [base[0].astype(np.int16), base[1].tolist(), base[2], base[3].astype(np.uint64)],
    }


@pytest.mark.parametrize("kind", sorted(_cast_inputs()))
@pytest.mark.parametrize("padded", [False, True])
def test_inputs_cast_as_asarray_casts(kind, padded):
    seqs = _cast_inputs()[kind]
    multiple = SUBLANE if padded else None
    got = fused.stage_batch(seqs, EMIT, "cpu", None, lane_multiple=multiple)
    want = fused.stage_batch([np.asarray(s, dtype=np.int32) for s in seqs], EMIT, "cpu", None,
                             lane_multiple=multiple)
    _assert_same(got, want)
    old = old_prepare_padded(seqs, EMIT) if padded else old_stage_batch(seqs, EMIT)
    _assert_same(got[:2] if padded else got, old)


def _refusals():
    good = _seqs([6, 4])
    return {
        "empty_alone": [np.zeros(0, np.int32)],
        "empty_among": [good[0], np.zeros(0, np.int32), good[1]],
        "empty_list": [good[0], []],
        "two_d": [good[0], np.zeros((2, 3), np.int32)],
        "negative": [good[0], np.array([1, -4, 2], np.int32)],
        "too_large": [good[0], np.array([1, EMIT, 2], np.int32), np.array([EMIT + 5], np.int32)],
        "negative_int64": [np.array([0, -(1 << 40) - 1], np.int64)],
        "negative_then_large": [np.array([EMIT + 1], np.int32), np.array([-1], np.int32)],
        "range_before_two_d": [np.array([EMIT + 2], np.int32), np.zeros((2, 2), np.int32)],
        "range_before_empty": [np.zeros(0, np.int32), np.array([EMIT], np.int32)],
        "uint8_too_large": [np.array([0, 255], np.uint8)],
    }


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type and text are what is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("kind", sorted(_refusals()))
@pytest.mark.parametrize("padded", [False, True])
def test_refusals_match_the_old_staging(kind, padded):
    seqs = _refusals()[kind]
    multiple = SUBLANE if padded else None
    got = _error(lambda: fused.stage_batch(seqs, EMIT, "cpu", None, lane_multiple=multiple))
    want = _error(lambda: (old_prepare_padded if padded else old_stage_batch)(seqs, EMIT))
    assert want is not None and got == want
    assert got[0] is ValueError


def test_padded_layout_refuses_a_t_pad_below_the_longest():
    seqs = _seqs([10, 30])
    want = _error(lambda: old_prepare_padded(seqs, EMIT, t_pad=20))
    assert want == (ValueError, "t_pad=20 below the batch max length")
    assert _error(lambda: fused.stage_batch(seqs, EMIT, "cpu", 20, lane_multiple=SUBLANE)) == want
    assert _error(lambda: _dense().prepare_batch(seqs, t_pad=20)) == want
    # the fused layout runs such a batch at its own length, as before
    _assert_same(fused.stage_batch(seqs, EMIT, "cpu", 20), old_stage_batch(seqs, EMIT, 20))


def test_an_empty_batch_is_refused():
    for multiple in (None, SUBLANE):
        with pytest.raises(ValueError):
            fused.stage_batch([], EMIT, "cpu", None, lane_multiple=multiple)


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_match_hand_counts(case):
    """``lane_steps`` (the fused layout only), ``staging`` (every staging:
    the packed buffer's bytes, ``[lengths (lanes) | symbols]`` int32; none
    pinned on the CPU) and the dense decoder's ``dense_work``."""
    lengths, t_pad = CASES[case]
    seqs = _seqs(lengths)
    b, total = len(lengths), sum(lengths)
    t_fused = max(2, t_pad or 2, max(lengths))
    fused.reset_launches()
    fused.stage_batch(seqs, EMIT, "cpu", t_pad)
    assert fused.lane_steps == {"launched": b * (t_fused - 1), "real": total - b}
    assert fused.staging == {"batches": 1, "pinned": 0, "bytes": 4 * (b + total)}
    dec = _dense()
    fused.reset_launches()
    tropical.reset_launches()
    dec.prepare_batch(seqs, t_pad=t_pad)
    lanes = -(-b // SUBLANE) * SUBLANE
    t_dense = t_pad or max(lengths)
    assert fused.lane_steps == {"launched": 0, "real": 0}
    assert fused.staging == {"batches": 1, "pinned": 0, "bytes": 4 * (lanes + total)}
    n = dec.dev.padded
    assert tropical.dense_work == {
        "launched": n * n * lanes * (t_dense - 1),
        "read": dec.dev.blocks.listed * tropical.LIST_ROWS * tropical.STAGE_K * lanes * (t_dense - 1),
        "real": dec.dev.finite * (total - b),
    }
    _plain().prepare_batch(seqs, t_pad=t_pad)
    assert fused.staging["batches"] == 2
    fused.reset_launches()
    tropical.reset_launches()
    assert fused.staging == {"batches": 0, "pinned": 0, "bytes": 0}
