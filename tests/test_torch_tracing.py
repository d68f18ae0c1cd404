"""The port's spans and its lane-step and dense-work counters, on the CPU.

``decode_auto`` opens ``svt.plan``, then ``svt.build``;
``FusedStructuredDecoder.decode_batch`` and
``decode_path_batch`` open ``svt.stage``, ``svt.launch`` and ``svt.fetch``
(on the CPU the decoder runs its kernels' plain versions), and so does
``ViterbiDecoder.decode_batch`` in dense mode. Every span is a
plain host op of the profiler, never a user annotation, which the profiler
would mirror onto a card's timeline as device activity.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spec_viterbi_tpu_torch.io.generators import (
    generate_plan7_hmm,
    generate_profile_hmm,
    generate_random_hmm,
)
from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder
from spec_viterbi_tpu_torch.ops import fused, tropical
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.scheduler import decode_auto
from spec_viterbi_tpu_torch.utils.batching import bucket_plan
from spec_viterbi_tpu_torch.utils.profiling import span

torch.set_num_threads(1)

# the 12 proteins of the SARS-CoV-2 reference proteome (NC_045512.2), residues
PROTEOME = [7096, 4405, 1273, 419, 275, 222, 121, 121, 75, 61, 43, 38]


def _model(match_states=40, seed=0):
    return generate_profile_hmm(match_states, seed=seed)


def _decoder(hmm):
    sop = StructuredOperator.from_hmm(hmm)
    return fused.FusedStructuredDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device="cpu"
    )


def _seqs(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 20, size=int(t)).astype(np.int32) for t in lengths]


def _ragged():
    """300 lanes in two buckets: 128 × 384 steps and 172 × 64."""
    lengths = [300] * 128 + [20] * 172
    order = np.random.default_rng(1).permutation(len(lengths))
    return _seqs([lengths[i] for i in order])


def _spans(fn):
    """(fn's result, the ``svt.*`` events its profiled run recorded, in
    start order: (name, start_ns, end_ns, event))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e)
              for e in prof.profiler.kineto_results.events() if e.name().startswith("svt.")]
    return out, sorted(events, key=lambda x: x[1])


def _names(events):
    return [name for name, *_ in events]


def _assert_disjoint(events):
    for (_, _, end, _), (_, start, _, _) in zip(events, events[1:]):
        assert end <= start


def test_decode_auto_records_plan_then_build():
    hmm = _model()
    seqs = _seqs([30] * 5)
    out, events = _spans(lambda: decode_auto(hmm, seqs, device="cpu"))
    assert len(out) == 5
    # on the CPU the decoder takes its structured path, which opens no stage
    assert _names(events) == ["svt.plan", "svt.build"]
    _assert_disjoint(events)


def test_ragged_decode_batch_spans():
    fd = _decoder(_model())
    seqs = _ragged()
    plan = bucket_plan([len(s) for s in seqs], lane_block=fused.BB)
    assert [(len(idx), t) for idx, t in plan] == [(128, 384), (172, 64)]
    out, events = _spans(lambda: fd.decode_batch(seqs))
    assert len(out) == len(seqs)
    names = _names(events)
    # the plan, then a staging and a launch a bucket, then one fetch
    assert names == ["svt.stage"] + ["svt.stage", "svt.launch"] * 2 + ["svt.fetch"]
    _assert_disjoint(events)


@pytest.mark.parametrize("case,launches", [("uniform_chunks", 3), ("ragged_buckets", 2)])
def test_decode_path_batch_spans(case, launches):
    fd = _decoder(_model(seed=3))
    if case == "uniform_chunks":
        seqs = _seqs([20] * 300)
        fd.MAX_PATH_BYTES = 19 * fd.n * 2 * fused.BB  # 128 lanes a call: 128, 128, 44
    else:
        seqs = _ragged()
    out, events = _spans(lambda: fd.decode_path_batch(seqs))
    assert len(out) == len(seqs) and all(len(p) == len(s) for (_, p), s in zip(out, seqs))
    names = _names(events)
    # the plan of calls, every call staged before the first launch, one fetch
    assert names == ["svt.stage"] * (1 + launches) + ["svt.launch"] * launches + ["svt.fetch"]
    _assert_disjoint(events)


def test_spans_are_host_ops_not_annotations():
    # a user annotation (``record_function``) is mirrored onto a card's
    # timeline, where a trace reader takes it for device work
    hmm = _model()
    fd = _decoder(hmm)

    def run():
        decode_auto(hmm, _seqs([25] * 4), device="cpu")
        fd.decode_batch(_ragged())
        fd.decode_path_batch(_seqs([12] * 6))

    _, events = _spans(run)
    assert {"svt.plan", "svt.build", "svt.stage", "svt.launch", "svt.fetch"} == set(
        _names(events))
    for *_, e in events:
        assert not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU


def test_span_without_a_profiler_records_and_raises_nothing():
    with span("svt.idle"):
        with span("svt.idle_inner"):
            pass
    with pytest.raises(KeyError, match="inside"):
        with span("svt.idle"):
            raise KeyError("inside")
    # a profiler started afterwards holds none of them
    _, events = _spans(lambda: torch.ones(2) + 1)
    assert events == []


def test_lane_steps_count_the_proteome_padding():
    # 42 copies of the proteome: buckets 128 × 8,192, 128 × 512, 128 × 128
    # and 120 × 64 steps
    fd = _decoder(_model())
    seqs = _seqs(PROTEOME * 42, seed=2)
    plan = bucket_plan([len(s) for s in seqs], lane_block=fused.BB)
    assert [(len(idx), t) for idx, t in plan] == [(128, 8192), (128, 512), (128, 128), (120, 64)]
    fused.reset_launches()
    for idx, t_q in plan:
        fd.prepare([seqs[i] for i in idx], t_pad=t_q)
    launched = 128 * 8191 + 128 * 511 + 128 * 127 + 120 * 63
    real = 42 * sum(t - 1 for t in PROTEOME)
    assert fused.lane_steps == {"launched": launched, "real": real}
    assert (launched, real) == (1_137_672, 593_754)
    assert round(100 * (1 - real / launched), 2) == 47.81
    fused.reset_launches()
    assert fused.lane_steps == {"launched": 0, "real": 0}


def test_lane_steps_of_decodes():
    fd = _decoder(_model())
    fused.reset_launches()
    fd.decode_batch(_seqs([40] * 9))
    assert fused.lane_steps == {"launched": 9 * 39, "real": 9 * 39}  # no padding
    fused.reset_launches()
    seqs = _ragged()
    fd.decode_batch(seqs)
    assert fused.lane_steps == {"launched": 128 * 383 + 172 * 63,
                                "real": 128 * 299 + 172 * 19}
    fused.reset_launches()


def _dense_decoder(length=40):
    """A dense-mode decoder: a Plan7 profile's folded delete chains leave
    too many dense rows for the structured operator."""
    dec = ViterbiDecoder(generate_plan7_hmm(length, seed=1), device="cpu")
    assert dec.mode == "dense"
    return dec


def test_dense_decode_batch_spans():
    dec = _dense_decoder()
    out, events = _spans(lambda: dec.decode_batch(_seqs([30] * 20)))
    assert len(out) == 20
    # the bucket plan (none for uniform lengths), a staging, a launch, a fetch
    assert _names(events) == ["svt.stage"] * 2 + ["svt.launch", "svt.fetch"]
    _assert_disjoint(events)
    seqs = _seqs([200] * 8 + [20] * 24, seed=4)
    plan = bucket_plan([len(s) for s in seqs], lane_block=8)
    assert [(len(idx), t) for idx, t in plan] == [(8, 256), (24, 64)]
    out, events = _spans(lambda: dec.decode_batch(seqs))
    assert [len(v) for v in out] == [dec.states_num] * 32
    assert _names(events) == ["svt.stage"] + ["svt.stage", "svt.launch"] * 2 + ["svt.fetch"]
    _assert_disjoint(events)


def test_dense_decode_auto_spans_are_host_ops():
    hmm = generate_plan7_hmm(40, seed=2)
    out, events = _spans(lambda: decode_auto(hmm, _seqs([25] * 12), device="cpu"))
    assert len(out) == 12
    assert _names(events) == ["svt.plan", "svt.build", "svt.stage", "svt.stage", "svt.launch",
                              "svt.fetch"]
    _assert_disjoint(events)
    for *_, e in events:
        assert not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU


def test_dense_work_reads_the_plan7_fill_share():
    # the benchmark's model: 127,749 finite entries of a 1,024-state operator
    hmm = generate_plan7_hmm(500, seed=3)
    tropical.reset_launches()
    out = decode_auto(hmm, _seqs([6] * 8), device="cpu")
    assert len(out) == 8 and tropical.launches["minplus"] == 0  # plain steps on the CPU
    # 8 lanes take the 64-row tiles: 308 of the 1,024 (tile, 16-k stage) blocks
    assert tropical.dense_work == {"launched": 1024 ** 2 * 8 * 5, "read": 308 * 64 * 16 * 8 * 5,
                                   "real": 127_749 * 8 * 5}
    share = 100 * tropical.dense_work["real"] / tropical.dense_work["launched"]
    assert round(share, 2) == 12.18
    tropical.reset_launches()
    assert tropical.dense_work == {"launched": 0, "read": 0, "real": 0}


def test_dense_work_counts_masked_lanes_as_not_real():
    dec = _dense_decoder()
    assert dec.dev.finite == dec.hmm.trans_num == 1019
    tropical.reset_launches()
    # 5 lanes padded to 8 (three of length 0), 29 steps; a lane is live
    # while a step lies inside its length
    dec.decode_batch(_seqs([30, 12, 1, 25, 30]), bucketed=False)
    assert tropical.dense_work == {"launched": 128 ** 2 * 8 * 29, "read": 10 * 64 * 16 * 8 * 29,
                                   "real": 1019 * (29 + 11 + 0 + 24 + 29)}
    # the structured operator's plain loop and the fused decoder count nothing
    tropical.reset_launches()
    ViterbiDecoder(_model(), device="cpu").decode_batch(_seqs([30] * 4))
    _decoder(_model()).decode_batch(_seqs([30] * 4))
    assert tropical.dense_work == {"launched": 0, "read": 0, "real": 0}


@pytest.mark.parametrize("lanes", [1, 8, 200])
def test_dense_work_counts_the_blocks_a_step_reads(lanes):
    """``read``: the entries of the blocks the step's launch reads, the
    block list's where the decoder has one (10 of the 16 (64-row, 16-k)
    blocks of the 128-state Plan7 operator at L = 40), at one lane too,
    which pads to 8 lanes; the fully populated operator of a random dense
    model gets no list and reads n_pad² a lane."""
    dec = _dense_decoder()
    assert dec.dev.blocks.listed == 10
    tropical.reset_launches()
    dec.decode_batch(_seqs([7] * lanes), bucketed=False)
    padded = max(8, lanes)
    assert tropical.dense_work["launched"] == 128 ** 2 * padded * 6
    assert tropical.dense_work["read"] == 10 * 64 * 16 * padded * 6
    dense = ViterbiDecoder(generate_random_hmm(128, trans_per_state=128, seed=4), mode="dense",
                           device="cpu")
    assert dense.dev.blocks is None
    tropical.reset_launches()
    dense.decode_batch(_seqs([7] * lanes), bucketed=False)
    assert tropical.dense_work["read"] == tropical.dense_work["launched"] == 128 ** 2 * padded * 6
