"""The port's halo TP and DP of coupled structured operators against the
JAX package.

Seeded models (a 102-state profile model: one dense row, two dense
columns, the +1 diagonal; a tie-heavy model with residual entries; banded
models with negative and several offsets; a model with a self-loop
diagonal) go through the port's ``decode_batch_structured_tp`` and
``decode_batch_structured_dp`` on local groups on the CPU and through the
JAX functions on the virtual 8-device CPU mesh (XLA, no Pallas). Scores
are bit-equal to the JAX functions and to the port's unsharded structured
decoders (the plain loop and the fused decoder's plain versions).
"""

import numpy as np
import pytest
import torch

from test_torch_host import ref_from_port

from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.parallel import make_mesh
from spec_viterbi_tpu.parallel import structured_tp as ref_stp

from spec_viterbi_tpu_torch import ViterbiDecoder, viterbi_scores_oracle
from spec_viterbi_tpu_torch.hmm import HMM, to_modified_prob_np
from spec_viterbi_tpu_torch.io.generators import (
    generate_banded_hmm,
    generate_profile_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder, fused_eligible
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.parallel import (
    DATA_AXIS,
    decode_batch_structured_dp,
    decode_batch_structured_tp,
    make_group,
    make_structured_dp_decode,
    make_structured_tp_decode,
    structured_tp_supported,
)

torch.set_num_threads(1)

LENGTHS = (1, 9, 40, 37, 64, 129, 2)


def _self_loop_hmm():
    """The model of ``tests/test_structured_tp.py::test_structured_tp_self_loop_diagonal``:
    a dense fan-out row 0 and a self-loop on every state from 2 on."""
    rng = np.random.default_rng(17)
    states = 48
    rows = [0] * states + list(range(2, states))
    cols = list(range(states)) + list(range(2, states))
    probs = rng.uniform(0.1, 1.0, size=len(rows))
    return HMM(
        states_num=states,
        emit_num=4,
        trans_rows=np.asarray(rows, dtype=np.int64),
        trans_cols=np.asarray(cols, dtype=np.int64),
        trans_probs=to_modified_prob_np(probs),
        emissions=to_modified_prob_np(rng.uniform(0.1, 1.0, size=(4, states))),
        start_probabilities_cols=np.array([0], dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.array([1.0])),
    )


MODELS = {
    "profile": lambda: generate_profile_hmm(100, seed=11),
    "tie_heavy": lambda: generate_tie_heavy_hmm(120, seed=3),
    "banded_neg": lambda: generate_banded_hmm(256, (-3,), 4, seed=5),
    "banded_two": lambda: generate_banded_hmm(256, (-1, 2), 4, seed=6),
    "self_loop": _self_loop_hmm,
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    hmm = MODELS[request.param]()
    return request.param, hmm, ref_from_port(hmm)


def _seqs(hmm, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32) for t in lengths]


def _unsharded(hmm, seqs):
    """The port's unsharded structured scores: the plain loop, and the
    fused decoder (its plain versions on the CPU) where the operator is
    eligible; the two must agree."""
    want = ViterbiDecoder(hmm, mode="structured", device="cpu").decode_batch(seqs, bucketed=False)
    sop = StructuredOperator.from_hmm(hmm)
    if fused_eligible(sop):
        fd = FusedStructuredDecoder(sop, hmm.emission_matrix(pad_to=sop.n),
                                    hmm.start_vector(pad_to=sop.n), device="cpu")
        for w, f in zip(want, fd.decode_batch(seqs, bucketed=False)):
            assert np.array_equal(w, f)
    return want


def _bit_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), i


def test_supported_matches_jax():
    """``structured_tp_supported`` equals the JAX function over shards 1-16
    on operators with offsets from -9 to 9 and the self-loop diagonal."""
    hmms = [f() for f in MODELS.values()] + [
        generate_banded_hmm(240, offs, 3, seed=1) for offs in ((9,), (-9, 1), (0, 4), (-5, 5))]
    for hmm in hmms:
        sop = StructuredOperator.from_hmm(hmm)
        ref = RefOperator.from_hmm(ref_from_port(hmm))
        assert sop.diag_offsets == ref.diag_offsets
        for shards in range(1, 17):
            assert structured_tp_supported(sop, shards) == ref_stp.structured_tp_supported(ref, shards), (
                sop.diag_offsets, shards)
    assert not structured_tp_supported(StructuredOperator.from_hmm(hmms[-1]), 128)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_structured_tp_matches_jax_and_unsharded(model, shards):
    name, hmm, ref = model
    assert structured_tp_supported(StructuredOperator.from_hmm(hmm), shards), name
    seqs = _seqs(hmm, LENGTHS, shards)
    got = decode_batch_structured_tp(hmm, seqs, make_group("cpu", shards))
    _bit_equal(got, ref_stp.decode_batch_structured_tp(ref, seqs, make_mesh(state=shards)))
    _bit_equal(got, _unsharded(hmm, seqs))


def test_structured_tp_self_loop_diagonal_matches_oracle():
    """d == 0 (self-loop) diagonals need no halo and are supported."""
    hmm = _self_loop_hmm()
    sop = StructuredOperator.from_hmm(hmm)
    assert 0 in sop.diag_offsets and structured_tp_supported(sop, 4)
    seqs = _seqs(hmm, (3, 21), 17)
    for g, s in zip(decode_batch_structured_tp(hmm, seqs, make_group("cpu", 4)), seqs):
        assert np.array_equal(g, viterbi_scores_oracle(hmm, s))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_structured_dp_matches_jax_and_unsharded(model, shards):
    _, hmm, ref = model
    seqs = _seqs(hmm, LENGTHS, 40 + shards)
    got = decode_batch_structured_dp(hmm, seqs, make_group("cpu", shards, axis=DATA_AXIS))
    _bit_equal(got, ref_stp.decode_batch_structured_dp(ref, seqs, make_mesh(data=shards)))
    _bit_equal(got, _unsharded(hmm, seqs))


def test_make_functions_take_whole_model_tensors():
    """The two ``make_*`` functions: whole-model tensors in, [B, Np] out,
    the JAX argument order; the groups' axes are checked."""
    hmm = generate_profile_hmm(60, seed=2)
    sop = StructuredOperator.from_hmm(hmm)
    n = sop.n
    seqs = _seqs(hmm, (5, 12, 9, 7), 1)
    batch = np.zeros((12, 8), np.int32)
    lengths = np.zeros(8, np.int32)
    for i, s in enumerate(seqs):
        batch[: len(s), i], lengths[i] = s, len(s)
    em_t = torch.as_tensor(np.ascontiguousarray(hmm.emission_matrix(pad_to=n).T))
    pi = torch.as_tensor(hmm.start_vector(pad_to=n))
    st, ln = torch.as_tensor(batch), torch.as_tensor(lengths)
    want = _unsharded(hmm, seqs)
    tp = make_structured_tp_decode(sop, make_group("cpu", 4))
    out = tp(torch.as_tensor(sop.diag_vals), torch.as_tensor(sop.row_vals),
             torch.as_tensor(sop.col_vals), torch.zeros((1, 1)), em_t, pi, st, ln)
    assert tuple(out.shape) == (8, n)
    _bit_equal(out[:4, : hmm.states_num].numpy(), want)
    dp = make_structured_dp_decode(sop, make_group("cpu", 2, axis=DATA_AXIS))
    _bit_equal(dp(em_t, pi, st, ln)[:4, : hmm.states_num].numpy(), want)
    with pytest.raises(ValueError, match="'state' axis"):
        make_structured_tp_decode(sop, make_group("cpu", 2, axis=DATA_AXIS))
    with pytest.raises(ValueError, match="'data' axis"):
        make_structured_dp_decode(sop, make_group("cpu", 2))
    with pytest.raises(ValueError, match="block size"):  # 256 states, block 8, offset 9
        make_structured_tp_decode(StructuredOperator.from_hmm(generate_banded_hmm(240, (9,), 3, seed=1)),
                                  make_group("cpu", 32))
    assert decode_batch_structured_tp(hmm, [], make_group("cpu", 2)) == []
