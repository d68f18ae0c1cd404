"""The fused scores path of the port against the JAX package.

On the CPU, ``scores_masked`` and ``scores_fs`` run their plain torch
versions (the kernels themselves are tested on a card by
``test_torch_kernels.py``). Their scores must be bit-equal to the JAX XLA structured path
(``ViterbiDecoder(mode="structured", use_pallas=False)``) and to the numpy
oracle, and agree within ``almost_equal_vec`` (±1.0) with the JAX Pallas
kernels run in interpret mode: those select emissions through a bf16
hi/lo split and are not exact f32 by design.
"""

import numpy as np
import pytest
import torch

from test_property_random import _random_structured_hmm

from spec_viterbi_tpu.hmm import almost_equal_vec
from spec_viterbi_tpu.models.decoder import ViterbiDecoder as RefDecoder
from spec_viterbi_tpu.models.oracle import viterbi_scores_oracle
from spec_viterbi_tpu.ops import fused_pallas as ref_fused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator

from spec_viterbi_tpu_torch.convert import structured_operator_from_reference
from spec_viterbi_tpu_torch.io.generators import generate_profile_hmm
from spec_viterbi_tpu_torch.ops import fused
from test_torch_host import ref_from_port
from test_torch_kernels import _generic_models

torch.set_num_threads(1)


def _pair(model):
    """(JAX Pallas decoder in interpret mode, port decoder on the CPU),
    built from the identical operator."""
    ref_sop = RefOperator.from_hmm(model)
    em = model.emission_matrix(pad_to=ref_sop.n)
    pi = model.start_vector(pad_to=ref_sop.n)
    ref = ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)
    port = fused.FusedStructuredDecoder(
        structured_operator_from_reference(ref_sop), em, pi, device="cpu"
    )
    return ref, port


def _profile(seed=0, match_states=126):
    return ref_from_port(generate_profile_hmm(match_states, seed=seed))


def _seqs(rng, lengths, emit=20):
    return [rng.integers(0, emit, size=int(t)).astype(np.int32) for t in lengths]


def _assert_exact(model, seqs, got):
    xla = RefDecoder(model, mode="structured", use_pallas=False).decode_batch(seqs)
    for g, x, s in zip(got, xla, seqs):
        np.testing.assert_array_equal(g, x)
        np.testing.assert_array_equal(g, viterbi_scores_oracle(model, s))


@pytest.mark.parametrize("b,t", [(1, 2), (3, 17), (40, 24), (130, 9)])
def test_fs_plain_uniform(b, t):
    """Uniform batches of the FS class take scores_fs (B2)."""
    model = _profile(seed=b)
    ref, port = _pair(model)
    assert port._fs_ok and ref._fs_ok
    rng = np.random.default_rng(b)
    seqs = _seqs(rng, [t] * b)
    assert port.prepare(seqs)[2] is False  # unmasked
    got = port.decode_batch(seqs)
    _assert_exact(model, seqs, got)
    pallas = ref.decode_batch(seqs)
    for g, p in zip(got, pallas):
        assert almost_equal_vec(g, p)


@pytest.mark.parametrize("lanes", [1, 7, 300])
def test_masked_plain_ragged(lanes):
    """Ragged batches take scores_masked (B1); 300 lanes are bucketed."""
    model = _profile(seed=lanes)
    _, port = _pair(model)
    rng = np.random.default_rng(lanes)
    lengths = rng.integers(1, 200, size=lanes)
    if lanes > 1:
        lengths[0] = 2
    seqs = _seqs(rng, lengths)
    if lanes == 300:
        assert fused.bucket_plan(lengths.tolist(), lane_block=fused.BB) is not None
    got = port.decode_batch(seqs)
    _assert_exact(model, seqs, got)
    np.testing.assert_array_equal(np.stack(got), np.stack(port.decode_batch(seqs, bucketed=False)))


def test_masked_plain_within_pallas_ragged():
    model = _profile(seed=11)
    ref, port = _pair(model)
    rng = np.random.default_rng(11)
    seqs = _seqs(rng, [1, 2, 3, 19, 24, 8])
    got = port.decode_batch(seqs)
    _assert_exact(model, seqs, got)
    for g, p in zip(got, ref.decode_batch(seqs)):
        assert almost_equal_vec(g, p)


@pytest.mark.parametrize("seed", range(4))
def test_masked_plain_random_structured(seed):
    """Operators outside the FS class (negative, zero and ±2 offsets,
    residual entries) take scores_masked also for uniform batches."""
    rng = np.random.default_rng(300 + seed)
    model = _random_structured_hmm(rng, int(rng.integers(24, 70)), 5)
    ref, port = _pair(model)
    assert not port._fs_ok
    for lengths in ([6] * 3, [1, 9, 4, 12]):
        seqs = _seqs(rng, lengths, emit=5)
        got = port.decode_batch(seqs)
        _assert_exact(model, seqs, got)
        for g, p in zip(got, ref.decode_batch(seqs)):
            assert almost_equal_vec(g, p)


GENERIC_MODELS = {name: ref_from_port(hmm) for name, hmm in _generic_models().items()}


@pytest.mark.parametrize("batch", ["uniform", "ragged"])
@pytest.mark.parametrize("name", sorted(GENERIC_MODELS))
def test_generic_arm_plain_matches_jax(name, batch):
    """The models the card tests hold the generic arms on (banded (1, 3),
    tie-heavy banded (-1, 1), a model at the caps): the port's generic
    scores arm (on the CPU, scores_masked_plain) bit-equal to the JAX XLA
    structured path and the oracle, and within ±1.0 of the JAX Pallas
    kernel in interpret mode."""
    model = GENERIC_MODELS[name]
    ref, port = _pair(model)
    assert not port._fs_ok and port._scores_arm is port._masked
    rng = np.random.default_rng(len(name) + len(batch))
    # the tie-heavy banded model's last symbol is dead: one lane reads it
    live = model.emit_num - (name == "tie_banded")
    lengths = [24] * 5 if batch == "uniform" else [1, 2, 24, 9, 17]
    seqs = _seqs(rng, lengths, emit=live)
    seqs[-1][-1] = model.emit_num - 1
    assert port.prepare(seqs)[2] is (batch == "ragged")
    got = port.decode_batch(seqs)
    _assert_exact(model, seqs, got)
    for g, p in zip(got, ref.decode_batch(seqs)):
        assert almost_equal_vec(g, p)


def test_fs_plain_equals_masked_plain():
    """B2's plan arithmetic is bit-equal to B1's generic step, as
    ``_make_fs_kernel`` is to ``_make_unrolled_kernel``."""
    _, port = _pair(_profile(seed=21, match_states=200))
    rng = np.random.default_rng(21)
    seqs = _seqs(rng, [33] * 9)
    st, ln, masked = port.prepare(seqs)
    assert not masked
    fs = port._run(st, ln, masked=False)
    base = port._run(st, ln, masked=True)
    assert torch.equal(fs, base)


def _planned_batches():
    rng = np.random.default_rng(41)
    return {
        "uniform": [29] * 6,
        "ragged": [1, 2, 17, 40, 9, 33],
        "bucketed": list(rng.integers(2, 12, 200)) + list(rng.integers(100, 127, 60)),
    }


PLANNED_BATCHES = _planned_batches()


@pytest.mark.parametrize("batch", sorted(PLANNED_BATCHES))
def test_planned_masked_arm_bit_equal(batch):
    """The planned arm of scores_masked (on the CPU: scores_fs_plain with
    lengths) is bit-equal to the generic arm, the oracle and the JAX XLA
    structured path on a plan-eligible model, masked and unmasked; the
    decoder's masked decodes go through it."""
    model = _profile(seed=41, match_states=160)
    _, port = _pair(model)
    assert port._fs_ok and port._scores_arm is port._fs
    rng = np.random.default_rng(len(batch))
    seqs = _seqs(rng, PLANNED_BATCHES[batch])
    st, ln, _ = port.prepare(seqs)
    v0 = port.em_t[:, st[0].long()] + port.pi[:, None]
    for lens in (ln, None):
        planned = fused.scores_masked(port._fs, port.em, v0, st[1:], lens)
        assert torch.equal(planned, fused.scores_masked(port._masked, port.em, v0, st[1:], lens))
    masked = port._run(st, ln, masked=True, b_real=len(seqs)).numpy()
    _assert_exact(model, seqs, list(masked))
    if batch == "bucketed":
        assert fused.bucket_plan([len(s) for s in seqs], lane_block=fused.BB) is not None
    _assert_exact(model, seqs, port.decode_batch(seqs))


def test_uniform_length_one_and_t_pad_are_masked():
    _, port = _pair(_profile(seed=5))
    one = [np.array([2], np.int32), np.array([5], np.int32)]
    assert port.prepare(one)[2] is True
    assert port.prepare(_seqs(np.random.default_rng(0), [10, 10]), t_pad=16)[2] is True
    model = _profile(seed=5)
    _assert_exact(model, one, port.decode_batch(one))


def test_wrappers_refuse_other_devices():
    _, port = _pair(_profile(seed=1))
    v0 = torch.empty((port.n, 2), device="meta")
    obs = torch.empty((3, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused.scores_masked(port._masked, port.em, v0, obs, None)
    with pytest.raises(ValueError, match="no kernel"):
        fused.scores_fs(port._fs, port.em, v0, obs)


def test_fused_rejects_irregular_operator():
    from spec_viterbi_tpu_torch.io.generators import generate_random_hmm
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator

    hmm = generate_random_hmm(60, seed=1)
    sop = StructuredOperator.from_hmm(hmm)
    assert not fused.fused_eligible(sop)
    with pytest.raises(ValueError, match="irregular"):
        fused.FusedStructuredDecoder(
            sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device="cpu"
        )
