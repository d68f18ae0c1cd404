"""The whole slice through files: ``.chmm``/``.ess`` on disk, then the
port's ``ViterbiDecoder`` on the CPU against the JAX package's (its XLA
structured path on this machine), bit for bit."""

import numpy as np
import pytest
import torch

from spec_viterbi_tpu.io import read_emit_seq as ref_read_emit_seq
from spec_viterbi_tpu.io import read_hmm as ref_read_hmm
from spec_viterbi_tpu.models.decoder import ViterbiDecoder as RefDecoder
from spec_viterbi_tpu.models.oracle import viterbi_scores_oracle

import spec_viterbi_tpu_torch as port
from spec_viterbi_tpu_torch.io import (
    generate_profile_hmm,
    generate_random_hmm,
    write_chmm,
    write_ess,
)

torch.set_num_threads(1)


@pytest.fixture(params=["profile", "random"])
def files(request, tmp_path):
    if request.param == "profile":
        hmm = generate_profile_hmm(126, seed=7)
    else:
        hmm = generate_random_hmm(40, trans_per_state=2, emit_range=6, seed=7)
    rng = np.random.default_rng(7)
    lengths = list(rng.integers(1, 90, size=19)) + [40, 40]
    seqs = [rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32) for t in lengths]
    write_chmm(hmm, tmp_path / "m.chmm")
    write_ess(seqs, tmp_path / "s.ess")
    return tmp_path / "m.chmm", tmp_path / "s.ess"


def test_slice_through_files_matches_reference(files):
    chmm, ess = files
    hmm, seqs = port.read_hmm(chmm), port.read_emit_seq(ess)
    ref_hmm, ref_seqs = ref_read_hmm(chmm), ref_read_emit_seq(ess)
    dec = port.ViterbiDecoder(hmm, mode="structured", device="cpu")
    ref = RefDecoder(ref_hmm, mode="structured", use_pallas=False)

    for s, rs in zip(seqs[:3], ref_seqs):
        np.testing.assert_array_equal(dec.decode(s), ref.decode(rs))
    for bucketed in (True, False):
        got = dec.decode_batch(seqs, bucketed=bucketed)
        want = ref.decode_batch(ref_seqs, bucketed=bucketed)
        assert len(got) == len(want) == len(seqs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g, s in zip(got[::5], ref_seqs[::5]):
        np.testing.assert_array_equal(g, viterbi_scores_oracle(ref_hmm, s))

    uniform = seqs[-2:]
    out = dec.run_batch(dec.prepare_batch(uniform, t_pad=48))
    ref_out = np.asarray(ref.run_batch(ref.prepare_batch(ref_seqs[-2:], t_pad=48)))
    assert isinstance(out, torch.Tensor) and out.shape == ref_out.shape
    np.testing.assert_array_equal(out.numpy(), ref_out)


def test_auto_mode_and_kernel_pin_match():
    hmm = generate_profile_hmm(60, seed=3)
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 20, size=25).astype(np.int32) for _ in range(3)]
    auto = port.ViterbiDecoder(hmm, mode="auto", device="cpu")
    pinned = port.ViterbiDecoder(hmm, use_kernels=False, mode="structured", device="cpu")
    assert auto.mode == "structured"
    for a, b, s in zip(auto.decode_batch(seqs), pinned.decode_batch(seqs), seqs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, port.viterbi_scores_oracle(hmm, s))


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hmm = generate_profile_hmm(20, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.ViterbiDecoder(hmm, mode="structured", device="cuda")


def test_device_is_required_and_checked():
    hmm = generate_profile_hmm(20, seed=1)
    with pytest.raises(TypeError):
        port.ViterbiDecoder(hmm, mode="structured")
    with pytest.raises(ValueError, match="unsupported device"):
        port.ViterbiDecoder(hmm, mode="structured", device="meta")


def test_out_of_range_symbol_raises():
    hmm = generate_profile_hmm(20, seed=1)
    dec = port.ViterbiDecoder(hmm, mode="structured", device="cpu")
    bad = np.array([0, hmm.emit_num, 1], dtype=np.int32)
    with pytest.raises(ValueError, match="out of range"):
        dec.decode(bad)
    with pytest.raises(ValueError, match="out of range"):
        dec.decode_batch([np.array([1, 2], np.int32), np.array([-1, 0], np.int32)])
    with pytest.raises(ValueError, match="out of range"):
        dec.prepare_batch([bad])
    sop = port.StructuredOperator.from_hmm(hmm)
    from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder

    fd = FusedStructuredDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device="cpu"
    )
    with pytest.raises(ValueError, match="out of range"):
        fd.decode_batch([bad])
    with pytest.raises(ValueError, match="empty"):
        fd.decode_batch([np.array([], np.int32)])
