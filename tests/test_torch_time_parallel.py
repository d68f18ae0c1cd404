"""The port's ``TimeParallelDecoder`` against the JAX package's.

Seeded models go through both packages on the CPU, where the port's
``svt_minplus`` and path kernels run their plain versions (the kernels are
held to them on a card by ``tests/test_torch_kernels.py``): a profile model
(``generate_profile_hmm(150)``: one dense row, two dense columns, the +1
diagonal), banded models with two and three diagonals (no rank-1 slots,
bands of ``k·span+1``) and the tie-heavy model (three residual entries as
extra rank-1 slots, costs in {-0, 1, 2, +inf}, a dead symbol), each JAX
operator carried into the port with ``convert.py``.

- Scores are bit-equal to the JAX ``TimeParallelDecoder`` with the same
  ``k`` and ``compose``: every value is a min of candidates that are each
  one rounded add of the same operands. Against the numpy oracle they hold
  the reference's ±1.0 contract (a block operator reassociates the sums).
- Paths, without an engine and with the port's ``FusedStructuredDecoder``,
  equal the JAX decoder's and ``viterbi_path_oracle``'s.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_host import ref_from_port

from spec_viterbi_tpu.ops.fused_pallas import FusedStructuredDecoder as RefFused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.ops.time_parallel import MAX_BAND_SLOTS as REF_MAX_BAND_SLOTS
from spec_viterbi_tpu.ops.time_parallel import TimeParallelDecoder as RefTimeParallel
from spec_viterbi_tpu.ops.time_parallel import time_parallel_supported as ref_supported

from spec_viterbi_tpu_torch import almost_equal_vec, viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi_tpu_torch.convert import structured_operator_from_reference
from spec_viterbi_tpu_torch.io.generators import (
    generate_banded_hmm,
    generate_profile_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder
from spec_viterbi_tpu_torch.ops.time_parallel import (
    MAX_BAND_SLOTS,
    TimeParallelDecoder,
    time_parallel_supported,
)

torch.set_num_threads(1)

MODELS = {
    "profile": lambda: generate_profile_hmm(150, seed=3),
    "band_m1_p1": lambda: generate_banded_hmm(128, (-1, 1), 4, seed=2),
    "band_p1_p2": lambda: generate_banded_hmm(128, (1, 2), 4, seed=3),
    "band_m2_0_p3": lambda: generate_banded_hmm(128, (-2, 0, 3), 4, seed=5),
    "tie_heavy": lambda: generate_tie_heavy_hmm(120, seed=2),
}
_cache = {}


def _model(name):
    """(port HMM, JAX operator, port operator carried across, emissions, π)."""
    if name not in _cache:
        hmm = MODELS[name]()
        ref_sop = RefOperator.from_hmm(ref_from_port(hmm))
        sop = structured_operator_from_reference(ref_sop)
        _cache[name] = (hmm, ref_sop, sop, hmm.emission_matrix(pad_to=sop.n),
                        hmm.start_vector(pad_to=sop.n))
    return _cache[name]


def _cases():
    """(model, k, compose): every k with the scan, the tree where k is a
    power of two; the banded models at the block lengths of the JAX
    package's band test."""
    cases = []
    for model in ("profile", "tie_heavy"):
        for k in (2, 3, 4, 8, 16):
            cases += [(model, k, c) for c in ("scan", "tree") if c == "scan" or not k & (k - 1)]
    cases += [("band_m1_p1", 4, "scan"), ("band_m1_p1", 4, "tree"), ("band_p1_p2", 8, "scan"),
              ("band_p1_p2", 8, "tree"), ("band_m2_0_p3", 5, "scan")]
    return [pytest.param(*c, id=f"{c[0]}-k{c[1]}-{c[2]}") for c in cases]


def _lengths(k):
    return sorted({1, 2, k, k + 1, 3 * k + 2, 65})


@pytest.mark.parametrize("model,k,compose", _cases())
def test_scores_and_paths_match_jax_and_oracle(model, k, compose):
    hmm, ref_sop, sop, em, pi = _model(model)
    assert time_parallel_supported(sop, k) == ref_supported(ref_sop, k)
    ref = RefTimeParallel(ref_sop, em, pi, k=k, compose=compose)
    tp = TimeParallelDecoder(sop, em, pi, k=k, compose=compose, device="cpu")
    assert (tp.w_band, tp.r1, tp.offsets) == (ref.w_band, ref.r1, ref.offsets)
    engine = FusedStructuredDecoder(sop, em, pi, device="cpu")
    rng = np.random.default_rng(k * 31 + len(model))
    for t in _lengths(k):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        assert tp.plan(t) == ref.plan(t)
        got = tp.decode(seq)
        assert np.array_equal(got, np.asarray(ref.decode(seq))), t
        assert almost_equal_vec(got, viterbi_scores_oracle(hmm, seq)), t
        ref_scores, ref_path = ref.decode_path(seq)
        want_scores, want_path = viterbi_path_oracle(hmm, seq)
        assert np.array_equal(ref_path, want_path), t
        for eng in (None, engine):
            scores, path = tp.decode_path(seq, engine=eng)
            assert np.array_equal(scores, got), t
            assert np.array_equal(path, want_path) and path.dtype == np.int32, (t, eng)


def test_paths_equal_jax_pallas_engine():
    """JAX's remat through its Pallas path kernel (interpret mode) and the
    port's through its fused decoder give the same paths."""
    hmm, ref_sop, sop, em, pi = _model("profile")
    ref = RefTimeParallel(ref_sop, em, pi, k=8)
    ref_engine = RefFused(ref_sop, em, pi, interpret=True)
    tp = TimeParallelDecoder(sop, em, pi, k=8, device="cpu")
    engine = FusedStructuredDecoder(sop, em, pi, device="cpu")
    seq = np.random.default_rng(77).integers(0, hmm.emit_num, size=25).astype(np.int32)
    _, ref_path = ref.decode_path(seq, engine=ref_engine)
    scores, path = tp.decode_path(seq, engine=engine)
    assert np.array_equal(path, ref_path)
    assert np.array_equal(path, viterbi_path_oracle(hmm, seq)[1])
    assert np.array_equal(scores, np.asarray(ref.decode(seq)))


@pytest.mark.parametrize("case", ["band_cap", "tree_k6", "unknown_compose"])
def test_errors_match_jax(case):
    if case == "band_cap":
        hmm = generate_banded_hmm(512, (-8, 8), 4, seed=3)
        ref_sop = RefOperator.from_hmm(ref_from_port(hmm))
        k, compose, match = REF_MAX_BAND_SLOTS // 16 + 1, "scan", "band"
        assert MAX_BAND_SLOTS == REF_MAX_BAND_SLOTS
    else:
        hmm, ref_sop, _, _, _ = _model("profile")
        k, compose, match = (6, "tree", "power of two") if case == "tree_k6" else (8, "sweep", "compose")
    sop = structured_operator_from_reference(ref_sop)
    em, pi = hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)
    assert time_parallel_supported(sop, k) == ref_supported(ref_sop, k)
    with pytest.raises(ValueError, match=match):
        RefTimeParallel(ref_sop, em, pi, k=k, compose=compose)
    with pytest.raises(ValueError, match=match):
        TimeParallelDecoder(sop, em, pi, k=k, compose=compose, device="cpu")


def test_rejects_empty_and_foreign_symbols():
    hmm, _, sop, em, pi = _model("profile")
    tp = TimeParallelDecoder(sop, em, pi, k=4, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tp.decode(np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="out of range"):
        tp.decode_path(np.array([0, hmm.emit_num], np.int32))


def test_module_imports_no_jax():
    code = (
        "import sys, spec_viterbi_tpu_torch.ops.time_parallel, spec_viterbi_tpu_torch.parallel.sharded\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'spec_viterbi_tpu'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
