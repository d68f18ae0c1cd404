"""The port's numpy host layer against the JAX package's originals.

``spec_viterbi_tpu_torch`` copies the host layer (the JAX package pulls
in jax on import, and the card's machine has none), so every copy is held
equal to its original here, on the same seeded inputs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_property_random import _random_hmm, _random_structured_hmm

import spec_viterbi_tpu.hmm as ref_hmm
from spec_viterbi_tpu.io import chmm as ref_chmm
from spec_viterbi_tpu.io import ess as ref_ess
from spec_viterbi_tpu.io import generators as ref_gen
from spec_viterbi_tpu.models import oracle as ref_oracle
from spec_viterbi_tpu.ops import fused_pallas as ref_fused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.utils import batching as ref_batching
from spec_viterbi_tpu.utils.cache import OperatorCache as RefCache

import spec_viterbi_tpu_torch.hmm as port_hmm
from spec_viterbi_tpu_torch.convert import (
    hmm_from_reference,
    structured_operator_from_reference,
)
from spec_viterbi_tpu_torch.io import chmm as port_chmm
from spec_viterbi_tpu_torch.io import ess as port_ess
from spec_viterbi_tpu_torch.io import generators as port_gen
from spec_viterbi_tpu_torch.models import oracle as port_oracle
from spec_viterbi_tpu_torch.ops import fused as port_fused
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.utils import batching as port_batching
from spec_viterbi_tpu_torch.utils.cache import OperatorCache

torch.set_num_threads(1)

HMM_FIELDS = (
    "trans_rows", "trans_cols", "trans_probs", "emissions",
    "start_probabilities_cols", "start_probabilities",
)
SOP_ARRAYS = ("diag_vals", "row_vals", "col_vals", "res_src", "res_dst", "res_vals")
SOP_SCALARS = ("n", "states_num", "diag_offsets", "row_idx", "col_idx", "nnz")


def assert_hmm_equal(a, b):
    assert (a.states_num, a.emit_num) == (b.states_num, b.emit_num)
    for f in HMM_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f


def assert_sop_equal(a, b):
    for f in SOP_SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    for f in SOP_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def _models():
    """Seeded reference HMMs, never the corpus files."""
    out = [("profile126", ref_from_port(port_gen.generate_profile_hmm(126, seed=0)))]
    # a full Plan7 profile: its folded delete chains make 28 dense source rows
    out.append(("plan7_40", ref_from_port(port_gen.generate_plan7_hmm(40, seed=1))))
    out.append(("random60", ref_gen.generate_random_hmm(60, seed=2)))
    for seed in range(3):
        rng = np.random.default_rng(100 + seed)
        out.append((f"structured{seed}", _random_structured_hmm(rng, int(rng.integers(20, 90)), 7)))
    out.append(("irregular", _random_hmm(np.random.default_rng(9), 50, 5, 3, zero_frac=0.1)))
    return [pytest.param(name, model, id=name) for name, model in out]


def ref_from_port(hmm):
    return ref_hmm.HMM(**{f: getattr(hmm, f) for f in ("states_num", "emit_num", *HMM_FIELDS)})


def test_hmm_helpers_match():
    rng = np.random.default_rng(0)
    p = rng.uniform(0.0, 1.0, size=200)
    p[::7] = 0.0
    assert np.array_equal(port_hmm.to_modified_prob_np(p), ref_hmm.to_modified_prob_np(p))
    x = port_hmm.to_modified_prob_np(p)
    y = x + rng.uniform(-1.5, 1.5, size=x.shape).astype(np.float32)
    assert port_hmm.almost_equal_vec(x, y) == ref_hmm.almost_equal_vec(x, y)
    assert port_hmm.almost_equal_vec(x, x) and ref_hmm.almost_equal_vec(x, x)
    for n in (1, 127, 128, 129, 2407):
        assert port_hmm.pad_to_lane(n) == ref_hmm.pad_to_lane(n)
    seq = [0, 3, 19]
    assert np.array_equal(port_hmm.validate_obs_seq(seq, 20), ref_hmm.validate_obs_seq(seq, 20))
    for bad in ([0, 20], [-1, 2]):
        for mod in (port_hmm, ref_hmm):
            with pytest.raises(ValueError, match="out of range"):
                mod.validate_obs_seq(bad, 20)


def test_generators_match():
    assert_hmm_equal(
        port_gen.generate_random_hmm(70, trans_per_state=4, emit_range=9, seed=5),
        ref_gen.generate_random_hmm(70, trans_per_state=4, emit_range=9, seed=5),
    )
    a = port_gen.generate_random_sequences(4, 33, emit_range=9, seed=8)
    b = ref_gen.generate_random_sequences(4, 33, emit_range=9, seed=8)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name,model", _models())
def test_chmm_roundtrip_and_operator_match(tmp_path, name, model):
    path = tmp_path / f"{name}.chmm"
    ref_chmm.write_chmm(model, path)
    port = port_chmm.read_hmm(path)
    with open(path) as f:
        tokens = f.read().split()
    assert_hmm_equal(port, ref_chmm._parse_tokens(tokens, str(path)))
    assert_hmm_equal(port, ref_chmm.read_hmm(path))
    port_path = tmp_path / "port.chmm"
    port_chmm.write_chmm(port, port_path)
    assert port_path.read_text() == path.read_text()

    assert_hmm_equal(hmm_from_reference(model), model)
    ref_sop = RefOperator.from_hmm(model)
    port_sop = StructuredOperator.from_hmm(hmm_from_reference(model))
    assert_sop_equal(port_sop, ref_sop)
    assert_sop_equal(structured_operator_from_reference(ref_sop), ref_sop)
    assert port_sop.cost_ratio() == ref_sop.cost_ratio()
    assert port_fused.fused_eligible(port_sop) == ref_fused.fused_eligible(ref_sop)
    # the uniform plans decide which kernel runs: they must be identical
    rc, pc = ref_fused._plan_uniform_cols(ref_sop), port_fused._plan_uniform_cols(port_sop)
    assert (rc is None) == (pc is None)
    if rc is not None:
        assert np.array_equal(rc[0], pc[0]) and rc[1] == pc[1]
    assert ref_fused._plan_uniform_rows(ref_sop) == port_fused._plan_uniform_rows(port_sop)


@pytest.mark.parametrize("name,model", _models())
def test_oracles_match(name, model):
    """The copied numpy oracles against the originals, scores and paths,
    T = 1 and longer sequences."""
    rng = np.random.default_rng(len(name))
    port_hmm_obj = hmm_from_reference(model)
    for t in (1, 2, 30):
        seq = rng.integers(0, model.emit_num, size=t).astype(np.int32)
        want_sc, want_pa = ref_oracle.viterbi_path_oracle(model, seq)
        got_sc, got_pa = port_oracle.viterbi_path_oracle(port_hmm_obj, seq)
        assert got_sc.dtype == want_sc.dtype and got_pa.dtype == want_pa.dtype
        np.testing.assert_array_equal(got_sc, want_sc)
        np.testing.assert_array_equal(got_pa, want_pa)
        np.testing.assert_array_equal(
            port_oracle.viterbi_scores_oracle(port_hmm_obj, seq),
            ref_oracle.viterbi_scores_oracle(model, seq),
        )


def test_ess_roundtrip_match(tmp_path):
    seqs = port_gen.generate_random_sequences(5, 40, seed=3)
    seqs += [np.array([7], np.int32), np.arange(20, dtype=np.int32)]
    path = tmp_path / "s.ess"
    ref_ess.write_ess(seqs, path)
    port = port_ess.read_emit_seq(path)
    ref = ref_ess.read_emit_seq(path)
    assert len(port) == len(ref) == len(seqs)
    for p, r, s in zip(port, ref, seqs):
        assert p.dtype == r.dtype and np.array_equal(p, r) and np.array_equal(p, s)
    port_path = tmp_path / "p.ess"
    port_ess.write_ess(port, port_path)
    assert port_path.read_text() == path.read_text()
    path.write_text("2\n0 1\n5\n2 1\n3\n")
    with pytest.raises(ValueError, match="expected sequence number"):
        port_ess.read_emit_seq(path)


@pytest.mark.parametrize("seed", range(4))
def test_batching_match(seed):
    rng = np.random.default_rng(seed)
    for t in (1, 63, 64, 65, 96, 97, 3500, 7096):
        assert port_batching.quantize_t(t) == ref_batching.quantize_t(t)
    for b in (5, 129, 300, 512, 700):
        lens = rng.integers(1, 3500, size=b).tolist()
        for lb in (8, 128):
            assert port_batching.bucket_plan(lens, lane_block=lb) == ref_batching.bucket_plan(lens, lane_block=lb)
    seqs = [rng.integers(0, 20, size=int(t)).astype(np.int32) for t in rng.integers(1, 30, size=11)]
    for t_pad in (None, 40):
        a = port_batching.pad_batch(seqs, 8, t_pad=t_pad)
        b = ref_batching.pad_batch(seqs, 8, t_pad=t_pad)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _coo_hmm(rng):
    """A seeded COO model with dense rows, columns and diagonals among
    random entries, duplicates, +inf entries and both signs of zero."""
    n = int(rng.integers(2, 120))
    src = [rng.integers(0, n, size=int(rng.integers(0, 8 * n)))]
    dst = [rng.integers(0, n, size=src[0].size)]
    for _ in range(int(rng.integers(0, 4))):
        s, k = int(rng.integers(0, n)), int(rng.integers(0, n))
        src += [np.full(k, s)]
        dst += [rng.integers(0, n, size=k)]
        d = int(rng.integers(-(n // 2), n // 2 + 1))
        i = np.arange(max(0, -d), n - max(0, d))
        src += [i]
        dst += [i + d]
    src, dst = np.concatenate(src).astype(np.int64), np.concatenate(dst).astype(np.int64)
    probs = rng.choice([0.0, -0.0, 1.0, 2.5, np.inf, 0.25], size=src.size).astype(np.float32)
    return ref_hmm.HMM(states_num=n, emit_num=3, trans_rows=src, trans_cols=dst, trans_probs=probs,
                       emissions=np.zeros((3, n), np.float32),
                       start_probabilities_cols=np.array([0]),
                       start_probabilities=np.zeros(1, np.float32))


@pytest.mark.parametrize("seed", range(6))
def test_decomposition_in_one_pass_matches_jax(seed):
    """The port's one-pass ``from_hmm`` against the JAX package's loops over
    rows, columns and diagonals, under every option, down to the sign of
    a zero (every cell sees the same updates in the same order)."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(25):
        model = _coo_hmm(rng)
        for kw in ({}, {"dense_threshold": 2}, {"dense_threshold": 4, "max_diags": 2},
                   {"pad_to": 256}):
            port_sop = StructuredOperator.from_hmm(hmm_from_reference(model), **kw)
            ref_sop = RefOperator.from_hmm(model, **kw)
            assert_sop_equal(port_sop, ref_sop)
            for f in ("diag_vals", "row_vals", "col_vals", "res_vals"):
                assert np.array_equal(np.signbit(getattr(port_sop, f)),
                                      np.signbit(getattr(ref_sop, f))), f


def test_profile_model_structure_in_both_packages():
    """The 2,407-state corpus-shaped model decomposes exactly like the
    benchmark model: one dense row, two dense columns, the +1 diagonal,
    no residual — and takes the FS kernel in both packages."""
    hmm = port_gen.generate_profile_hmm(2405, seed=0)
    assert (hmm.states_num, hmm.emit_num) == (2407, 20)
    ref = ref_from_port(hmm)
    for mod, model in ((StructuredOperator, hmm), (RefOperator, ref)):
        sop = mod.from_hmm(model)
        assert sop.n == 2432
        assert sop.diag_offsets == (1,)
        assert sop.row_idx == (0,)
        assert sop.col_idx == (0, 2406)
        assert sop.residual_nnz == 0
    port_sop = StructuredOperator.from_hmm(hmm)
    em, pi = hmm.emission_matrix(pad_to=2432), hmm.start_vector(pad_to=2432)
    port = port_fused.FusedStructuredDecoder(port_sop, em, pi, device="cpu")
    ref_sop = RefOperator.from_hmm(ref)
    jax_dec = ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)
    assert port._fs_ok and jax_dec._fs_ok
    assert port._col_plan == jax_dec._col_plan
    assert port._row_plan == jax_dec._row_plan


@pytest.mark.parametrize(
    "n,offsets,emit,seed", [(256, (1,), 4, 0), (128, (2,), 4, 3), (256, (-1, 1), 6, 7), (64, (0, 2, -3), 3, 11)]
)
def test_banded_generator_matches_jax_test_model(n, offsets, emit, seed):
    """generate_banded_hmm draws what tests/test_fused_tp.py::banded_hmm
    draws, so both packages decode the identical banded HMM."""
    from test_fused_tp import banded_hmm

    assert_hmm_equal(
        port_gen.generate_banded_hmm(n, offsets, emit, seed),
        banded_hmm(n=n, offsets=offsets, emit=emit, seed=seed),
    )


def test_tie_heavy_banded_generator():
    hmm = port_gen.generate_tie_heavy_banded_hmm(128, (-1, 1), 4, seed=2)
    sop = StructuredOperator.from_hmm(hmm)
    assert sop.diag_offsets and not sop.row_idx and not sop.col_idx and sop.residual_nnz == 0
    assert set(np.unique(hmm.trans_probs).tolist()) <= {0.0, 1.0, 2.0}
    assert np.signbit(hmm.trans_probs).any()  # p = 1 costs -0.0
    assert np.isinf(hmm.emissions[-1]).all()  # the dead symbol
    assert_hmm_equal(hmm, port_gen.generate_tie_heavy_banded_hmm(128, (-1, 1), 4, seed=2))


def test_profile_generator_is_seeded():
    a = port_gen.generate_profile_hmm(40, seed=3)
    b = port_gen.generate_profile_hmm(40, seed=3)
    c = port_gen.generate_profile_hmm(40, seed=4)
    assert_hmm_equal(a, b)
    assert not np.array_equal(a.emissions, c.emissions)
    assert a.start_probabilities_cols.tolist() == [0]
    with pytest.raises(ValueError):
        port_gen.generate_profile_hmm(1)


@pytest.mark.parametrize("name,model", _models())
def test_fingerprint_matches(name, model):
    port = hmm_from_reference(model)
    assert port.fingerprint() == model.fingerprint()
    assert len(port.fingerprint()) == 32
    # int32 index arrays hash as their int64 values, in both packages
    narrow = hmm_from_reference(model)
    narrow.trans_rows = narrow.trans_rows.astype(np.int32)
    assert narrow.fingerprint() == port.fingerprint()
    changed = hmm_from_reference(model)
    changed.emissions = changed.emissions.copy()
    changed.emissions[0, 0] += 1.0
    assert changed.fingerprint() != port.fingerprint()


def test_operator_cache_round_trip_and_cross_read(tmp_path):
    """Store and load in each package; each reads the entry the other
    wrote (same format version and names); a miss and a corrupt entry
    return None; the port's default directory is its own."""
    rng = np.random.default_rng(3)
    arrays = {"start_ops": rng.normal(size=(4, 128)).astype(np.float32),
              "ops_id": rng.normal(size=(5, 128, 128)).astype(np.float32)}
    port, ref = OperatorCache(str(tmp_path)), RefCache(str(tmp_path))
    assert port.load("f" * 32, 2, 128) is None
    for writer, key in ((port, "a" * 32), (ref, "b" * 32)):
        writer.store(key, 2, 128, arrays, kind="dense")
        for reader in (port, ref):
            got = reader.load(key, 2, 128, kind="dense")
            assert sorted(got) == sorted(arrays)
            for k, a in arrays.items():
                assert not got[k].flags.writeable and np.array_equal(got[k], a)
        assert port.load(key, 2, 128, kind="struct") is None
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(ref._path(k, 2, 128, "dense")) for k in ("a" * 32, "b" * 32))
    corrupt = port._path("c" * 32, 1, 128, "dense")
    os.makedirs(corrupt)
    with open(os.path.join(corrupt, "ops_id.npy"), "wb") as f:
        f.write(b"not an array")
    assert port.load("c" * 32, 1, 128) is None and not os.path.exists(corrupt)
    assert OperatorCache().cache_dir.endswith(os.path.join(".cache", "spec_viterbi_tpu_torch"))


def test_import_loads_no_jax():
    code = (
        "import sys, spec_viterbi_tpu_torch, spec_viterbi_tpu_torch.ops.fused, "
        "spec_viterbi_tpu_torch.convert, spec_viterbi_tpu_torch.io.generators, "
        "spec_viterbi_tpu_torch.models.streaming_xla, spec_viterbi_tpu_torch.parallel, "
        "spec_viterbi_tpu_torch.ops.tropical, spec_viterbi_tpu_torch.ops.dispatch, "
        "spec_viterbi_tpu_torch.models.specializer, spec_viterbi_tpu_torch.utils.cache\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'spec_viterbi_tpu'))\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
