"""The CUDA kernels against their plain versions, on a card.

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed: on the machine with the card,
``python -m pytest --noconftest -q tests/test_torch_kernels.py``. The
tests marked ``cuda`` skip where there is no card; the others check the
plain versions against the port's numpy oracle on the CPU.
"""

import block_operators
import numpy as np
import pytest
import torch

from spec_viterbi_tpu_torch import (
    SpecializedViterbi,
    StructuredSpecializedViterbi,
    ViterbiDecoder,
    almost_equal_vec,
    viterbi_path_oracle,
    viterbi_scores_oracle,
)
from spec_viterbi_tpu_torch.hmm import HMM, to_modified_prob_np
from spec_viterbi_tpu_torch.io.generators import (
    generate_banded_hmm,
    generate_plan7_hmm,
    generate_profile_hmm,
    generate_random_hmm,
    generate_tie_heavy_banded_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.ops import fused, tropical
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator, structured_mv_argmin
from spec_viterbi_tpu_torch.parallel import FusedTPDecoder
from spec_viterbi_tpu_torch.parallel import fused_tp

torch.set_num_threads(1)

NO_WINDOW = {"scores_window": 0, "path_window": 0}
NO_PLANNED = {"scores_masked_planned": 0, "path_planned": 0}


def _structured_model(rng, states, emit, offsets, residual):
    """Full diagonals at ``offsets``, one dense row and column, and
    ``residual`` extra entries: fused-eligible, outside the FS class."""
    entries = {}
    for d in offsets:
        for i in range(max(0, -d), min(states, states - d)):
            entries[(i, i + d)] = rng.uniform(0.01, 1.0)
    r, c = (int(x) for x in rng.integers(0, states, size=2))
    for j in range(states):
        entries[(r, j)] = rng.uniform(0.01, 1.0)
        entries[(j, c)] = rng.uniform(0.01, 1.0)
    for _ in range(residual):
        entries[tuple(int(x) for x in rng.integers(0, states, size=2))] = rng.uniform(0.01, 1.0)
    keys = sorted(entries)
    em = rng.uniform(0.01, 1.0, size=(emit, states))
    em[rng.uniform(size=em.shape) < 0.05] = 0.0
    return HMM(
        states_num=states,
        emit_num=emit,
        trans_rows=np.array([k[0] for k in keys], np.int64),
        trans_cols=np.array([k[1] for k in keys], np.int64),
        trans_probs=to_modified_prob_np(np.array([entries[k] for k in keys])),
        emissions=to_modified_prob_np(em),
        start_probabilities_cols=np.array([0, states // 2], np.int64),
        start_probabilities=to_modified_prob_np(np.array([0.6, 0.4])),
    )


def _caps_model(rng, states=256, emit=5, offsets=(1, -1, 3, -5), n_rows=4, n_cols=8, residual=8):
    """A model whose operator sits at the generic arms' caps: full
    diagonals at ``offsets``, ``n_rows`` dense rows, ``n_cols`` dense
    columns and ``residual`` scattered entries (8 diagonals + rows +
    columns + residual = 24 at the defaults, 8 of them residual), every
    transition p in {1, 0.5, 0.25} so costs tie often (-0.0 among them)."""
    levels = np.array([1.0, 0.5, 0.25])
    entries = {}
    for d in offsets:
        for i in range(max(0, -d), min(states, states - d)):
            entries[(i, i + d)] = rng.choice(levels)
    picked = rng.choice(states, size=n_rows + n_cols, replace=False)
    rows, cols = picked[:n_rows], picked[n_rows:]
    for r in rows:
        for j in range(states):
            entries[(int(r), j)] = rng.choice(levels)
    for c in cols:
        for i in range(states):
            entries[(i, int(c))] = rng.choice(levels)
    res = set()
    while len(res) < residual:
        s_, d_ = (int(x) for x in rng.integers(0, states, size=2))
        if s_ in rows or d_ in cols or d_ - s_ in offsets or (s_, d_) in entries:
            continue
        if any(d2 - s2 == d_ - s_ for s2, d2 in res):
            continue
        res.add((s_, d_))
    for k in res:
        entries[k] = rng.choice(levels)
    keys = sorted(entries)
    em = rng.choice(np.array([1.0, 0.5, 0.25, 0.0]), size=(emit, states), p=[0.35, 0.3, 0.25, 0.1])
    hmm = HMM(
        states_num=states,
        emit_num=emit,
        trans_rows=np.array([k[0] for k in keys], np.int64),
        trans_cols=np.array([k[1] for k in keys], np.int64),
        trans_probs=to_modified_prob_np(np.array([entries[k] for k in keys])),
        emissions=to_modified_prob_np(em),
        start_probabilities_cols=np.array([0, states // 3, states // 2], np.int64),
        start_probabilities=to_modified_prob_np(np.array([0.5, 0.25, 0.25])),
    )
    sop = StructuredOperator.from_hmm(hmm)
    assert (len(sop.diag_offsets), len(sop.row_idx), len(sop.col_idx), sop.residual_nnz) == (
        len(offsets), n_rows, n_cols, residual)
    return hmm


def _generic_models():
    """Models outside the uniform plans, on the generic arms: the state-
    sharded decode's banded (1, 3) operator, its tie-heavy (-1, 1) one,
    and a model at the caps (D + R + C + Z = 24, 8 residual entries)."""
    return {
        "banded_1_3": generate_banded_hmm(256, offsets=(1, 3), seed=2),
        "tie_banded": generate_tie_heavy_banded_hmm(256, offsets=(-1, 1), seed=3),
        "caps": _caps_model(np.random.default_rng(5)),
    }


def _models():
    rng = np.random.default_rng(0)
    return [
        pytest.param(generate_profile_hmm(126, seed=1), id="profile"),
        pytest.param(_structured_model(rng, 70, 6, (-1, 2), 3), id="neg_pos_residual"),
        pytest.param(_structured_model(rng, 50, 4, (0, -2), 0), id="self_loop"),
    ] + [pytest.param(hmm, id=name) for name, hmm in sorted(_generic_models().items())]


def _path_models():
    return _models() + [pytest.param(generate_tie_heavy_hmm(300, seed=0), id="tie_heavy")]


def _negative_zero_model(states=40):
    """A dense column into the last state and a dense row out of state 0,
    every transition p = 1 (cost -0.0): a carry holding -0.0 at a low
    state and +0.0 at a higher one makes the column's argmin a tie between
    a -0.0 and a +0.0 candidate."""
    last = states - 1
    pairs = sorted({(0, j) for j in range(states)} | {(i, last) for i in range(states)}
                   | {(i, i + 1) for i in range(1, states - 1)})
    return HMM(
        states_num=states,
        emit_num=2,
        trans_rows=np.array([k[0] for k in pairs], np.int64),
        trans_cols=np.array([k[1] for k in pairs], np.int64),
        trans_probs=to_modified_prob_np(np.ones(len(pairs))),
        emissions=to_modified_prob_np(np.ones((2, states))),
        start_probabilities_cols=np.array([0], np.int64),
        start_probabilities=to_modified_prob_np(np.array([1.0])),
    )


def _negative_zero_carry(n):
    """[n, 2] carries of 1.0: lane 0 holds -0.0 at state 3 and +0.0 at
    state 7, lane 1 +0.0 at state 1 and -0.0 at state 3. The dense
    column's argmin must be 3 and 1."""
    v = np.ones((n, 2), np.float32)
    v[3] = -0.0
    v[7, 0] = 0.0
    v[1, 1] = 0.0
    return v


COLLISION_ROWS = (3, 7)


def _collision_model(states=40):
    """A model in the uniform plans' class whose dense column (into the
    last state, cost 1.0 from every state but 0) sees a rounding collision
    after the first symbol: the start costs put 4096 - 3 * 2^-12 on state 3
    and 4096 - 4 * 2^-12 on state 7, both shared rows of the column, and
    5000 elsewhere; with the column base 1.0 both sums round to
    4096.9990234375. The oracle's argmin takes state 3; the argmin of the
    carry is state 7. Costs are given as they are (no probabilities): the
    dense row out of state 0 costs 2.0, the +1 diagonal 8.0, every
    emission 0.0."""
    last = states - 1
    cost = {(0, j): 2.0 for j in range(states)}
    cost.update({(i, last): 1.0 for i in range(1, states)})
    cost.update({(i, i + 1): 8.0 for i in range(1, states - 2)})
    keys = sorted(cost)
    pi = np.full(states, 5000.0, np.float32)
    pi[COLLISION_ROWS[0]] = 4096 - 3 * 2.0**-12
    pi[COLLISION_ROWS[1]] = 4096 - 4 * 2.0**-12
    return HMM(
        states_num=states,
        emit_num=2,
        trans_rows=np.array([k[0] for k in keys], np.int64),
        trans_cols=np.array([k[1] for k in keys], np.int64),
        trans_probs=np.array([cost[k] for k in keys], np.float32),
        emissions=np.zeros((2, states), np.float32),
        start_probabilities_cols=np.arange(states, dtype=np.int64),
        start_probabilities=pi,
    )


def _planned_columns_model(states, n_cols, seed):
    """A model inside the uniform plans with ``n_cols`` dense columns: the
    +1 diagonal, a uniform dense row out of state 0, and near-uniform dense
    columns into seeded targets (every state but 0 enters each at the
    column's base cost). With at most 5 columns the first has one
    deviating entry: that row leaves the shared support, so every column
    takes it as a scalar fix (5 fixes, within the plan's 8). Costs are
    given as they are."""
    rng = np.random.default_rng(seed)
    targets = sorted(rng.choice(np.arange(2, states), size=n_cols, replace=False).tolist())
    cost = {(i, i + 1): float(rng.uniform(0.5, 4.0)) for i in range(1, states - 1)}
    for m, c in enumerate(targets):
        base = float(rng.uniform(1.0, 6.0))
        cost.update({(i, c): base for i in range(1, states)})
        if m == 0 and n_cols <= 5:
            cost[(int(rng.integers(1, states)), c)] = base - 0.5
    cost.update({(0, j): 3.0 for j in range(states)})
    keys = sorted(cost)
    return HMM(
        states_num=states,
        emit_num=5,
        trans_rows=np.array([k[0] for k in keys], np.int64),
        trans_cols=np.array([k[1] for k in keys], np.int64),
        trans_probs=np.array([cost[k] for k in keys], np.float32),
        emissions=rng.uniform(0.0, 3.0, size=(5, states)).astype(np.float32),
        start_probabilities_cols=np.arange(states, dtype=np.int64),
        start_probabilities=rng.uniform(0.0, 8.0, size=states).astype(np.float32),
    )


def _planned_column_models():
    """Plan-eligible operators past two dense columns: 5 columns (the
    planned kernels' C_CAP 8 instantiation) and 16 (C_CAP 24)."""
    return [
        pytest.param(_planned_columns_model(200, 5, seed=1), 8, id="cols5"),
        pytest.param(_planned_columns_model(600, 16, seed=2), 24, id="cols16"),
    ]


def _column_cap(n_col):
    return 2 if n_col <= 2 else 8 if n_col <= 8 else 24


def _argmin_of_carry(v, shared, base, m):
    """The shortcut the two-pass argmin replaces: the lowest shared row
    holding the min of the carry, not the lowest whose sum reaches it."""
    rows = torch.arange(v.shape[0], device=v.device)[:, None]
    hit = shared[:, None] & (v == m[None, :])
    return base + m, torch.where(hit, rows, fused.NO_SOURCE).amin(dim=0)


def _decoder(hmm, device):
    sop = StructuredOperator.from_hmm(hmm)
    return fused.FusedStructuredDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device=device
    )


def _seqs(rng, lengths, emit):
    return [rng.integers(0, emit, size=int(t)).astype(np.int32) for t in lengths]


@pytest.mark.parametrize("hmm", _models())
def test_plain_versions_match_oracle(hmm):
    fd = _decoder(hmm, "cpu")
    rng = np.random.default_rng(1)
    for lengths in ([13] * 4, [1, 5, 20, 9]):
        seqs = _seqs(rng, lengths, hmm.emit_num)
        for got, s in zip(fd.decode_batch(seqs), seqs):
            np.testing.assert_array_equal(got, viterbi_scores_oracle(hmm, s))


@pytest.mark.parametrize("hmm", _path_models())
def test_plain_path_versions_match_oracle(hmm):
    """path_plain and backtrace_plain, through decode_path_batch, against
    viterbi_path_oracle: uniform (unmasked), ragged and dead-symbol
    batches."""
    fd = _decoder(hmm, "cpu")
    rng = np.random.default_rng(4)
    for lengths in ([13] * 4, [1, 5, 20, 9, 2]):
        # the last symbol is dead in the tie-heavy model
        seqs = _seqs(rng, lengths, hmm.emit_num - 1)
        seqs[-1][-1] = hmm.emit_num - 1
        for (sc, pa), s in zip(fd.decode_path_batch(seqs), seqs):
            want_sc, want_pa = viterbi_path_oracle(hmm, s)
            np.testing.assert_array_equal(sc, want_sc)
            np.testing.assert_array_equal(pa, want_pa)


def test_negative_zero_ties_resolve_by_index():
    """A p = 1 transition costs -0.0; its tie with a +0.0 candidate goes to
    the lower source index, in the argmin step, the path and the oracle."""
    hmm = _negative_zero_model()
    sop = StructuredOperator.from_hmm(hmm)
    assert sop.col_idx == (hmm.states_num - 1,) and sop.row_idx == (0,)
    assert np.signbit(sop.col_vals[0, 5])  # the cost is -0.0
    v = _negative_zero_carry(sop.n)
    u, src = structured_mv_argmin(sop, sop.to("cpu"), torch.as_tensor(v))
    last = hmm.states_num - 1
    assert src[last].tolist() == [3, 1] and u[last].tolist() == [0.0, 0.0]
    a_t = hmm.transposed_transition_matrix()
    assert [np.argmin(a_t[last] + v[: hmm.states_num, b]) for b in (0, 1)] == [3, 1]
    seq = np.array([0, 1, 0, 0, 1], np.int32)
    sc, pa = _decoder(hmm, "cpu").decode_path_batch([seq])[0]
    want_sc, want_pa = viterbi_path_oracle(hmm, seq)
    np.testing.assert_array_equal(sc, want_sc)
    np.testing.assert_array_equal(pa, want_pa)


def test_negative_zero_model_takes_the_planned_arms():
    """The -0.0 model is in the plans' class; both plain arms give the
    generic step's pointers on the -0.0/+0.0 column tie."""
    hmm = _negative_zero_model()
    fd = _decoder(hmm, "cpu")
    assert fd._fs_ok and fd._path_arm is fd._fs and fd._scores_arm is fd._fs
    v = torch.as_tensor(_negative_zero_carry(fd.n))
    obs = torch.zeros((1, 2), dtype=torch.int32)
    out, src = fused.path_plain(fd._fs, fd.em_t, v, obs, None)
    g_out, g_src = fused.path_plain(fd._masked, fd.em_t, v, obs, None)
    assert torch.equal(out, g_out) and torch.equal(src, g_src)
    assert src[0, :, hmm.states_num - 1].tolist() == [3, 1]


def test_rounding_collision_points_to_lower_row(monkeypatch):
    """Two carries that differ but give one column sum: the planned path
    points to the lower row (the oracle's), and an argmin of the carry
    would point to the higher one."""
    hmm = _collision_model()
    fd = _decoder(hmm, "cpu")
    last = hmm.states_num - 1
    assert fd._fs_ok and fd._path_arm is fd._fs
    assert fd._col_plan == [(last, 1.0, [])]  # base 1.0, no scalar fix
    shared = (fd._fs.flags & fused._build.ST_SHARED).bool()
    assert shared[list(COLLISION_ROWS)].all()
    seq = np.array([0, 0], np.int32)
    want_sc, want_pa = viterbi_path_oracle(hmm, seq)
    assert want_pa.tolist() == [COLLISION_ROWS[0], last]
    v0 = fd.pi[:, None].clone()
    obs = torch.zeros((1, 1), dtype=torch.int32)
    outs = [fused.path_plain(t, fd.em_t, v0, obs, None) for t in (fd._fs, fd._masked)]
    for out, src in outs:
        assert src[0, 0, last] == COLLISION_ROWS[0]
        np.testing.assert_array_equal(out[: hmm.states_num, 0].numpy(), want_sc)
    assert torch.equal(outs[0][1], outs[1][1])
    sc, pa = fd.decode_path_batch([seq])[0]
    np.testing.assert_array_equal(pa, want_pa)
    np.testing.assert_array_equal(sc, want_sc)
    monkeypatch.setattr(fused, "_column_source", _argmin_of_carry)
    _, src = fused.path_plain(fd._fs, fd.em_t, v0, obs, None)
    assert src[0, 0, last] == COLLISION_ROWS[1]
    assert fd.decode_path_batch([seq])[0][1].tolist() != want_pa.tolist()


@pytest.mark.parametrize("hmm,cap", _planned_column_models())
def test_planned_plain_with_many_columns_matches_oracle(hmm, cap):
    """The planned plain versions on operators with 5 and 16 dense columns
    equal the generic ones and the oracle, ragged and uniform."""
    fd = _decoder(hmm, "cpu")
    assert fd._fs_ok and fd._path_arm is fd._fs and _column_cap(fd._fs.desc.n_col) == cap
    rng = np.random.default_rng(cap)
    seqs = _seqs(rng, [1, 2, 9, 24, 24], hmm.emit_num)
    for lengths in ([len(s) for s in seqs], [24] * 5):
        st, ln, _ = fd.prepare([np.resize(s, t) for s, t in zip(seqs, lengths)])
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        out, src = fused.path_plain(fd._fs, fd.em_t, v0, st[1:], ln)
        g_out, g_src = fused.path_plain(fd._masked, fd.em_t, v0, st[1:], ln)
        assert torch.equal(out, g_out) and torch.equal(src, g_src)
        assert torch.equal(fused.scores_masked_plain(fd._fs, fd.em_t, v0, st[1:], ln), out)
    for (sc, pa), s in zip(fd.decode_path_batch(seqs), seqs):
        want_sc, want_pa = viterbi_path_oracle(hmm, s)
        np.testing.assert_array_equal(sc, want_sc)
        np.testing.assert_array_equal(pa, want_pa)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hmm", _models())
@pytest.mark.parametrize("lanes", [1, 37, 300])
def test_kernels_equal_plain_on_card(cuda_device, hmm, lanes):
    """Each kernel against its plain version on the same card tensors,
    and the decode through them against the oracle."""
    fd = _decoder(hmm, cuda_device)
    rng = np.random.default_rng(lanes)
    for lengths in (rng.integers(1, 80, size=lanes), [40] * lanes):
        st, ln, _ = fd.prepare(_seqs(rng, lengths, hmm.emit_num))
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        obs = st[1:]
        for lens in (ln, None):
            got = fused.scores_masked(fd._masked, fd.em, v0, obs, lens)
            want = fused.scores_masked_plain(fd._masked, fd.em_t, v0, obs, lens)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        if fd._fs_ok:
            got = fused.scores_fs(fd._fs, fd.em, v0, obs)
            want = fused.scores_fs_plain(fd._fs, fd.em_t, v0, obs)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    seqs = _seqs(rng, rng.integers(1, 60, size=lanes), hmm.emit_num)
    for got, s in zip(fd.decode_batch(seqs), seqs[:5]):
        np.testing.assert_array_equal(got, viterbi_scores_oracle(hmm, s))


@pytest.mark.cuda
def test_decoder_goes_through_kernels(cuda_device):
    hmm = generate_profile_hmm(126, seed=2)
    dec = ViterbiDecoder(hmm, mode="structured", device=cuda_device)
    rng = np.random.default_rng(2)
    uniform = _seqs(rng, [30] * 8, 20)
    ragged = _seqs(rng, [3, 30, 17], 20)
    fused.reset_launches()
    out = dec.run_batch(dec.prepare_batch(uniform))
    assert fused.launches == {"scores_masked": 0, "scores_fs": 1, "path": 0, "backtrace": 0,
                              **NO_PLANNED, **NO_WINDOW}
    got = dec.decode_batch(ragged)
    # the ragged batch takes the planned arm of the masked kernel
    assert fused.launches == {"scores_masked": 0, "scores_fs": 1, "path": 0, "backtrace": 0,
                              **NO_PLANNED, "scores_masked_planned": 1, **NO_WINDOW}
    out = out.cpu().numpy()
    for i, s in enumerate(uniform):
        np.testing.assert_array_equal(out[i, : hmm.states_num], viterbi_scores_oracle(hmm, s))
    for g, s in zip(got, ragged):
        np.testing.assert_array_equal(g, viterbi_scores_oracle(hmm, s))


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs(cuda_device):
    fd = _decoder(generate_profile_hmm(20, seed=3), cuda_device)
    st, ln, _ = fd.prepare(_seqs(np.random.default_rng(3), [5, 5], 20))
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    with pytest.raises(ValueError, match="obs"):
        fused.scores_fs(fd._fs, fd.em, v0, st[1:].long())
    with pytest.raises(ValueError, match="v0"):
        fused.scores_masked(fd._masked, fd.em, v0.double(), st[1:], ln)
    with pytest.raises(ValueError, match="contiguous"):
        fused.scores_masked(fd._masked, fd.em, v0.T.contiguous().T, st[1:], ln)


@pytest.mark.cuda
@pytest.mark.parametrize("hmm", _path_models())
@pytest.mark.parametrize("lanes", [1, 37, 300])
def test_path_kernels_equal_plain_on_card(cuda_device, hmm, lanes):
    """svt_path against path_plain (carry and backpointers, masked and
    unmasked) and svt_backtrace against backtrace_plain on the same card
    tensors; the path decode through them against the oracle."""
    fd = _decoder(hmm, cuda_device)
    rng = np.random.default_rng(lanes)
    dead = hmm.emit_num - 1
    for lengths in (rng.integers(1, 64, size=lanes), [40] * lanes):
        seqs = _seqs(rng, lengths, hmm.emit_num)
        st, ln, _ = fd.prepare(seqs)
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        obs = st[1:]
        for lens in (ln, None):
            out, src = fused.path(fd._masked, fd.em, v0, obs, lens)
            p_out, p_src = fused.path_plain(fd._masked, fd.em_t, v0, obs, lens)
            torch.cuda.synchronize()
            assert torch.equal(out, p_out)
            assert torch.equal(src, p_src)
            last = torch.argmin(out, dim=0).to(torch.int32)
            rev = fused.backtrace(src, last)
            torch.cuda.synchronize()
            assert torch.equal(rev, fused.backtrace_plain(src, last))
            assert torch.equal(out, fused.scores_masked(fd._masked, fd.em, v0, obs, lens))
    seqs = _seqs(rng, rng.integers(1, 64, size=lanes), hmm.emit_num)
    seqs[0][-1] = dead
    for (sc, pa), s in zip(fd.decode_path_batch(seqs), seqs[:5]):
        want_sc, want_pa = viterbi_path_oracle(hmm, s)
        np.testing.assert_array_equal(sc, want_sc)
        np.testing.assert_array_equal(pa, want_pa)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["_masked", "_fs"])
def test_negative_zero_ties_on_card(cuda_device, arm):
    """Both arms of the path kernel: the planned arm's column min is then
    a zero, whose ulp bound is the smallest subnormal."""
    hmm = _negative_zero_model()
    fd = _decoder(hmm, cuda_device)
    t = getattr(fd, arm)
    v = torch.as_tensor(_negative_zero_carry(fd.n), device=cuda_device)
    obs = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    out, src = fused.path(t, fd.em, v, obs, None)
    p_out, p_src = fused.path_plain(t, fd.em_t, v, obs, None)
    torch.cuda.synchronize()
    assert torch.equal(out, p_out) and torch.equal(src, p_src)
    assert src[0, :, hmm.states_num - 1].tolist() == [3, 1]


@pytest.mark.cuda
def test_argmin_takes_first_index_on_card(cuda_device):
    """The path flow's end state is torch.argmin over the carry: the first
    index on ties (-0.0 and +0.0 included) and 0 for an all-inf lane, as
    np.argmin."""
    inf = float("inf")
    x = torch.tensor(
        [[inf, 3.0, 1.0, 1.0], [inf, 2.0, -0.0, 0.0], [inf, 2.0, 0.0, -0.0], [inf, 5.0, -0.0, 1.0]],
        device=cuda_device,
    ).repeat(1000, 1)
    got = torch.argmin(x, dim=0).cpu().numpy()
    np.testing.assert_array_equal(got, np.argmin(x.cpu().numpy(), axis=0))
    assert got.tolist() == [0, 1, 1, 1]


@pytest.mark.cuda
def test_decoder_path_flow_goes_through_kernels(cuda_device):
    hmm = generate_profile_hmm(126, seed=2)
    dec = ViterbiDecoder(hmm, mode="structured", device=cuda_device)
    rng = np.random.default_rng(5)
    uniform = _seqs(rng, [30] * 8, 20)
    ragged = _seqs(rng, [3, 30, 17, 1], 20)
    fused.reset_launches()
    got = dec.decode_path_batch(uniform) + dec.decode_path_batch(ragged)
    assert fused.launches["path_planned"] == 2 and fused.launches["backtrace"] == 2
    assert fused.launches["path"] == 0
    for (sc, pa), s in zip(got, uniform + ragged):
        want_sc, want_pa = viterbi_path_oracle(hmm, s)
        np.testing.assert_array_equal(sc, want_sc)
        np.testing.assert_array_equal(pa, want_pa)
    sc, pa = dec.decode_path(ragged[1])
    np.testing.assert_array_equal(pa, got[9][1])
    np.testing.assert_array_equal(sc, got[9][0])

    eng = dec.streaming()
    assert eng is dec._fused
    block = np.stack(uniform, axis=1)
    fused.reset_launches()
    st = eng.stream_begin_path(block[0])
    for a, b in ((1, 12), (12, 30)):
        st = eng.stream_feed_path(st, block[a:b])
    scores, paths = eng.stream_path_finalize(st)
    assert fused.launches == {"scores_masked": 0, "scores_fs": 0, "path": 0, "backtrace": 2,
                              "scores_masked_planned": 2, "path_planned": 2, **NO_WINDOW}
    for i, (sc, pa) in enumerate(got[:8]):
        np.testing.assert_array_equal(scores[i], sc)
        np.testing.assert_array_equal(paths[i], pa)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[30] * 200, [3, 30, 17, 1] * 40])
def test_run_path_is_lane_major_on_card(cuda_device, lengths):
    """_run_path hands back a C-contiguous [b_real, T] int32 path tensor
    whose rows equal those of the transposed [T, B] int16 layout it
    replaced, and fetch_paths gives each lane its row, the oracle's path."""
    hmm = generate_profile_hmm(126, seed=2)
    fd = _decoder(hmm, cuda_device)
    seqs = _seqs(np.random.default_rng(7), lengths, 20)
    st, ln, masked = fd.prepare(seqs)
    b = len(seqs)
    scores, paths = fd._run_path(st, ln, masked=masked, b_real=b)
    _, core = fd._path_core(st, ln, masked)
    old = core.T[:b].to(torch.int16)
    assert old.stride() == (1, core.shape[1])
    assert paths.dtype == torch.int32 and paths.is_contiguous()
    assert paths.shape == (b, st.shape[0]) and paths.stride() == (st.shape[0], 1)
    assert torch.equal(paths, old.to(torch.int32))
    old_np = old.cpu().numpy()
    for i, (pa, s) in enumerate(zip(fused.fetch_paths(paths, lengths), seqs)):
        assert pa.dtype == np.int32 and pa.flags.c_contiguous and pa.shape == (len(s),)
        np.testing.assert_array_equal(pa, old_np[i, : len(s)].astype(np.int32))
        if i % 37 == 0:
            want_sc, want_pa = viterbi_path_oracle(hmm, s)
            np.testing.assert_array_equal(pa, want_pa)
            np.testing.assert_array_equal(scores[i].cpu().numpy(), want_sc)


@pytest.mark.cuda
def test_path_wrappers_check_inputs(cuda_device):
    fd = _decoder(generate_profile_hmm(20, seed=3), cuda_device)
    st, ln, _ = fd.prepare(_seqs(np.random.default_rng(3), [5, 5], 20))
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    with pytest.raises(ValueError, match="obs"):
        fused.path(fd._masked, fd.em, v0, st[1:].long(), ln)
    _, src = fused.path(fd._masked, fd.em, v0, st[1:], ln)
    last = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="src"):
        fused.backtrace(src.int(), last)
    with pytest.raises(ValueError, match="boundary"):
        fused.backtrace(src, last.long())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 128, 512])
def test_both_arms_equal_plain_on_card(cuda_device, lanes):
    """Both arms of svt_scores_masked and svt_path against their plain
    versions on the same card tensors, ragged and uniform, masked and
    unmasked, on a model with both plans: the planned arms take its
    FsTables, the generic arms its MaskedTables; the arms equal each
    other."""
    hmm = generate_profile_hmm(126, seed=lanes)
    fd = _decoder(hmm, cuda_device)
    assert fd._fs_ok and fd._scores_arm is fd._fs and fd._path_arm is fd._fs
    rng = np.random.default_rng(lanes)
    for lengths in (rng.integers(1, 48, size=lanes), [40] * lanes):
        st, ln, _ = fd.prepare(_seqs(rng, lengths, hmm.emit_num))
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        obs = st[1:]
        for lens in (ln, None):
            fused.reset_launches()
            scores = [fused.scores_masked(t, fd.em, v0, obs, lens) for t in (fd._fs, fd._masked)]
            paths = [fused.path(t, fd.em, v0, obs, lens) for t in (fd._fs, fd._masked)]
            assert fused.launches == {**fused.launches, "scores_masked": 1, "scores_masked_planned": 1,
                                      "path": 1, "path_planned": 1}
            for t, got, (out, src) in zip((fd._fs, fd._masked), scores, paths):
                want = fused.scores_masked_plain(t, fd.em_t, v0, obs, lens)
                p_out, p_src = fused.path_plain(t, fd.em_t, v0, obs, lens)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                assert torch.equal(out, p_out) and torch.equal(src, p_src)
                assert torch.equal(out, got)
            assert torch.equal(scores[0], scores[1])
            assert torch.equal(paths[0][1], paths[1][1])


@pytest.mark.cuda
def test_rounding_collision_on_card(cuda_device):
    """Both path kernels point the column target to the lower of two rows
    whose sums collide, as the oracle does."""
    hmm = _collision_model()
    fd = _decoder(hmm, cuda_device)
    last = hmm.states_num - 1
    v0 = fd.pi[:, None].contiguous()
    obs = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    for t in (fd._fs, fd._masked):
        out, src = fused.path(t, fd.em, v0, obs, None)
        p_out, p_src = fused.path_plain(t, fd.em_t, v0, obs, None)
        torch.cuda.synchronize()
        assert torch.equal(out, p_out) and torch.equal(src, p_src)
        assert src[0, 0, last] == COLLISION_ROWS[0]
    seq = np.array([0, 0], np.int32)
    assert fd.decode_path_batch([seq])[0][1].tolist() == viterbi_path_oracle(hmm, seq)[1].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("hmm,cap", _planned_column_models())
@pytest.mark.parametrize("lanes", [1, 37])
def test_planned_arms_many_columns_on_card(cuda_device, hmm, cap, lanes):
    """The C_CAP 8 and 24 instantiations of svt_path_planned (5 and 16
    dense columns) and svt_scores_masked_planned against their plain
    versions, ragged and uniform, masked and unmasked; the path decode
    through them against the oracle."""
    fd = _decoder(hmm, cuda_device)
    assert fd._fs_ok and fd._path_arm is fd._fs and _column_cap(fd._fs.desc.n_col) == cap
    rng = np.random.default_rng(lanes)
    for lengths in (rng.integers(1, 40, size=lanes), [30] * lanes):
        st, ln, _ = fd.prepare(_seqs(rng, lengths, hmm.emit_num))
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        obs = st[1:]
        for lens in (ln, None):
            fused.reset_launches()
            got = fused.scores_masked(fd._fs, fd.em, v0, obs, lens)
            out, src = fused.path(fd._fs, fd.em, v0, obs, lens)
            assert fused.launches["scores_masked_planned"] == 1 and fused.launches["path_planned"] == 1
            p_out, p_src = fused.path_plain(fd._fs, fd.em_t, v0, obs, lens)
            torch.cuda.synchronize()
            assert torch.equal(got, fused.scores_masked_plain(fd._fs, fd.em_t, v0, obs, lens))
            assert torch.equal(out, p_out) and torch.equal(src, p_src)
            assert torch.equal(out, got)
    seqs = _seqs(rng, rng.integers(1, 40, size=lanes), hmm.emit_num)
    for (sc, pa), s in zip(fd.decode_path_batch(seqs), seqs[:5]):
        want_sc, want_pa = viterbi_path_oracle(hmm, s)
        np.testing.assert_array_equal(sc, want_sc)
        np.testing.assert_array_equal(pa, want_pa)


@pytest.mark.cuda
def test_planned_wrappers_check_inputs(cuda_device):
    fd = _decoder(generate_profile_hmm(20, seed=3), cuda_device)
    st, ln, _ = fd.prepare(_seqs(np.random.default_rng(3), [5, 4], 20))
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    with pytest.raises(ValueError, match="lengths"):
        fused.scores_masked(fd._fs, fd.em, v0, st[1:], ln.long())
    with pytest.raises(ValueError, match="obs"):
        fused.path(fd._fs, fd.em, v0, st[1:].long(), ln)


def _tp_decoder(hmm, shards, chunk, device):
    sop = StructuredOperator.from_hmm(hmm)
    return FusedTPDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n),
        None, chunk=chunk, shards=shards, device=device,
    )


def _window_cases(tp, rng, lanes):
    """(tables, v_in, obs, lengths) of the first chunk of a ragged and a
    uniform batch: the local form (all windows in one launch, global
    pointers) and the rank form of every shard (one window, window-local
    pointers)."""
    for lengths in (rng.integers(1, 3 * tp.chunk, size=lanes), [3 * tp.chunk] * lanes):
        st, ln = tp._stage(_seqs(rng, lengths, tp.emit_num))
        v = tp._em_t[:, st[0].long()] + tp._pi[:, None]
        k0, k1, len_c = tp._chunks(st.shape[0] - 1, ln)[0]
        obs = st[1:][k0:k1]
        yield tp._local, v, obs, len_c
        for r in range(tp.shards):
            t = fused_tp.WindowTables.build(
                tp.sop.diag_offsets, tp._local.dv, tp._em, tp.block, tp.h_lo, tp.h_hi,
                1, op_row0=r * tp.block, ptr_base=0,
            )
            yield t, v[r * tp.block : r * tp.block + tp.n_win].contiguous(), obs, len_c


# (offsets, chunk, shards, tie-heavy, symbols): D = 1..MAX_DIAG with
# negative, zero and positive offsets; 4 symbols take the staged arm, 120
# and 200 (tables past the staged budget) the global arm; no window is a
# multiple of a CTA's rows a pass
WINDOW_CASES = [
    ((1,), 8, 2, False, 4), ((-1, 1), 4, 4, False, 4), ((0, 2), 4, 4, False, 4),
    ((-1, 1), 8, 2, True, 4), ((-2, 0, 1), 4, 4, False, 4), ((-3, -1, 0, 2), 4, 2, False, 4),
    ((-2, -1, 0, 1, 2), 4, 4, False, 4), ((-3, -2, -1, 1, 2, 3), 4, 2, True, 4),
    ((-3, -2, -1, 0, 1, 2, 3), 4, 2, False, 4), ((-4, -3, -2, -1, 0, 1, 2, 3), 4, 2, False, 4),
    ((1,), 8, 2, False, 120), ((-2, 0, 1), 4, 4, False, 200), ((-1, 1), 8, 2, True, 120),
]
# (states, offsets, chunk, shards): windows of more than one pass
WIDE_WINDOW_CASES = [(1024, (-1, 2), 16, 2), (2048, (1, 3), 16, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("offsets,chunk,shards,tie,symbols", WINDOW_CASES)
def test_window_kernels_equal_plain_on_card(cuda_device, offsets, chunk, shards, tie, symbols):
    """svt_scores_window and svt_path_window against their plain versions
    (carry and pointers) on the same card tensors, local and rank forms of
    every shard, uniform and ragged (37 lanes: the last CTA of 4 lanes
    holds one, and the lanes of a CTA freeze at different steps); then the
    TP decode through them against the oracle, with its launch counts."""
    gen = generate_tie_heavy_banded_hmm if tie else generate_banded_hmm
    hmm = gen(256, offsets, symbols, seed=shards)
    tp = _tp_decoder(hmm, shards, chunk, cuda_device)
    assert sorted(tp.sop.diag_offsets) == sorted(offsets)
    assert tp._local.staged == (symbols == 4)
    assert tp.n_win % 256
    rng = np.random.default_rng(shards)
    for t, v, obs, lens in _window_cases(tp, rng, 37):
        got = fused_tp.scores_window(t, v, obs, lens)
        want = fused_tp.scores_window_plain(t, v, obs, lens)
        out, bp = fused_tp.path_window(t, v, obs, lens)
        p_out, p_bp = fused_tp.path_window_plain(t, v, obs, lens)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(out, p_out) and torch.equal(bp, p_bp)
        assert torch.equal(out, got)
    lengths = [1, 2, chunk, chunk + 1, 2 * chunk, 3 * chunk - 1, 40]
    seqs = _seqs(rng, lengths, hmm.emit_num - 1)
    seqs[-1][-1] = hmm.emit_num - 1  # the dead symbol of the tie-heavy model
    chunks = -(-(max(lengths) - 1) // chunk)
    fused.reset_launches()
    scores = tp.decode_batch(seqs)
    paths = tp.decode_path_batch(seqs)
    assert fused.launches == {
        "scores_masked": 0, "scores_fs": 0, "path": 0, "backtrace": 1, **NO_PLANNED,
        "scores_window": chunks, "path_window": chunks,
    }
    for s, sc, (psc, pa) in zip(seqs, scores, paths):
        want_sc, want_pa = viterbi_path_oracle(hmm, s)
        np.testing.assert_array_equal(sc, viterbi_scores_oracle(hmm, s))
        np.testing.assert_array_equal(psc, want_sc)
        np.testing.assert_array_equal(pa, want_pa)
    emulated = tp.decode_batch_emulated(seqs, check_path_kernel=True)
    assert all(np.array_equal(a, b) for a, b in zip(emulated, scores))


@pytest.mark.cuda
@pytest.mark.parametrize("states,offsets,chunk,shards", WIDE_WINDOW_CASES)
def test_wide_windows_equal_plain_on_card(cuda_device, states, offsets, chunk, shards):
    """Windows of 560 rows, three row-pair passes of a 128-thread lane:
    both kernels against their plain versions, local and rank forms."""
    tp = _tp_decoder(generate_banded_hmm(states, offsets, 4, seed=states), shards, chunk, cuda_device)
    assert tp.n_win > 2 * 256 and tp._local.staged
    for t, v, obs, lens in _window_cases(tp, np.random.default_rng(states), 9):
        out, bp = fused_tp.path_window(t, v, obs, lens)
        p_out, p_bp = fused_tp.path_window_plain(t, v, obs, lens)
        got = fused_tp.scores_window(t, v, obs, lens)
        torch.cuda.synchronize()
        assert torch.equal(got, fused_tp.scores_window_plain(t, v, obs, lens))
        assert torch.equal(out, p_out) and torch.equal(bp, p_bp) and torch.equal(out, got)


@pytest.mark.cuda
def test_window_occupancy_on_card(cuda_device):
    """The card reports registers, resident CTAs and lanes a CTA of both
    window kernels in both arms; the staged scores arm holds the local
    form's 2,048 lane-windows of the banded smoke model (2,432 states, 4
    shards, chunk 16) in one wave."""
    hmm = generate_banded_hmm(2432, (1, 3), 4, seed=0)
    tp = _tp_decoder(hmm, 4, 16, cuda_device)
    assert tp._local.staged and tp.n_win == 656
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for kernel in ("scores", "path"):
        regs, ctas, lanes = fused_tp.window_occupancy(tp._local, kernel, cuda_device)
        assert 0 < regs <= 255 and ctas >= 1 and lanes == 4
        if kernel == "scores":
            assert ctas * lanes * sms >= 512 * 4
    big = _tp_decoder(generate_banded_hmm(256, (1,), 120, seed=0), 2, 8, cuda_device)
    assert not big._local.staged
    regs, ctas, lanes = fused_tp.window_occupancy(big._local, "path", cuda_device)
    assert lanes == 1 and ctas >= 1


@pytest.mark.cuda
def test_window_pointers_equal_unsharded_on_card(cuda_device):
    """The local form's global pointer tensor equals svt_path's."""
    hmm = generate_banded_hmm(512, (1, 3), 4, seed=9)
    tp = _tp_decoder(hmm, 4, 16, cuda_device)
    fd = _decoder(hmm, cuda_device)
    seqs = _seqs(np.random.default_rng(9), [70] * 33, 4)
    st, ln = tp._stage(seqs)
    carry, bp = tp._run_local(st, ln, path=True)
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    out, src = fused.path(fd._masked, fd.em, v0, st[1:], None)
    torch.cuda.synchronize()
    assert torch.equal(carry, out) and torch.equal(bp, src)


@pytest.mark.cuda
def test_window_wrappers_check_inputs(cuda_device):
    tp = _tp_decoder(generate_banded_hmm(256, (1,), 4, seed=1), 2, 8, cuda_device)
    t, v, obs, lens = next(_window_cases(tp, np.random.default_rng(1), 5))
    with pytest.raises(ValueError, match="obs"):
        fused_tp.scores_window(t, v, obs.long(), lens)
    with pytest.raises(ValueError, match="v_in"):
        fused_tp.scores_window(t, v[1:], obs, lens)
    with pytest.raises(ValueError, match="out must not"):
        fused_tp.scores_window(t, v, obs, lens, out=v)
    with pytest.raises(ValueError, match="bp"):
        fused_tp.path_window(t, v, obs, lens, bp=torch.empty((1, 5, tp.n), dtype=torch.int16,
                                                             device=cuda_device))


# ---- the probe kernels (csrc/probes.cu; the flagged masked kernel of
# csrc/scores.cu) ----------------------------------------------------------


def _pass_inputs(n, lanes, steps, device, seed=0):
    from spec_viterbi_tpu_torch.probes.common import PassInputs

    return PassInputs.make(n, lanes, steps, seed, device)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "cls,p,lanes_per_cta",
    [("empty", 0, 1), ("empty", 0, 2), ("empty", 0, 4), ("stream", 3, 1), ("neighbour", 8, 1),
     ("colred", 3, 1), ("colred", 8, 1), ("bcast", 3, 1), ("emission", 4, 1), ("twosym", 0, 1)],
)
def test_probe_pass_equals_plain_on_card(cuda_device, cls, p, lanes_per_cta):
    """svt_probe_pass against probe_pass_plain on the same card tensors,
    bit for bit; empty with and without the steps' symbols."""
    from spec_viterbi_tpu_torch.ops import probes

    steps = 10
    for n in (256, 200):
        inp = _pass_inputs(n, 24, steps, cuda_device)
        tab = inp.tabs if cls == "twosym" else inp.em
        for obs in ((inp.obs, None) if cls == "empty" else (inp.obs,)):
            args = dict(obs=obs, cols=inp.cols, bufs=inp.bufs, tab=tab, p=p)
            probes.reset_launches()
            got = probes.probe_pass(cls, inp.v0, steps, lanes_per_cta=lanes_per_cta, **args)
            want = probes.probe_pass_plain(cls, inp.v0, steps, **args)
            torch.cuda.synchronize()
            assert probes.launches["probe_pass"] == 1
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["gather", "tf32", "bf16", "split2", "split3"])
def test_probe_emsel_equals_plain_on_card(cuda_device, scheme):
    """svt_probe_emsel against probe_emsel_plain, bit for bit: the
    one-hot products are exact and the tables arrive pre-rounded."""
    from spec_viterbi_tpu_torch.ops import probes

    inp = _pass_inputs(256, 24, 7, cuda_device, seed=1)
    tabs = probes.emsel_tables(inp.em, scheme)
    for p in (1, 3):
        got = probes.probe_emsel(scheme, tabs, inp.v0, inp.obs, 7, p)
        want = probes.probe_emsel_plain(tabs, inp.v0, inp.obs, 7, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hmm", _models())
@pytest.mark.parametrize(
    "name", ["baseline", "bf16_ops", "em_staged", "no_cols", "no_em", "no_special", "short_chain"])
def test_scores_variant_equals_plain_on_card(cuda_device, hmm, name):
    """svt_scores_variant against scores_variant_plain with the same
    flag, ragged and uniform, bit for bit; with no flag (and staged) also
    against svt_scores_masked."""
    from spec_viterbi_tpu_torch.ops import probes

    fd = _decoder(hmm, cuda_device)
    t = probes.VariantTables.build(fd._masked, fd.em, probes.variant_flag(name))
    rng = np.random.default_rng(3)
    for lengths in (rng.integers(1, 40, size=37), [30] * 37):
        st, ln, _ = fd.prepare(_seqs(rng, lengths, hmm.emit_num))
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        for lens in (ln, None):
            got = probes.scores_variant(t, v0, st[1:], lens)
            want = probes.scores_variant_plain(t, v0, st[1:], lens)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            if name in ("baseline", "em_staged"):
                assert torch.equal(got, fused.scores_masked(fd._masked, fd.em, v0, st[1:], lens))


def _generic_operator(rng, n, offsets, n_row, n_col, n_res, dead_row=None):
    """A structured operator built directly, outside any HMM: diagonals at
    ``offsets`` (+inf where the source falls outside the states), ``n_row``
    dense rows, ``n_col`` dense columns into distinct states and ``n_res``
    residual entries, every value drawn from {-0.0, +0.0, 1, 2, +inf} so
    ties (a -0.0 against a +0.0 among them) are common; ``dead_row`` is a
    state that no finite candidate reaches."""
    levels = np.array([-0.0, 0.0, 1.0, 2.0, np.inf], np.float32)

    def draw(*shape):
        return rng.choice(levels, size=shape, p=[0.2, 0.2, 0.25, 0.25, 0.1]).astype(np.float32)

    rows = np.arange(n)
    diag = draw(len(offsets), n)
    for q, d in enumerate(offsets):
        diag[q, (rows - d < 0) | (rows - d >= n)] = np.inf
    row_idx = tuple(int(x) for x in rng.choice(n, size=n_row, replace=False))
    col_idx = tuple(int(x) for x in rng.choice(n, size=n_col, replace=False))
    row_vals, col_vals = draw(n_row, n), draw(n_col, n)
    res_src = rng.integers(0, n, size=n_res).astype(np.int32)
    res_dst = rng.integers(0, n, size=n_res).astype(np.int32)
    res_vals = draw(n_res)
    if dead_row is not None:
        diag[:, dead_row] = np.inf
        row_vals[:, dead_row] = np.inf
        res_vals[res_dst == dead_row] = np.inf
        col_vals[[c == dead_row for c in col_idx]] = np.inf
    return StructuredOperator(
        n=n, states_num=n, diag_offsets=tuple(offsets), diag_vals=diag, row_idx=row_idx,
        row_vals=row_vals, col_idx=col_idx, col_vals=col_vals, res_src=res_src, res_dst=res_dst,
        res_vals=res_vals, nnz=0,
    )


# (n, offsets, dense rows, dense columns, residual entries): each C_CAP
# instantiation of the generic arms (2, 8, 24 columns), MAX_RES residuals,
# D + R + C + Z = 24, negative and multiple offsets, an odd n (the path
# arm's pointers one at a time), and operators whose tables do not fit in
# shared memory (read from L2)
GENERIC_CASES = {
    "c2_odd": (301, (1, -2), 1, 2, 3),
    "c8_res8": (256, (0, 3), 2, 8, 8),
    "c24": (130, (), 0, 24, 0),
    "sum24": (257, (1, -1, 2, -3), 4, 8, 8),
    "d8": (200, (1, 2, 3, -1, -2, -3, 5, -7), 0, 1, 0),
    "l2_tables": (9000, (1, -1, 5, 7), 8, 4, 8),
}


def _generic_inputs(rng, sop, lanes, steps, emit, device):
    """The operator's tables, an emission table with a dead symbol (every
    state +inf), a carry with -0.0 and +0.0 entries and +inf rows, symbols,
    and lengths from 0 (no step) up past the steps."""
    n = sop.n
    t = fused.MaskedTables.build(sop, sop.to(device))
    em = rng.choice(np.array([0.0, 1.0, 2.0, np.inf], np.float32), size=(emit, n),
                    p=[0.3, 0.3, 0.3, 0.1]).astype(np.float32)
    em[-1] = np.inf
    v0 = rng.choice(np.array([-0.0, 0.0, 1.0, 3.0, np.inf], np.float32), size=(n, lanes)).astype(np.float32)
    v0[n // 3] = np.inf
    obs = rng.integers(0, emit, size=(steps, lanes)).astype(np.int32)
    obs[steps // 2, ::3] = emit - 1
    lengths = rng.integers(0, steps + 3, size=lanes).astype(np.int32)
    lengths[: min(lanes, 3)] = [0, 1, 2][: min(lanes, 3)]
    dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return t, dev(em), dev(v0), dev(obs), dev(lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("case,lanes", [
    (case, lanes) for case in sorted(GENERIC_CASES)
    # the 9,000-state operator at 1 and 2 lanes: its plain path scan is slow
    for lanes in ((1, 2) if GENERIC_CASES[case][0] > 1000 else (1, 2, 130, 512))
])
def test_generic_arms_equal_plain_on_card(cuda_device, case, lanes):
    """The generic arms of svt_scores_masked and svt_path against their
    plain versions, masked (zero-length and one-step lanes among them) and
    unmasked, at the caps of the descriptor and the arms' instantiations,
    on ties of -0.0 against +0.0, all-+inf rows and a dead symbol; the path
    arm's carry equals the scores arm's."""
    n, offsets, n_row, n_col, n_res = GENERIC_CASES[case]
    rng = np.random.default_rng(lanes * 101 + n)
    sop = _generic_operator(rng, n, offsets, n_row, n_col, n_res, dead_row=n // 2)
    steps = 9 if n > 1000 else 24
    t, em, v0, obs, lengths = _generic_inputs(rng, sop, lanes, steps, 5, cuda_device)
    shape = fused.generic_shape(t, lanes, cuda_device)
    assert shape["tables_in_shared_memory"] == (case != "l2_tables")
    for lens in (lengths, None):
        got = fused.scores_masked(t, em, v0, obs, lens)
        out, src = fused.path(t, em, v0, obs, lens)
        want = fused.scores_masked_plain(t, em.T.contiguous(), v0, obs, lens)
        p_out, p_src = fused.path_plain(t, em.T.contiguous(), v0, obs, lens)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(out, p_out) and torch.equal(src, p_src)
        assert torch.equal(out, got)


@pytest.mark.cuda
def test_generic_shape_on_card(cuda_device):
    """The generic arms' shape: 512 threads a CTA; one lane a CTA for one
    lane; 512 lanes of the corpus model's operator shape in one wave of 4
    lanes a CTA, its tables in shared memory; 8 columns take at most 2
    lanes a CTA; each shape's launch equal to the plain version."""
    rng = np.random.default_rng(7)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n_col, lanes_cap in ((2, 4), (8, 2)):
        sop = _generic_operator(rng, 2432, (1,), 1, n_col, 0)
        t, em, v0, obs, lengths = _generic_inputs(rng, sop, 512, 6, 5, cuda_device)
        for path in (False, True):
            assert fused.generic_shape(t, 1, cuda_device, path=path)["lanes_a_cta"] == 1
            s = fused.generic_shape(t, 512, cuda_device, path=path)
            assert s["threads_a_cta"] == 512 and s["tables_in_shared_memory"]
            assert s["lanes_a_cta"] <= lanes_cap
            if n_col == 2:
                assert s["lanes_a_cta"] == 4 and s["lanes_a_cta"] * s["ctas_per_sm"] * sms >= 512
        for lanes in (1, 512):
            v, o, ln = (x[..., :lanes].contiguous() for x in (v0, obs, lengths))
            got = fused.scores_masked(t, em, v, o, ln)
            out, src = fused.path(t, em, v, o, ln)
            want = fused.scores_masked_plain(t, em.T.contiguous(), v, o, ln)
            p_out, p_src = fused.path_plain(t, em.T.contiguous(), v, o, ln)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(out, p_out) and torch.equal(src, p_src)


@pytest.mark.cuda
def test_probe_wrappers_check_inputs(cuda_device):
    from spec_viterbi_tpu_torch.ops import probes

    inp = _pass_inputs(256, 16, 4, cuda_device)
    with pytest.raises(ValueError, match="obs"):
        probes.probe_pass("emission", inp.v0, 4, obs=inp.obs.long(), tab=inp.em, p=1)
    with pytest.raises(ValueError, match="cols"):
        probes.probe_pass("bcast", inp.v0, 4, cols=inp.cols.T.contiguous(), p=1)
    with pytest.raises(ValueError, match="tabs"):
        probes.probe_emsel("bf16", probes.emsel_tables(inp.em, "gather"), inp.v0, inp.obs, 4, 1)
    with pytest.raises(ValueError, match="multiple"):
        probes.probe_emsel("gather", probes.emsel_tables(inp.em, "gather"), inp.v0[:, :12].contiguous(),
                           inp.obs[:, :12].contiguous(), 4, 1)
    fd = _decoder(generate_profile_hmm(20, seed=3), cuda_device)
    t = probes.VariantTables.build(fd._masked, fd.em, 0)
    st, ln, _ = fd.prepare(_seqs(np.random.default_rng(3), [5, 5], 20))
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    with pytest.raises(ValueError, match="lengths"):
        probes.scores_variant(t, v0, st[1:], ln.long())


@pytest.mark.cuda
def test_scores_occupancy_on_card(cuda_device):
    """The card reports registers and resident CTAs of the scores and path
    kernels, both arms each; at least one CTA fits an SM."""
    from spec_viterbi_tpu_torch.ops import probes

    for kernel in probes.OCCUPANCY_KERNELS:
        regs, ctas = probes.scores_occupancy(kernel, 2432, cuda_device)
        assert 0 < regs <= 255 and 1 <= ctas <= 8


# ---- the staged backtrace and the one-barrier FS kernel (csrc/path.cu,
# csrc/scores.cu), at their edges -------------------------------------------


def far_walk(steps, lanes, n):
    """Pointers (identity off the walk) that take every lane from state 100
    up 33 states a step, each 32-step tile in the other of two regions,
    [100, 1,156) and [1,250, 2,306): each step lands past every band the
    staged walk has placed (a band reaches 31 states up and 39 down; a
    tile's bands are placed around a state of the other region), so it
    misses every step after its first."""
    def state(k):
        return (100 if k // 32 % 2 == 0 else 1250) + 33 * (k % 32)

    assert state(steps) < n and (steps <= 32 or n >= 2306)
    src = np.broadcast_to(np.arange(n), (steps, lanes, n)).copy()
    for k in range(steps):
        src[steps - 1 - k, :, state(k)] = state(k + 1)
    return src, np.full(lanes, 100)


def _backtrace_cases():
    rng = np.random.default_rng(11)
    cases = []
    for steps, lanes, n in [(0, 3, 40), (1, 1, 2), (1, 3, 301), (37, 3, 2), (200, 512, 301),
                            (3499, 3, 2432)]:
        cases.append(pytest.param(rng.integers(0, n, size=(steps, lanes, n)), rng.integers(0, n, size=lanes),
                                  None, id=f"random-{steps}x{lanes}x{n}"))
    cases.append(pytest.param(*far_walk(3499, 3, 2432), 3498, id="miss-every-step"))
    ident = np.broadcast_to(np.arange(2432), (3499, 3, 2432)).copy()
    cases.append(pytest.param(ident, np.array([0, 1216, 2431]), 0, id="identity-never-misses"))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("src,boundary,misses", _backtrace_cases())
def test_staged_backtrace_equals_plain_on_card(cuda_device, src, boundary, misses):
    """svt_backtrace against backtrace_plain and the staged walk's
    emulation on the same card tensors: 0, 1 and 3,499 steps, 1, 3 and 512
    lanes, n of 2, 301 (no multiple of 8) and 2,432; pointers that miss
    every step and pointers that never do."""
    from spec_viterbi_tpu_torch.probes import emulation

    s = torch.as_tensor(src.astype(np.int16), device=cuda_device)
    b = torch.as_tensor(boundary.astype(np.int32), device=cuda_device)
    fused.reset_launches()
    rev = fused.backtrace(s, b)
    want = fused.backtrace_plain(s, b)
    torch.cuda.synchronize()
    assert torch.equal(rev, want)
    assert fused.launches["backtrace"] == (1 if s.shape[0] else 0)
    if s.shape[0]:
        emu, got_misses = emulation.backtrace_staged(s, b)
        assert torch.equal(emu, rev)
        if misses is not None:
            assert got_misses.tolist() == [misses] * s.shape[1]


@pytest.mark.cuda
def test_staged_backtrace_on_tie_heavy_and_tp_pointers_on_card(cuda_device):
    """The walk through the generic path arm's pointers of the tie-heavy
    model at 512 lanes, and through the TP decode's global pointers of a
    banded model (offsets (1, 3), the local group): equal to the plain
    version."""
    hmm = generate_tie_heavy_hmm(300, seed=2)
    fd = _decoder(hmm, cuda_device)
    rng = np.random.default_rng(2)
    st, ln, _ = fd.prepare(_seqs(rng, rng.integers(1, 90, size=512), hmm.emit_num - 1))
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    out, src = fused.path(fd._masked, fd.em, v0, st[1:], ln)
    last = torch.argmin(out, dim=0).to(torch.int32)
    rev = fused.backtrace(src, last)
    torch.cuda.synchronize()
    assert torch.equal(rev, fused.backtrace_plain(src, last))
    tp = _tp_decoder(generate_banded_hmm(512, (1, 3), 4, seed=5), 4, 16, cuda_device)
    st, ln = tp._stage(_seqs(rng, [70] * 37, 4))
    carry, bp = tp._run_local(st, ln, path=True)
    last = torch.argmin(carry, dim=0).to(torch.int32)
    rev = fused.backtrace(bp, last)
    torch.cuda.synchronize()
    assert torch.equal(rev, fused.backtrace_plain(bp, last))


def _tiny_fs_tables(device):
    """FS tables of a two-state operator: the +1 diagonal, state 0 a
    uniform dense row, state 1 a dense column's target."""
    import types

    sop = types.SimpleNamespace(n=2, states_num=2, diag_offsets=(1,),
                                diag_vals=np.array([[np.inf, 1.5]], np.float32))
    return fused.FsTables.build(sop, [(1, 0.5, [])], (((0, 2.0),), (), ()),
                                np.zeros((2, 1), np.float32), torch.device(device))


def _fs_cases():
    return [
        pytest.param("tiny", 1, 5, id="n2-1lane"),
        pytest.param("tiny", 3, 0, id="n2-3lanes-0steps"),
        pytest.param(126, 3, 1, id="n128-3lanes-1step"),
        pytest.param(126, 265, 40, id="n128-265lanes"),
        pytest.param(380, 37, 40, id="n384-37lanes"),
        pytest.param(2405, 1, 3499, id="n2432-1lane-3499steps"),
        pytest.param(2405, 512, 64, id="n2432-512lanes"),
        # past the register rows: the arm that reads each row's bits each step
        pytest.param(4200, 265, 20, id="n4224-265lanes"),
        pytest.param(8300, 3, 20, id="n8320-3lanes"),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("states,lanes,steps", _fs_cases())
def test_one_barrier_fs_kernel_equals_plain_on_card(cuda_device, states, lanes, steps):
    """svt_scores_fs against scores_fs_plain on the same card tensors: n of
    2, 128, 384 (no multiple of the 256-thread shape's CTA), 2,432, and
    4,224 and 8,320 (more rows a thread than the registers hold); 1, 3,
    37, 265 and 512 lanes (both shapes); 0, 1 and 3,499 steps."""
    rng = np.random.default_rng(lanes + steps)
    if states == "tiny":
        t = _tiny_fs_tables(cuda_device)
        em = torch.as_tensor(rng.uniform(0.0, 3.0, size=(3, 2)).astype(np.float32), device=cuda_device)
        v0 = torch.as_tensor(rng.uniform(0.0, 5.0, size=(2, lanes)).astype(np.float32), device=cuda_device)
        obs = torch.as_tensor(rng.integers(0, 3, size=(steps, lanes)).astype(np.int32), device=cuda_device)
        em_t = em.T.contiguous()
    else:
        fd = _decoder(generate_profile_hmm(states, seed=lanes), cuda_device)
        assert fd._fs_ok
        t, em, em_t = fd._fs, fd.em, fd.em_t
        st, _, _ = fd.prepare(_seqs(rng, [steps + 1] * lanes, 20))
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        obs = st[1:]
    fused.reset_launches()
    got = fused.scores_fs(t, em, v0, obs)
    want = fused.scores_fs_plain(t, em_t, v0, obs)
    torch.cuda.synchronize()
    assert fused.launches["scores_fs"] == 1
    assert torch.equal(got, want)


def capped_fs_tables(n_uni, n_special, seed, device="cpu"):
    """FS tables at the kernel's caps on a 600-state profile operator:
    ``n_uni`` uniform rows (the first of them also a special row, fixed by
    a lower scalar candidate) and ``n_special`` special rows (the two
    column targets, fixes and recomputed rows, some starting from the bulk
    candidate and some not)."""
    hmm = generate_profile_hmm(598, seed=seed)
    sop = StructuredOperator.from_hmm(hmm)
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.arange(1, sop.states_num), size=n_special + n_uni, replace=False).tolist()
    targets, fixed, recomputed = rows[:2], rows[2 : 2 + n_special // 2], rows[2 + n_special // 2 : n_special]
    uni_src = [fixed[0]] + rows[n_special : n_special + n_uni - 1]
    uni = tuple((int(s), float(rng.uniform(2.0, 6.0))) for s in uni_src)
    fixes = tuple((int(r), float(rng.uniform(0.5, 2.0)), int(rng.choice(uni_src))) for r in fixed)
    recompute = tuple(
        (int(r), ((float(rng.uniform(1.0, 3.0)), int(r) - 1),), ((float(rng.uniform(1.0, 3.0)), int(uni_src[1])),))
        for r in recomputed
    )
    col_plan = [(int(targets[0]), 1.5, [(int(rows[-1]), 0.75)]), (int(targets[1]), 2.5, [])]
    mask = np.full((sop.n, 1), np.inf, np.float32)
    mask[rng.choice(np.arange(sop.states_num), size=sop.states_num // 2, replace=False), 0] = 0.0
    t = fused.FsTables.build(sop, col_plan, (uni, fixes, recompute), mask, torch.device(device))
    assert t.desc.n_uni == n_uni and t.desc.n_special == n_special
    return hmm, sop, t


@pytest.mark.cuda
def test_one_barrier_fs_kernel_at_the_caps_on_card(cuda_device):
    """A row both a uniform-row source and special, with the uniform and
    special rows at the kernel's caps (MAX_UNI, MAX_SPECIAL): the kernel
    equals scores_fs_plain on both shapes."""
    hmm, sop, t = capped_fs_tables(fused._build.MAX_UNI, fused._build.MAX_SPECIAL, seed=3,
                                   device=cuda_device)
    rng = np.random.default_rng(3)
    em = torch.as_tensor(hmm.emission_matrix(pad_to=sop.n), device=cuda_device)
    for lanes in (3, 512):
        v0 = torch.as_tensor(rng.uniform(0.0, 30.0, size=(sop.n, lanes)).astype(np.float32), device=cuda_device)
        v0[sop.states_num :] = float("inf")
        obs = torch.as_tensor(rng.integers(0, hmm.emit_num, size=(50, lanes)).astype(np.int32), device=cuda_device)
        got = fused.scores_fs(t, em, v0, obs)
        torch.cuda.synchronize()
        assert torch.equal(got, fused.scores_fs_plain(t, em.T.contiguous(), v0, obs))


@pytest.mark.cuda
def test_fs_shape_follows_the_lanes_on_card(cuda_device):
    """The few-lanes shape while one wave of it holds the lanes, the
    many-lanes shape past that; each with at least one CTA an SM."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    few = fused.scores_fs_shape(2432, 1, cuda_device)
    wave = few["ctas_per_sm"] * sms
    many = fused.scores_fs_shape(2432, wave + 1, cuda_device)
    assert fused.scores_fs_shape(2432, wave, cuda_device) == few
    assert few["threads_a_lane"] != many["threads_a_lane"]
    assert few["ctas_per_sm"] >= 1 and many["ctas_per_sm"] * sms >= 512


@pytest.mark.cuda
@pytest.mark.parametrize("cls,p", [("chase", 1), ("chase", 4), ("chase_hbm", 1), ("chase_hbm", 2)])
def test_chase_probe_equals_plain_on_card(cuda_device, cls, p):
    """svt_probe_pass's chase classes against their plain version."""
    from spec_viterbi_tpu_torch.ops import probes

    g = torch.Generator(device=cuda_device).manual_seed(p)
    n, lanes, steps = 301, 24, 9
    v0 = torch.rand((n, lanes), generator=g, device=cuda_device)
    if cls == "chase":
        tab = torch.randperm(n, generator=g, device=cuda_device).to(torch.int16)
    else:
        tab = torch.randint(0, n, (7, lanes, n), generator=g, device=cuda_device, dtype=torch.int16)
    probes.reset_launches()
    got = probes.probe_pass(cls, v0, steps, tab=tab, p=p)
    want = probes.probe_pass_plain(cls, v0, steps, tab=tab, p=p)
    torch.cuda.synchronize()
    assert probes.launches["probe_pass"] == 1
    assert torch.equal(got, want)


# ---- svt_minplus, the dense (min,+) product ----------------------------


def _minplus_mat(rng, shape, device):
    """Integer values in [0, 3] (ties everywhere), ~20% +inf, and every
    fifth row of the second axis all +inf."""
    x = rng.integers(0, 4, size=shape).astype(np.float32)
    x[rng.uniform(size=shape) < 0.2] = np.inf
    if len(shape) == 3:
        x[:, ::5] = np.inf
    return torch.as_tensor(x, device=device)


def _minplus_a(rng, layout, g, i, k, device):
    """``(a, a_idx)`` in one of the layouts the decoder and the specializer
    hand the kernel: own operators, one shared operator, a transposed
    view (stride_i = 1), gathered through an index vector with repeats."""
    if layout == "own":
        return _minplus_mat(rng, (g, i, k), device), None
    if layout == "shared":
        return _minplus_mat(rng, (1, i, k), device), None
    if layout == "tn_view":
        return _minplus_mat(rng, (1, k, i), device)[0].T[None], None
    idx = torch.as_tensor(rng.integers(0, 7, size=g), device=device)
    return _minplus_mat(rng, (7, i, k), device), idx


@pytest.mark.cuda
@pytest.mark.parametrize("argmin", [False, True])
@pytest.mark.parametrize("layout", ["own", "shared", "tn_view", "gathered"])
@pytest.mark.parametrize("g,i,k,j", [(1, 2432, 2432, 56), (3, 67, 131, 37), (2, 100, 45, 1),
                                     (5, 1, 17, 3), (2, 129, 1000, 65), (4, 300, 33, 1),
                                     (2, 200, 700, 9), (1, 64, 0, 5)])
def test_minplus_equals_plain_on_card(cuda_device, argmin, layout, g, i, k, j):
    """Both layouts of A, the gathered form and the argmin arm, with ties
    and all-inf rows, I, J and K off every tile multiple (the narrow and
    wide tiles, k stages of 16, K split over a cluster's CTAs and reduced
    through distributed shared memory; J = 1 takes the row arm; K = 0
    gives +inf and 0): bit-equal."""
    rng = np.random.default_rng(g * 7 + i + k + j)
    a, idx = _minplus_a(rng, layout, g, i, k, cuda_device)
    b = _minplus_mat(rng, (g, k, j), cuda_device)
    tropical.reset_launches()
    got = tropical.minplus(a, b, idx, argmin=argmin)
    want = tropical.minplus_plain(a, b, idx, argmin=argmin)
    torch.cuda.synchronize()
    assert tropical.launches == {"minplus": 1}
    shape = tropical.minplus_shape(g, i, k, j, cuda_device, i_contiguous=layout == "tn_view",
                                   argmin=argmin)
    assert shape["cluster"] * shape["k_split"] >= k and 1 <= shape["cluster"] <= 16
    assert (shape["tile"] == [1, 1]) == (j == 1)
    if (g, i, k, j) == (1, 2432, 2432, 56):  # the dense batch step: a 56-wide tile, K split
        assert shape["tile"][1] == 56 and shape["cluster"] > 1
    if argmin:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_minplus_offsets_past_2_31_on_card(cuda_device):
    """An index vector into a stack of 2^31 + 2^19 elements (8.6 GB): the
    last two operators start at and past 2^31 elements, so 32-bit offsets
    would read the wrong memory."""
    i, k = 64, 4096
    ga = 2**31 // (i * k) + 2
    a = torch.empty((ga, i, k), device=cuda_device)
    rng = np.random.default_rng(31)
    sel = [ga - 1, 3, ga - 2]
    for s in sel:
        a[s] = _minplus_mat(rng, (i, k), cuda_device)
    idx = torch.tensor(sel, device=cuda_device)
    assert (ga - 1) * i * k > 2**31
    for j in (1, 5):
        b = _minplus_mat(rng, (len(sel), k, j), cuda_device)
        for argmin in (False, True):
            got = tropical.minplus(a, b, idx, argmin=argmin)
            want = tropical.minplus_plain(a, b, idx, argmin=argmin)
            torch.cuda.synchronize()
            if argmin:
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            else:
                assert torch.equal(got, want)
    del a
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_minplus_wrapper_checks_inputs(cuda_device):
    a = torch.zeros((1, 8, 9), device=cuda_device)
    b = torch.zeros((2, 9, 4), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tropical.minplus(a.double(), b)
    with pytest.raises(ValueError, match="contiguous"):
        tropical.minplus(a, b.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="K ="):
        tropical.minplus(a[:, :, :5], b)
    with pytest.raises(ValueError, match="a_idx"):
        tropical.minplus(a, b, torch.zeros(2, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="operators"):
        tropical.minplus(torch.zeros((3, 8, 9), device=cuda_device), b)
    with pytest.raises(ValueError, match="out"):
        tropical.minplus(a, b, out=torch.empty((2, 4, 8), device=cuda_device))


# J, and (I, K) taken in turn over the ragged sizes and the corpus's
MINPLUS_J = (1, 2, 8, 16, 17, 56, 64, 65, 512)
MINPLUS_IK = ((999, 1001), (1001, 2432), (2432, 999))


@pytest.mark.cuda
@pytest.mark.parametrize("argmin", [False, True])
@pytest.mark.parametrize("layout", ["own", "shared", "tn_view", "gathered"])
@pytest.mark.parametrize("j", MINPLUS_J)
def test_minplus_arms_equal_plain_on_card(cuda_device, argmin, layout, j):
    """Every tile of the tiled arm (J = 2-512) and the row arm (J = 1) at
    I and K of 999, 1,001 and 2,432 (off and on the float4, tile and stage
    multiples), in both layouts, gathered and shared, into ``out=``:
    bit-equal to ``minplus_plain``, argmins included."""
    i, k = MINPLUS_IK[MINPLUS_J.index(j) % 3]
    g = 1 if j >= 512 else 2
    rng = np.random.default_rng(j * 10 + len(layout) + argmin)
    a, idx = _minplus_a(rng, layout, g, i, k, cuda_device)
    b = _minplus_mat(rng, (g, k, j), cuda_device)
    out = torch.full((g, i, j), -1.0, device=cuda_device)
    got = tropical.minplus(a, b, idx, argmin=argmin, out=out)
    want = tropical.minplus_plain(a, b, idx, argmin=argmin)
    torch.cuda.synchronize()
    if argmin:
        assert got[0] is out and torch.equal(out, want[0]) and torch.equal(got[1], want[1])
    else:
        assert got is out and torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
@pytest.mark.parametrize("layout", ["tn_view", "own", "gathered"])
@pytest.mark.parametrize("i,k,j", [(1001, 999, 56), (130, 17, 9), (64, 0, 17), (200, 45, 65)])
def test_minplus_cluster_sizes_on_card(cuda_device, cluster, layout, i, k, j):
    """The tiled arm at each pinned cluster size: K long enough for every
    split, and K too short for a full cluster (45, 17 and 0 k: splits with
    no k, whose +inf minima never win), with and without argmin:
    bit-equal; the shape reports the size."""
    rng = np.random.default_rng(cluster * 100 + k + j)
    a, idx = _minplus_a(rng, layout, 2, i, k, cuda_device)
    b = _minplus_mat(rng, (2, k, j), cuda_device)
    tropical.minplus_tune(cluster)
    try:
        shape = tropical.minplus_shape(2, i, k, j, cuda_device, i_contiguous=layout == "tn_view")
        assert shape["cluster"] == cluster
        for argmin in (False, True):
            got = tropical.minplus(a, b, idx, argmin=argmin)
            want = tropical.minplus_plain(a, b, idx, argmin=argmin)
            torch.cuda.synchronize()
            if argmin:
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            else:
                assert torch.equal(got, want)
    finally:
        tropical.minplus_tune()


@pytest.mark.cuda
@pytest.mark.parametrize("j", [1, 8, 56])
@pytest.mark.parametrize("cluster", [0, 8])
def test_minplus_all_inf_rows_point_to_zero_on_card(cuda_device, j, cluster):
    """Rows of A and a column of B that no finite candidate reaches: +inf
    and source 0, on every arm and split."""
    rng = np.random.default_rng(j + cluster)
    a = _minplus_mat(rng, (1, 1001, 999), cuda_device)
    a[0, [7, 300, 1000]] = float("inf")
    b = _minplus_mat(rng, (1, 999, j), cuda_device)
    if j > 1:
        b[0, :, 3] = float("inf")
    tropical.minplus_tune(cluster)
    try:
        for view in (a, a[0].T.contiguous().T[None]):
            got, arg = tropical.minplus(view, b, argmin=True)
            want, warg = tropical.minplus_plain(view, b, argmin=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(arg, warg)
            assert torch.isinf(got[0, [7, 300, 1000]]).all() and not arg[0, [7, 300, 1000]].any()
            if j > 1:
                assert torch.isinf(got[0, :, 3]).all() and not arg[0, :, 3].any()
    finally:
        tropical.minplus_tune()


@pytest.mark.cuda
@pytest.mark.parametrize("n,lanes", [(999, 8), (1001, 17), (2432, 56), (130, 2)])
def test_dense_step_equals_plain_on_card(cuda_device, n, lanes):
    """The batch step's epilogue in one launch: lanes with ``t`` below, at
    and above their length and padded lanes of length 0 (frozen lanes keep
    the carry's bits), and every lane stepping without lengths; then the
    J = 1 step with its argmin written into a row of a pointer tensor:
    bit-equal to the plain versions."""
    rng = np.random.default_rng(n + lanes)
    a = _minplus_mat(rng, (1, n, n), cuda_device)[0]
    v = _minplus_mat(rng, (1, n, lanes), cuda_device)[0]
    em = _minplus_mat(rng, (1, 5, n), cuda_device)[0]
    obs = torch.as_tensor(rng.integers(0, 5, size=(12, lanes)).astype(np.int32), device=cuda_device)
    t = 6
    lengths = torch.as_tensor(np.resize(np.array([0, 1, 5, 6, 7, 12], np.int32), lanes),
                              device=cuda_device)
    for lens in (lengths, None):
        out = torch.full_like(v, -1.0)
        tropical.reset_launches()
        assert tropical.dense_step(a.T, v, em.T, obs, lens, t, out) is out
        want = tropical.dense_step_plain(a.T, v, em.T, obs, lens, t)
        torch.cuda.synchronize()
        assert tropical.launches == {"minplus": 1} and torch.equal(out, want)
        if lens is not None:
            frozen = lens <= t
            assert torch.equal(out[:, frozen], v[:, frozen])
    src = torch.full((3, 1, n), -1, dtype=torch.int32, device=cuda_device)
    w = torch.empty(n, device=cuda_device)
    for view in (a, a.T):
        tropical.dense_step_mv(view, v[:, 0].contiguous(), em.T, 3, w, src[1, 0])
        want_w, want_i = tropical.dense_step_mv_plain(view, v[:, 0].contiguous(), em.T, 3, argmin=True)
        torch.cuda.synchronize()
        assert torch.equal(w, want_w) and torch.equal(src[1, 0], want_i)
        assert (src[0] == -1).all() and (src[2] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,row0,lanes", [(2432, 608, 1216, 28), (2432, 1216, 1216, 32),
                                               (1001, 333, 500, 17), (130, 1, 129, 3)])
def test_dense_step_row0_equals_plain_on_card(cuda_device, n, rows, row0, lanes):
    """The state-sharded batch step: a block of ``rows`` output states of a
    [K, B] carry, whose masked lanes keep the carry's rows from ``row0``,
    at a DP x TP block and at ragged edges: bit-equal to the plain version
    and to the square step's rows; the square step keeps its bits with
    ``row0`` 0."""
    rng = np.random.default_rng(n + row0 + lanes)
    a = _minplus_mat(rng, (1, n, n), cuda_device)[0]
    v = _minplus_mat(rng, (1, n, lanes), cuda_device)[0]
    em = _minplus_mat(rng, (1, 5, n), cuda_device)[0]
    obs = torch.as_tensor(rng.integers(0, 5, size=(12, lanes)).astype(np.int32), device=cuda_device)
    lengths = torch.as_tensor(np.resize(np.array([0, 1, 5, 6, 7, 12], np.int32), lanes),
                              device=cuda_device)
    blk = slice(row0, row0 + rows)
    for t, lens in ((6, lengths), (6, None), (0, lengths)):
        square = tropical.dense_step(a.T, v, em.T, obs, lens, t, torch.empty_like(v))
        assert torch.equal(square, tropical.dense_step(a.T, v, em.T, obs, lens, t, torch.empty_like(v),
                                                       row0=0))
        out = torch.full((rows, lanes), -1.0, device=cuda_device)
        tropical.reset_launches()
        tropical.dense_step(a.T[blk], v, em.T[blk], obs, lens, t, out, row0=row0)
        want = tropical.dense_step_plain(a.T[blk], v, em.T[blk], obs, lens, t, row0)
        torch.cuda.synchronize()
        assert tropical.launches == {"minplus": 1}
        assert torch.equal(out, want) and torch.equal(out, square[blk])
        if lens is not None:
            frozen = lens <= t
            assert torch.equal(out[:, frozen], v[blk][:, frozen])
    with pytest.raises(ValueError, match="outside the carry"):
        tropical.dense_step(a.T[blk], v, em.T[blk], obs, lengths, 1, out, row0=n - rows + 1)
    with pytest.raises(ValueError, match="a_view"):
        tropical.dense_step(a.T[blk], v[:-1].contiguous(), em.T[blk], obs, lengths, 1, out, row0=0)


@pytest.mark.cuda
def test_sharded_dense_decodes_go_through_minplus_on_card(cuda_device):
    """Dense DP, TP and DP x TP in their local forms on the card: one
    ``svt_minplus`` launch a shard a step, scores bit-equal to the CPU's
    (the plain version) and to the oracle."""
    from spec_viterbi_tpu_torch.models.decoder import DeviceHMM
    from spec_viterbi_tpu_torch.parallel import (
        DATA_AXIS,
        decode_batch_dp,
        decode_batch_dp_tp,
        decode_tp,
        make_grid,
        make_group,
    )

    hmm = generate_random_hmm(200, trans_per_state=60, emit_range=5, seed=9)
    dev = DeviceHMM.from_hmm(hmm, device=cuda_device)
    rng = np.random.default_rng(9)
    seqs = _seqs(rng, [40, 1, 17, 33, 40], hmm.emit_num)
    want = [viterbi_scores_oracle(hmm, s) for s in seqs]
    tropical.reset_launches()
    got = decode_batch_dp(dev, seqs, make_group(cuda_device, 2, axis=DATA_AXIS))
    assert tropical.launches["minplus"] == 2 * 39
    got_tp = [decode_tp(dev, s, make_group(cuda_device, 4)) for s in seqs]
    assert tropical.launches["minplus"] == 2 * 39 + 4 * sum(len(s) - 1 for s in seqs)
    got_grid = decode_batch_dp_tp(dev, seqs, make_grid(cuda_device, 2, 4))
    assert tropical.launches["minplus"] == 2 * 39 + 4 * sum(len(s) - 1 for s in seqs) + 8 * 39
    for g, t, d, w in zip(got, got_tp, got_grid, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(t, w)
        np.testing.assert_array_equal(d, w)


@pytest.mark.cuda
def test_dense_step_wrappers_check_inputs(cuda_device):
    a = torch.zeros((8, 8), device=cuda_device)
    v = torch.zeros((8, 3), device=cuda_device)
    em = torch.zeros((2, 8), device=cuda_device)
    obs = torch.zeros((4, 3), dtype=torch.int32, device=cuda_device)
    out = torch.empty_like(v)
    with pytest.raises(ValueError, match="must not be v"):
        tropical.dense_step(a.T, v, em.T, obs, None, 1, v)
    with pytest.raises(ValueError, match="obs"):
        tropical.dense_step(a.T, v, em.T, obs.long(), None, 1, out)
    with pytest.raises(ValueError, match="lengths"):
        tropical.dense_step(a.T, v, em.T, obs, torch.zeros(2, dtype=torch.int32, device=cuda_device), 1, out)
    with pytest.raises(ValueError, match="t = 4"):
        tropical.dense_step(a.T, v, em.T, obs, None, 4, out)
    with pytest.raises(ValueError, match="a_view"):
        tropical.dense_step(a[:, :5], v, em.T, obs, None, 1, out)
    with pytest.raises(ValueError, match="symbol 2"):
        tropical.dense_step_mv(a, v[:, 0].contiguous(), em.T, 2, torch.empty(8, device=cuda_device))
    with pytest.raises(ValueError, match="src"):
        tropical.dense_step_mv(a, v[:, 0].contiguous(), em.T, 1, torch.empty(8, device=cuda_device),
                               torch.empty(8, dtype=torch.int64, device=cuda_device))


@pytest.mark.cuda
def test_dense_mode_and_specializer_go_through_minplus(cuda_device):
    """The dense decoder and the level-2 specializer on the card: every
    product launches svt_minplus, no fused kernel runs, and the results
    equal the CPU's (the plain version) and the oracles bit for bit."""
    hmm = generate_random_hmm(200, trans_per_state=60, emit_range=5, seed=4)
    dec = ViterbiDecoder(hmm, mode="auto", device=cuda_device)
    cpu = ViterbiDecoder(hmm, mode="dense", device="cpu")
    assert dec.mode == "dense"
    rng = np.random.default_rng(4)
    seqs = _seqs(rng, [1, 2, 40, 17, 33, 60, 5, 9, 12, 50, 44], hmm.emit_num)
    tropical.reset_launches()
    fused.reset_launches()
    got = dec.decode_batch(seqs)
    paths = dec.decode_path_batch(seqs[:3])
    one = dec.decode(seqs[3])
    assert tropical.launches["minplus"] > 0 and not any(fused.launches.values())
    for g, c, s in zip(got, cpu.decode_batch(seqs), seqs):
        np.testing.assert_array_equal(g, c)
        np.testing.assert_array_equal(g, viterbi_scores_oracle(hmm, s))
    for (sc, p), s in zip(paths, seqs):
        want_sc, want_p = viterbi_path_oracle(hmm, s)
        np.testing.assert_array_equal(sc, want_sc)
        np.testing.assert_array_equal(p, want_p)
    np.testing.assert_array_equal(one, got[3])
    with pytest.warns(UserWarning, match="level=1"):
        spec = SpecializedViterbi(level=2, device=cuda_device)
        spec.spec_with(hmm)
    with pytest.warns(UserWarning):
        spec_cpu = SpecializedViterbi(level=2, device="cpu")
        spec_cpu.spec_with(hmm)
    assert torch.equal(spec.tuple_ops.cpu(), spec_cpu.tuple_ops)
    for g, c, s in zip(spec.run_spec_batch(seqs), spec_cpu.run_spec_batch(seqs), seqs):
        np.testing.assert_array_equal(g, c)
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))
    np.testing.assert_array_equal(spec.run_spec(seqs[5]), spec_cpu.run_spec(seqs[5]))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [2, 3])
def test_structured_specializer_on_card(cuda_device, level):
    """The structured specializer on the card: the factored form runs the
    fused kernels (FS for a uniform batch, the planned masked arm a ragged
    bucket) and equals the non-specialized decode and the oracle bit for
    bit; the composed form launches none and equals the same composed code
    on the CPU bit for bit."""
    hmm = generate_profile_hmm(90, seed=level)
    rng = np.random.default_rng(level)
    ragged = _seqs(rng, [1, 2, 40, 17, 33, 60, 5, 9, 12, 50, 44, 3], hmm.emit_num)
    uniform = _seqs(rng, [48] * 5, hmm.emit_num)
    spec = StructuredSpecializedViterbi(level=level, device=cuda_device)
    spec.spec_with(hmm)
    dec = ViterbiDecoder(hmm, mode="structured", device=cuda_device)
    assert spec._fused is not None and spec._fused._fs_ok
    fused.reset_launches()
    got_u = spec.run_spec_batch(uniform)
    assert fused.launches["scores_fs"] == 1 and fused.launches["scores_masked_planned"] == 0
    got_r = spec.run_spec_batch(ragged)
    assert fused.launches["scores_masked_planned"] == 1
    for g, w, s in zip(got_u + got_r, dec.decode_batch(uniform) + dec.decode_batch(ragged),
                       uniform + ragged):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, viterbi_scores_oracle(hmm, s))
    comp = StructuredSpecializedViterbi(level=level, use_kernels=False, device=cuda_device)
    comp.spec_with(hmm)
    cpu = StructuredSpecializedViterbi(level=level, device="cpu")
    cpu.spec_with(hmm)
    assert comp._fused is None and cpu._fused is None
    fused.reset_launches()
    got_c = comp.run_spec_batch(ragged)
    assert not any(fused.launches.values())
    for g, c, s in zip(got_c, cpu.run_spec_batch(ragged), ragged):
        np.testing.assert_array_equal(g, c)
        assert almost_equal_vec(g, viterbi_scores_oracle(hmm, s))
    np.testing.assert_array_equal(comp.run_spec(ragged[2]), got_c[2])


# ---- svt_minplus with a block list: only the blocks that hold a finite
# entry (tropical.block_list), the bits of the launch without one


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _listed_step_inputs(rng, n, lanes, device):
    """A carry with ties and all-+inf rows, emissions, symbols, and lengths
    with lanes below, at and past ``t = 6`` (padded lanes of length 0)."""
    v = _minplus_mat(rng, (1, n, lanes), device)[0]
    em = _minplus_mat(rng, (1, 5, n), device)[0]
    obs = torch.as_tensor(rng.integers(0, 5, size=(12, lanes)).astype(np.int32), device=device)
    lengths = torch.as_tensor(np.resize(np.array([0, 1, 5, 6, 7, 12], np.int32), lanes),
                              device=device)
    return v, em, obs, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("name", block_operators.NAMES)
@pytest.mark.parametrize("lanes", [8, 56, 64, 200, 512])
def test_dense_step_block_list_equals_no_list_on_card(cuda_device, name, lanes):
    """``dense_step`` with the operator's block list (64-row tiles: the
    narrow tiles up to 64 lanes, the wide tile at half its rows past them)
    against the launch without a list and ``dense_step_plain``, to the bit
    (+inf equal to +inf): the Plan7 operators at L = 40 and 500, seeded
    operators with empty blocks and an empty row tile (300 states, off
    every tile multiple; 512 with ties everywhere), an all-+inf operator
    (an empty list) and a fully dense one, which gets no list. Masked
    lanes keep the carry."""
    a_np = block_operators.operator(name)
    n = a_np.shape[0]
    rng = np.random.default_rng(n + lanes)
    a = torch.as_tensor(a_np, device=cuda_device)
    blk = tropical.block_list(np.isfinite(a_np).T, cuda_device)
    assert (blk is None) == (name == "dense")
    v, em, obs, lengths = _listed_step_inputs(rng, n, lanes, cuda_device)
    t = 6
    want = tropical.dense_step_plain(a.T, v, em.T, obs, lengths, t)
    base = tropical.dense_step(a.T, v, em.T, obs, lengths, t, torch.empty_like(v))
    assert torch.equal(_bits(base), _bits(want))
    if blk is None:
        return
    out = torch.full_like(v, -1.0)
    tropical.reset_launches()
    assert tropical.dense_step(a.T, v, em.T, obs, lengths, t, out, blocks=blk) is out
    torch.cuda.synchronize()
    assert tropical.launches == {"minplus": 1}
    assert torch.equal(_bits(out), _bits(want))
    frozen = lengths <= t
    assert torch.equal(_bits(out[:, frozen]), _bits(v[:, frozen]))
    shape = tropical.minplus_shape(1, n, n, lanes, cuda_device, blocks=blk)
    assert shape["tile"][0] == tropical.LIST_ROWS
    assert shape["k_split"] == max(1, -(-blk.most // shape["cluster"])) * tropical.STAGE_K


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("lanes", [56, 512])
def test_dense_step_block_list_cluster_sizes_on_card(cuda_device, cluster, lanes):
    """The Plan7 operator at L = 500 with its list at each pinned cluster
    size: a tile whose list is shorter than the cluster leaves ranks with
    no stage; bit-equal to the launch without a list."""
    a_np = block_operators.plan7(500)
    n = a_np.shape[0]
    rng = np.random.default_rng(cluster + lanes)
    a = torch.as_tensor(a_np, device=cuda_device)
    blk = tropical.block_list(np.isfinite(a_np).T, cuda_device)
    v, em, obs, lengths = _listed_step_inputs(rng, n, lanes, cuda_device)
    want = tropical.dense_step_plain(a.T, v, em.T, obs, lengths, 6)
    tropical.minplus_tune(cluster)
    try:
        assert tropical.minplus_shape(1, n, n, lanes, cuda_device, blocks=blk)["cluster"] == cluster
        out = tropical.dense_step(a.T, v, em.T, obs, lengths, 6, torch.empty_like(v), blocks=blk)
        assert torch.equal(_bits(out), _bits(want))
    finally:
        tropical.minplus_tune()


@pytest.mark.cuda
def test_dense_decoder_walks_its_block_list_on_card(cuda_device):
    """A dense decoder on a Plan7 profile holds its list on the card and
    its batched decode (one listed launch a step) equals the CPU decoder's
    bit for bit, ragged lanes included; a list the step cannot take is
    refused: another operator's, a J = 1 step's and one on the
    untransposed matrix."""
    hmm = generate_plan7_hmm(40, seed=5)
    dec = ViterbiDecoder(hmm, mode="dense", device=cuda_device)
    cpu = ViterbiDecoder(hmm, mode="dense", device="cpu")
    assert dec.dev.blocks.table.device.type == "cuda"
    rng = np.random.default_rng(5)
    seqs = _seqs(rng, [1, 2, 40, 17, 33, 60, 5, 9, 12, 50, 44] * 7, hmm.emit_num)
    tropical.reset_launches()
    got = dec.decode_batch(seqs, bucketed=False)
    assert tropical.launches["minplus"] == 59
    for g, c in zip(got, cpu.decode_batch(seqs, bucketed=False)):
        assert np.array_equal(g.view(np.int32), c.view(np.int32))
    n = dec.dev.padded
    v, em, obs, lengths = _listed_step_inputs(rng, n, 56, cuda_device)
    other = tropical.block_list(np.isfinite(block_operators.plan7(500)).T, cuda_device)
    with pytest.raises(ValueError, match="does not fit"):
        tropical.dense_step(dec.dev.a.T, v, em.T, obs, lengths, 1, torch.empty_like(v), blocks=other)
    one = v[:, :1].contiguous()
    with pytest.raises(ValueError, match="does not fit"):
        tropical.dense_step(dec.dev.a.T, one, em.T, obs[:, :1].contiguous(), lengths[:1], 1,
                            torch.empty_like(one), blocks=dec.dev.blocks)
    with pytest.raises(ValueError, match="transposed view"):
        tropical.dense_step(dec.dev.a, v, em.T, obs, lengths, 1, torch.empty_like(v),
                            blocks=dec.dev.blocks)


# ---- time parallelism: svt_minplus at the compose and fold shapes, the
# remat launch and the walk --------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("nb,s,r,n", [(37, 12, 3, 128), (5, 48, 3, 300), (64, 6, 6, 256), (3, 24, 24, 131)])
def test_minplus_time_parallel_shapes_on_card(cuda_device, nb, s, r, n):
    """The shapes ``TimeParallelDecoder`` gives ``svt_minplus``: a slot
    store (strided over blocks, as the tree's earlier halves) against a
    component's w (J = R), the dots against the components' u (K = R),
    and the fold's two J = 1 launches on one block (a row view of the
    store, then its transposed view): bit-equal to ``minplus_plain``."""
    rng = np.random.default_rng(nb + s + r + n)
    store = _minplus_mat(rng, (2 * nb, s, n), cuda_device)
    u_b = store[0::2]
    w_a_t = _minplus_mat(rng, (nb, r, n), cuda_device).transpose(1, 2).contiguous()
    u_a = _minplus_mat(rng, (nb, r, n), cuda_device)
    v = _minplus_mat(rng, (1, n, 1), cuda_device)
    tropical.reset_launches()
    dots_t = tropical.minplus(u_b, w_a_t)
    assert torch.equal(dots_t, tropical.minplus_plain(u_b, w_a_t))
    cross = tropical.minplus(dots_t, u_a)
    assert torch.equal(cross, tropical.minplus_plain(dots_t, u_a))
    blk = store[3:4]
    dots = tropical.minplus(blk, v)
    assert torch.equal(dots, tropical.minplus_plain(blk, v))
    cand = tropical.minplus(blk.transpose(1, 2), dots)
    assert torch.equal(cand, tropical.minplus_plain(blk.transpose(1, 2), dots))
    assert tropical.launches == {"minplus": 4}


def _time_parallel_models():
    return [pytest.param(generate_profile_hmm(126, seed=1), id="profile"),
            pytest.param(generate_tie_heavy_hmm(300, seed=0), id="tie_heavy"),
            pytest.param(generate_banded_hmm(256, (-1, 2), 4, seed=1), id="banded")]


@pytest.mark.cuda
@pytest.mark.parametrize("hmm", _time_parallel_models())
@pytest.mark.parametrize("k,compose", [(4, "scan"), (8, "tree"), (3, "scan")])
def test_time_parallel_on_card_equals_cpu(cuda_device, hmm, k, compose):
    """``TimeParallelDecoder`` on the card (``svt_minplus``, the path arm
    of the model's fused decoder, ``svt_backtrace``) against the same
    decoder on the CPU (their plain versions): scores bit-equal, paths
    equal to each other and to the oracle; the launches of one call."""
    from spec_viterbi_tpu_torch.ops.time_parallel import TimeParallelDecoder

    sop = StructuredOperator.from_hmm(hmm)
    em, pi = hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)
    card = TimeParallelDecoder(sop, em, pi, k=k, compose=compose, device=cuda_device)
    cpu = TimeParallelDecoder(sop, em, pi, k=k, compose=compose, device="cpu")
    fd = fused.FusedStructuredDecoder(sop, em, pi, device=cuda_device)
    fd_cpu = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
    rng = np.random.default_rng(k)
    for t in (1, 2, k + 1, 3 * k + 2, 97):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        scores = card.decode(seq)
        assert np.array_equal(scores, cpu.decode(seq)), t
        fused.reset_launches()
        tropical.reset_launches()
        got_scores, path = card.decode_path(seq, engine=fd)
        nb, tail = card.plan(t)
        arm = "path_planned" if fd._path_arm is fd._fs else "path"
        want = {"backtrace": int(t > 1), arm: int(nb > 0) + int(tail > 0)}
        assert {name: c for name, c in fused.launches.items() if c} == {n: c for n, c in want.items() if c}, t
        compose_steps = k - 1 if compose == "scan" else k.bit_length() - 1
        assert tropical.launches["minplus"] == (2 * (compose_steps + nb) if nb and card.r1 else 0), t
        cpu_scores, cpu_path = cpu.decode_path(seq, engine=fd_cpu)
        assert np.array_equal(got_scores, scores) and np.array_equal(cpu_scores, scores), t
        assert np.array_equal(path, cpu_path) and np.array_equal(path, viterbi_path_oracle(hmm, seq)[1]), t


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_decode_time_parallel_on_card_equals_cpu(cuda_device, shards):
    """The dense SP on a local time group of the card (the TN product and
    the fold's J = 1 step on ``svt_minplus``) against the CPU's: bit-equal."""
    from spec_viterbi_tpu_torch.parallel import TIME_AXIS, decode_time_parallel, make_group

    hmm = generate_profile_hmm(126, seed=2)
    rng = np.random.default_rng(shards)
    for t in (1, 2, 41, 130):
        seq = rng.integers(0, hmm.emit_num, size=t).astype(np.int32)
        tropical.reset_launches()
        got = decode_time_parallel(hmm, seq, make_group(cuda_device, shards, axis=TIME_AXIS))
        assert tropical.launches["minplus"] == shards * (-(-(t - 1) // shards) + 1), t
        assert np.array_equal(got, decode_time_parallel(hmm, seq, make_group("cpu", shards, axis=TIME_AXIS))), t
