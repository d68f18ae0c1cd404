"""The port's state-sharded (TP) decode against the JAX package.

Seeded banded models from ``generate_banded_hmm`` (the draws of
``tests/test_fused_tp.py::banded_hmm``) go through the port's
``FusedTPDecoder`` on a local group of K shards on the CPU, where the
window wrappers run their plain versions (the kernels are tested on a
card by ``test_torch_kernels.py``), and through the JAX package's
``FusedTPDecoder`` on the virtual CPU mesh and in its mesh-less harness,
both in Pallas interpret mode.

- Port TP scores are bit-equal to the port's unsharded decode, to
  ``viterbi_scores_oracle`` and to the JAX XLA structured path; they agree
  with the JAX TP scores within ``almost_equal_vec`` (the JAX window
  kernel selects emissions through a bf16 split and clamps +inf to BIG).
- Port TP paths equal ``viterbi_path_oracle``'s and the JAX TP paths.
- The window plain versions agree with the JAX window kernels on one
  chunk: interior carry within ``almost_equal_vec``, interior pointers
  equal (window-local, as the JAX package stores them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_host import ref_from_port

from spec_viterbi_tpu.hmm import almost_equal_vec
from spec_viterbi_tpu.models.decoder import ViterbiDecoder as RefDecoder
from spec_viterbi_tpu.models.oracle import viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi_tpu.ops.fused_pallas import BIG_THRESHOLD
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.parallel import make_mesh
from spec_viterbi_tpu.parallel.fused_tp import FusedTPDecoder as RefTPDecoder
from spec_viterbi_tpu.parallel.fused_tp import fused_tp_supported as ref_fused_tp_supported

from spec_viterbi_tpu_torch.convert import structured_operator_from_reference
from spec_viterbi_tpu_torch.io.generators import (
    generate_banded_hmm,
    generate_profile_hmm,
    generate_tie_heavy_banded_hmm,
)
from spec_viterbi_tpu_torch.ops import fused
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.parallel import FusedTPDecoder, fused_tp_supported, make_group
from spec_viterbi_tpu_torch.parallel import fused_tp

torch.set_num_threads(1)

# (offsets, chunk, shards): the cases of tests/test_fused_tp.py
CASES = [((1,), 8, 2), ((1,), 16, 4), ((-1, 1), 8, 2), ((0, 2), 4, 4), ((-3,), 8, 2)]


def _lengths(chunk):
    return (2, chunk, chunk + 1, 3 * chunk - 1, 40)


def _seqs(rng, lengths, emit):
    return [rng.integers(0, emit, size=int(t)).astype(np.int32) for t in lengths]


def _model(offsets, seed):
    """(reference HMM, reference operator, port operator, em, pi)."""
    hmm = ref_from_port(generate_banded_hmm(256, offsets, 4, seed=seed))
    ref_sop = RefOperator.from_hmm(hmm)
    sop = structured_operator_from_reference(ref_sop)
    assert not sop.row_idx and not sop.col_idx and sop.residual_nnz == 0
    return hmm, ref_sop, sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)


def _port_tp(sop, em, pi, chunk, shards):
    return FusedTPDecoder(sop, em, pi, make_group("cpu", shards), chunk=chunk)


def _equal(a, b):
    return np.array_equal(a, b)


@pytest.mark.parametrize("offsets,chunk,shards", CASES)
def test_tp_scores_bit_equal_to_unsharded_oracle_and_xla(offsets, chunk, shards):
    hmm, _, sop, em, pi = _model(offsets, seed=sum(abs(d) for d in offsets))
    tp = _port_tp(sop, em, pi, chunk, shards)
    fd = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
    seqs = _seqs(np.random.default_rng(7), (1,) + _lengths(chunk), hmm.emit_num)
    got = tp.decode_batch(seqs)
    want = fd.decode_batch(seqs, bucketed=False)
    xla = RefDecoder(hmm, mode="structured", use_pallas=False).decode_batch(seqs)
    for g, w, x, s in zip(got, want, xla, seqs):
        assert _equal(g, w), (offsets, chunk, shards, len(s))
        assert _equal(g, viterbi_scores_oracle(hmm, s)), len(s)
        assert _equal(g, np.asarray(x)), len(s)


@pytest.mark.parametrize("offsets,chunk,shards", CASES[:4])
def test_tp_scores_match_jax_tp(offsets, chunk, shards):
    """Against the JAX FusedTPDecoder on the virtual CPU mesh and in its
    mesh-less harness (interpret mode)."""
    hmm, ref_sop, sop, em, pi = _model(offsets, seed=sum(abs(d) for d in offsets))
    tp = _port_tp(sop, em, pi, chunk, shards)
    ref = RefTPDecoder(ref_sop, em, pi, make_mesh(state=shards), chunk=chunk, interpret=True)
    harness = RefTPDecoder(ref_sop, em, pi, None, chunk=chunk, interpret=True, shards=shards)
    seqs = _seqs(np.random.default_rng(3), _lengths(chunk), hmm.emit_num)
    got = tp.decode_batch(seqs)
    for want in (ref.decode_batch(seqs), harness.decode_batch_emulated(seqs)):
        for g, w in zip(got, want):
            assert almost_equal_vec(g, w)
            assert _equal(np.isinf(g), np.isinf(w))


@pytest.mark.parametrize("offsets,chunk,shards", [((1,), 8, 2), ((-1, 1), 8, 4), ((0, 2), 4, 2)])
def test_tp_paths_match_oracle_and_jax_tp(offsets, chunk, shards):
    """The cases of test_fused_tp_paths_match_oracle, plus a length-1
    lane: paths equal to the oracle's and to the JAX TP paths (the
    state-sharded pmin backtrace)."""
    hmm, ref_sop, sop, em, pi = _model(offsets, seed=11 + sum(abs(d) for d in offsets))
    tp = _port_tp(sop, em, pi, chunk, shards)
    ref = RefTPDecoder(ref_sop, em, pi, make_mesh(state=shards), chunk=chunk, interpret=True)
    seqs = _seqs(np.random.default_rng(5), (2, chunk + 1, 3 * chunk - 1, 1), hmm.emit_num)
    got = tp.decode_path_batch(seqs)
    for (sc, pa), (rsc, rpa), s in zip(got, ref.decode_path_batch(seqs), seqs):
        osc, opa = viterbi_path_oracle(hmm, s)
        assert _equal(sc, osc) and _equal(pa, opa), (offsets, len(s))
        assert _equal(pa, rpa), (offsets, len(s))
        assert almost_equal_vec(sc, rsc)


@pytest.mark.parametrize("offsets,chunk,shards", [((1,), 8, 2), ((-1, 1), 4, 4)])
def test_window_plain_matches_jax_window_kernels(offsets, chunk, shards):
    """scores_window_plain and path_window_plain against the JAX window
    kernels (_pallas_win, _path_pallas_win, interpret mode) on one chunk
    of every shard's window, in the rank form (window-local pointers)."""
    hmm, ref_sop, sop, em, pi = _model(offsets, seed=30 + shards)
    tp = _port_tp(sop, em, pi, chunk, shards)
    ref = RefTPDecoder(ref_sop, em, pi, None, chunk=chunk, interpret=True, shards=shards)
    b = 128  # the JAX kernels' lane block
    rng = np.random.default_rng(9)
    seqs = _seqs(rng, rng.integers(1, chunk + 3, size=b), hmm.emit_num)
    st, ln = tp._stage(seqs)
    k0, k1, len_c = tp._chunks(st.shape[0] - 1, ln)[0]
    obs = st[1:][k0:k1]
    v = tp._em_t[:, st[0].long()] + tp._pi[:, None]
    lo, hi = tp.h_lo, tp.h_lo + tp.block
    steps = obs.shape[0]
    obs_ref = jnp.asarray(obs.numpy().reshape(steps, 1, b))
    len_ref = jnp.asarray(len_c.numpy()[None, :])
    for r in range(shards):
        w = slice(r * tp.block, r * tp.block + tp.n_win)
        t = fused_tp.WindowTables.build(
            sop.diag_offsets, tp._local.dv, tp._em, tp.block, tp.h_lo, tp.h_hi,
            1, op_row0=r * tp.block, ptr_base=0,
        )
        v_win = v[w].contiguous()
        got = fused_tp.scores_window_plain(t, v_win, obs, len_c).numpy()
        got_p, got_src = fused_tp.path_window_plain(t, v_win, obs, len_c)
        v_ref = jnp.asarray(v_win.numpy())
        want = np.asarray(ref._pallas_win(v_ref, ref._dv_pad[w], ref._em_split_pad[w], obs_ref, len_ref))
        want_p, want_src = ref._path_pallas_win(v_ref, ref._dv_pad[w], ref._em_pad[w], obs_ref, len_ref)
        want = np.where(want >= BIG_THRESHOLD, np.inf, want)
        want_p = np.where(np.asarray(want_p) >= BIG_THRESHOLD, np.inf, np.asarray(want_p))
        assert _equal(got_p.numpy(), got)  # both port versions are exact f32
        for i in range(b):
            assert almost_equal_vec(got[lo:hi, i], want[lo:hi, i]), (r, i)
            assert almost_equal_vec(got[lo:hi, i], want_p[lo:hi, i]), (r, i)
        # window-local pointers of the interior rows: [c, B, block] vs [c, n_win, B]
        want_src = np.asarray(want_src)[:, lo:hi, :].transpose(0, 2, 1)
        assert _equal(got_src.numpy(), want_src), r


def test_local_group_pointers_equal_unsharded_path():
    """The local group's global pointer tensor equals the unsharded
    path_plain's, and svt_backtrace's plain version walks it to the
    oracle's paths."""
    hmm, _, sop, em, pi = _model((-1, 3), seed=4)
    tp = _port_tp(sop, em, pi, 4, 4)
    fd = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
    seqs = _seqs(np.random.default_rng(4), [30] * 5, hmm.emit_num)
    st, ln = tp._stage(seqs)
    carry, bp = tp._run_local(st, ln, path=True)
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    out, src = fused.path_plain(fd._masked, fd.em_t, v0, st[1:], None)
    assert torch.equal(carry, out) and torch.equal(bp, src)


def test_decode_batch_emulated_checks_path_kernel():
    hmm, _, sop, em, pi = _model((-1, 1), seed=8)
    tp = _port_tp(sop, em, pi, 8, 2)
    seqs = _seqs(np.random.default_rng(8), (1, 9, 17, 40), hmm.emit_num)
    got = tp.decode_batch_emulated(seqs, check_path_kernel=True)
    for g, s in zip(got, seqs):
        assert _equal(g, viterbi_scores_oracle(hmm, s))


def _supported_grid():
    for offsets in [(1,), (-1, 1), (0, 2), (-3,), (2,), (5, -7)]:
        for shards in (1, 2, 3, 4, 8):
            for chunk in (4, 8, 16, 32):
                yield offsets, shards, chunk


def test_fused_tp_supported_agrees_with_jax():
    """The same rule over a grid of (offsets, shards, chunk), including the
    halo budget of test_fused_tp_halo_budget (n = 128, offset 2: chunk 16
    allowed, 32 refused at 4 shards)."""
    for n in (128, 256):
        for offsets, shards, chunk in _supported_grid():
            hmm = ref_from_port(generate_banded_hmm(n, offsets, 4, seed=1))
            ref_sop = RefOperator.from_hmm(hmm)
            sop = structured_operator_from_reference(ref_sop)
            assert fused_tp_supported(sop, shards, chunk) == ref_fused_tp_supported(
                ref_sop, shards, chunk
            ), (n, offsets, shards, chunk)
    sop = StructuredOperator.from_hmm(generate_banded_hmm(128, (2,), 4, seed=0))
    assert fused_tp_supported(sop, 4, 16) and not fused_tp_supported(sop, 4, 32)


def test_coupled_operator_rejected():
    """A corpus-shaped (coupled) model needs per-step exchange."""
    hmm = generate_profile_hmm(126, seed=1)
    sop = StructuredOperator.from_hmm(hmm)
    assert sop.row_idx or sop.col_idx
    assert not fused_tp_supported(sop, 2, 8)
    assert not ref_fused_tp_supported(RefOperator.from_hmm(ref_from_port(hmm)), 2, 8)
    with pytest.raises(ValueError, match="banded"):
        _port_tp(sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), 8, 2)


def test_window_harness_requires_shards_and_device():
    hmm, _, sop, em, pi = _model((1,), seed=1)
    with pytest.raises(ValueError, match="shards"):
        FusedTPDecoder(sop, em, pi, None, device="cpu")
    with pytest.raises(ValueError, match="device"):
        FusedTPDecoder(sop, em, pi, None, shards=2)
    with pytest.raises(ValueError, match="state"):
        FusedTPDecoder(sop, em, pi, make_group("cpu", 2, axis="data"))


@pytest.mark.parametrize("chunk,shards", [(4, 4), (8, 2)])
def test_tie_heavy_dead_symbol_tails_and_length_one(chunk, shards):
    """A banded model with costs in {-0.0, 1, 2, +inf} and a dead symbol;
    tails of 1 and c - 1 steps in the last chunk; a length-1 lane. Paths
    and scores bit-equal to the oracle and to the JAX XLA path; scores
    bit-equal to the unsharded decode."""
    port_hmm = generate_tie_heavy_banded_hmm(256, (-1, 1), 4, seed=chunk)
    hmm = ref_from_port(port_hmm)
    sop = StructuredOperator.from_hmm(port_hmm)
    em, pi = hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)
    tp = _port_tp(sop, em, pi, chunk, shards)
    fd = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
    rng = np.random.default_rng(chunk)
    dead = hmm.emit_num - 1
    lengths = (1, 2, 3 * chunk + 2, 3 * chunk, 4 * chunk + 1, 5 * chunk)
    seqs = _seqs(rng, lengths, dead)
    seqs[3][chunk + 1] = dead
    xla = RefDecoder(hmm, mode="structured", use_pallas=False)
    paths = tp.decode_path_batch(seqs)
    scores = tp.decode_batch(seqs)
    for s, sc, (psc, pa), w in zip(seqs, scores, paths, fd.decode_batch(seqs, bucketed=False)):
        osc, opa = viterbi_path_oracle(hmm, s)
        xsc, xpa = xla.decode_path(s)
        assert _equal(sc, w) and _equal(sc, osc) and _equal(psc, osc), len(s)
        assert _equal(pa, opa) and _equal(pa, np.asarray(xpa)), len(s)
        assert _equal(np.asarray(xsc), osc)
    assert not np.isfinite(scores[3]).any()  # the dead symbol


def test_path_int16_limit():
    """Global pointers of a local group are int16, as the unsharded path:
    a window layout past 32,767 states is refused."""
    hmm, _, sop, em, pi = _model((1,), seed=2)
    tp = _port_tp(sop, em, pi, 8, 2)
    t = tp._local
    big = fused_tp.WindowTables(t.desc, t.dv, t.em, t.block, t.h_lo, t.shards, t.op_row0,
                                fused.INT16_STATES, t.windows, t.staged)
    v = torch.zeros((t.rows, 1))
    obs = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="int16"):
        fused_tp.path_window(big, v, obs, torch.full((1,), 2, dtype=torch.int32))


@pytest.mark.parametrize("emit,staged", [(4, True), (100, False)])
def test_window_tables_choose_the_arm_from_the_shapes(emit, staged):
    """WindowTables.build takes the staged arm where the window's tables
    and four lanes' carries fit the staged budget, else the global arm;
    the local and rank tables of one model agree, and the choice follows
    window_smem exactly at the budget's edge."""
    hmm = generate_banded_hmm(256, (-1, 2), emit, seed=1)
    sop = StructuredOperator.from_hmm(hmm)
    tp = _port_tp(sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), 8, 2)
    t = tp._local
    assert t.staged == staged
    rank = fused_tp.WindowTables.build(sop.diag_offsets, t.dv, t.em, tp.block, tp.h_lo, tp.h_hi,
                                       1, op_row0=tp.block, ptr_base=0)
    assert rank.staged == staged
    guard = 2  # max|d|
    want = fused_tp.window_smem(True, tp.n_win, 2, emit, guard) <= fused_tp._build.WINDOW_STAGED_SMEM
    assert want == staged
    assert t.smem == fused_tp.window_smem(staged, tp.n_win, 2, emit, guard)
    # the largest emission table that still stages at this window
    fits = (fused_tp._build.WINDOW_STAGED_SMEM // 4 - 4 * 2 * (tp.n_win + 2 * guard)) // tp.n_win - 2
    for e, arm in ((fits, True), (fits + 1, False)):
        em = torch.zeros((e, t.dv.shape[1]))
        built = fused_tp.WindowTables.build(sop.diag_offsets, t.dv, em, tp.block, tp.h_lo, tp.h_hi,
                                            2, op_row0=0, ptr_base=-tp.h_lo)
        assert built.staged == arm, e


def test_window_tables_refuse_odd_geometry():
    _, _, sop, em, pi = _model((1,), seed=1)
    t = _port_tp(sop, em, pi, 8, 2)._local
    with pytest.raises(ValueError, match="even"):
        fused_tp.WindowTables.build(sop.diag_offsets, t.dv, t.em, t.block, t.h_lo - 1, 1, 1,
                                    op_row0=0, ptr_base=0)
    with pytest.raises(ValueError, match="even"):
        fused_tp.WindowTables.build(sop.diag_offsets, t.dv, t.em, t.block - 1, t.h_lo, 0, 1,
                                    op_row0=0, ptr_base=0)


def _bad_loop_inputs():
    """(name, what to break, the error's text): each breaks one tensor the
    chunk loop hands the window kernel."""
    return [
        ("obs", lambda v, obs, ln, bp: (v, obs.long(), ln, bp), "obs: want torch.int32"),
        ("rows", lambda v, obs, ln, bp: (v[1:], obs, ln, bp), "v_in: want torch.float32"),
        ("layout", lambda v, obs, ln, bp: (v.T.contiguous().T, obs, ln, bp), "v_in must be contiguous"),
        ("carry_type", lambda v, obs, ln, bp: (v.double(), obs, ln, bp), "v_in: want torch.float32"),
        ("bp", lambda v, obs, ln, bp: (v, obs, ln, bp.int()), "bp: want torch.int16"),
        ("bp_width", lambda v, obs, ln, bp: (v, obs, ln, bp[:, :, 1:]), "bp: want torch.int16"),
    ]


@pytest.mark.parametrize("name,broken,message", _bad_loop_inputs())
def test_chunk_loop_checks_inputs_once_as_the_wrappers(name, broken, message):
    """The decoder's chunk loop checks its tensors once a call and raises
    what the wrappers raise for the same tensor: the same _check_operands
    message, before any chunk runs."""
    _, _, sop, em, pi = _model((-1, 1), seed=3)
    tp = _port_tp(sop, em, pi, 4, 2)
    st, ln = tp._stage(_seqs(np.random.default_rng(3), [9, 13, 4], 4))
    t = tp._local
    v = tp._em_t[:, st[0].long()] + tp._pi[:, None]
    obs = st[1:]
    bp = torch.empty((obs.shape[0], v.shape[1], tp.n), dtype=torch.int16)
    v_b, obs_b, ln_b, bp_b = broken(v, obs, ln, bp)
    fused.reset_launches()
    with pytest.raises(ValueError) as loop_err:
        tp._run_chunks(t, v_b, obs_b, ln_b, bp_b)
    assert message in str(loop_err.value)
    # the wrappers' own check, on the first chunk's views of the same tensors
    len_c = tp._chunk_lengths(obs.shape[0], ln)
    with pytest.raises(ValueError) as wrapper_err:
        fused_tp._check_operands(t, v_b, obs_b, len_c[0], out=torch.full_like(v_b, np.inf), bp=bp_b)
    assert str(loop_err.value) == str(wrapper_err.value)
    if name == "obs":
        with pytest.raises(ValueError, match=message):
            tp._run_local(st.long(), ln, path=False)


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_solo_rank_window_equals_local_group_on_one_chunk(rank):
    """The window probe's rank form: a rank on a group with no peers runs
    its window as the local group does while no halo exchange is due (one
    chunk): the same interior carry, and its window-local pointers are the
    local group's global ones less rank·block − h_lo (a dead row stores 0
    in both)."""
    from spec_viterbi_tpu_torch.probes.windows import SoloRank

    _, _, sop, em, pi = _model((-1, 2), seed=6)
    local = _port_tp(sop, em, pi, 8, 4)
    solo = FusedTPDecoder(sop, em, pi, SoloRank(rank, 4, "cpu"), chunk=8)
    st, ln = local._stage(_seqs(np.random.default_rng(6), [1, 5, 9, 9], 4))
    carry, bp = local._run_local(st, ln, path=True)
    interior, bp_r = solo._run_rank(st, ln, path=True)
    rows = slice(rank * local.block, (rank + 1) * local.block)
    assert torch.equal(interior, carry[rows])
    glob = bp[:, :, rows].int()
    assert bool(((bp_r.int() + rank * local.block - local.h_lo == glob) | ((bp_r == 0) & (glob == 0))).all())
    assert torch.equal(solo._run_rank(st, ln, path=False)[0], interior)
