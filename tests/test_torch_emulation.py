"""The step orders of the redesigned kernels against the plain versions.

``spec_viterbi_tpu_torch/probes/emulation.py`` repeats, in torch, how
``svt_backtrace`` stages its walk (tiles, bands, misses) and how
``svt_scores_fs`` orders its one-barrier step. On the CPU these tests hold
both to the plain versions of ``ops/fused.py`` (which the kernels equal on
the card), to the numpy oracles, and to the JAX package's decoders run as
its own tests run them on the CPU (the Pallas kernels in interpret mode).
The ``chase`` probe's plain version is held to a numpy walk.
"""

import numpy as np
import pytest
import torch

from test_torch_host import ref_from_port

from spec_viterbi_tpu.hmm import almost_equal_vec
from spec_viterbi_tpu.models.decoder import ViterbiDecoder as RefDecoder
from spec_viterbi_tpu.models.oracle import viterbi_path_oracle as ref_path_oracle
from spec_viterbi_tpu.models.oracle import viterbi_scores_oracle as ref_scores_oracle
from spec_viterbi_tpu.ops import fused_pallas as ref_fused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator

from spec_viterbi_tpu_torch import viterbi_path_oracle
from spec_viterbi_tpu_torch.convert import structured_operator_from_reference
from spec_viterbi_tpu_torch.io.generators import generate_profile_hmm, generate_tie_heavy_hmm
from spec_viterbi_tpu_torch.ops import _build, fused, probes
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.probes import emulation
from test_torch_kernels import capped_fs_tables, far_walk

torch.set_num_threads(1)

W = _build.BT_BAND


def _decoder(hmm):
    sop = StructuredOperator.from_hmm(hmm)
    return fused.FusedStructuredDecoder(sop, hmm.emission_matrix(pad_to=sop.n),
                                        hmm.start_vector(pad_to=sop.n), device="cpu")


def _seqs(rng, lengths, emit):
    return [rng.integers(0, emit, size=int(t)).astype(np.int32) for t in lengths]


def _walk(src, boundary):
    """(emulated rev, misses) after checking rev against backtrace_plain."""
    rev, misses = emulation.backtrace_staged(src, boundary)
    assert torch.equal(rev, fused.backtrace_plain(src, boundary))
    return rev, misses


def _table(steps, lanes, n, fn):
    """[steps, lanes, n] int16 pointers ``fn(state)`` on every row."""
    row = torch.as_tensor(fn(np.arange(n)), dtype=torch.int16)
    return row.expand(steps, lanes, n).contiguous()


# ---- svt_backtrace's staged walk -------------------------------------------


@pytest.mark.parametrize("n,steps", [(1000, 25), (2432, 40), (2432, 130)])
def test_walk_misses_every_step_on_far_jumps(n, steps):
    """Every pointer jumps past every band placed so far and away from
    state 0 (``far_walk``): every step after the first (whose band is
    placed around the boundary state itself) misses; the walk is adrift
    from the second miss on and places no band again."""
    src, bnd = far_walk(steps, 3, n)
    rev, misses = _walk(torch.as_tensor(src, dtype=torch.int16), torch.as_tensor(bnd, dtype=torch.int32))
    assert misses.tolist() == [steps - 1] * 3


def test_walk_adrift_then_settled_places_bands_again():
    """Pointers that alternate between two far states, then settle into a
    descending chain: while alternating, a miss right after a missed jump
    only reads its pointer (so the band placed at the miss before is
    still there for the state after: hit, miss, miss in turn); once the
    chain settles, its misses place the bands again and the walk hits to
    the end but for at most two misses."""
    steps, n = 120, 2432
    src = _table(steps, 2, n, lambda s: np.maximum(s - 1, 0)).clone()
    for r in range(steps - 40, steps):  # the first 40 steps alternate between 300 and 1800
        src[r, :, 300], src[r, :, 1800] = 1800, 300
    bnd = torch.tensor([300, 1800], dtype=torch.int32)
    rev, misses = _walk(src, bnd)
    _, alone = _walk(src[steps - 40 :].contiguous(), bnd)
    assert alone.tolist() == [26, 26]  # 13 times miss, miss, hit after the first hit
    assert ((misses - alone) <= 2).all()
    assert rev[: steps - 41].diff(dim=0).eq(1).all()


@pytest.mark.parametrize("steps,lanes,n", [(1, 1, 2), (3, 2, 5), (9, 2, 40), (50, 3, 300), (97, 4, 2432)])
def test_walk_identity_pointers_never_miss(steps, lanes, n):
    """Identity pointers (a lane past its length) keep the state: the
    drift is 0 and every step hits, also at n below the band's width. A
    tensor smaller than one band stages nothing, and every step reads the
    tensor itself."""
    src = _table(steps, lanes, n, lambda s: s)
    bnd = torch.as_tensor(np.arange(lanes) * 7 % n, dtype=torch.int32)
    rev, misses = _walk(src, bnd)
    banded = steps * lanes * n >= W + 8
    assert misses.tolist() == [0 if banded else steps] * lanes
    assert (rev == bnd[None, :]).all()


def test_walk_jumps_to_zero_hit_the_hub():
    """A descending chain that drops to state 0 every 20 steps and climbs
    back: the drops land in the hub chunk of state 0, only the jumps up
    miss."""
    steps, n = 200, 2432
    src = torch.empty((steps, 2, n), dtype=torch.int16)
    for r in range(steps):
        down = np.maximum(np.arange(n) - 1, 0)
        if r % 20 == 0:
            down[:] = 0  # drop to 0
        elif r % 20 == 19:
            down[:] = 1500  # from 0 up to 1500
        src[r] = torch.as_tensor(down, dtype=torch.int16)
    rev, misses = _walk(src, torch.tensor([1700, 1500], dtype=torch.int32))
    ups = sum(1 for r in range(steps - 1) if r % 20 == 19)
    assert (misses <= ups + 2).all() and (misses > 0).all()


@pytest.mark.parametrize("drift", [1, -1])
def test_walk_band_edges_at_rows_0_and_last(drift):
    """Chains that climb into the last state or fall into state 0 and stay:
    the band is held inside the row at both edges and the walk hits."""
    n = 500
    src = _table(300, 2, n, lambda s: np.clip(s + drift, 0, n - 1))
    start = torch.tensor([n - 150, n - 250] if drift > 0 else [150, 250], dtype=torch.int32)
    rev, misses = _walk(src, start)
    assert (misses <= 2).all()
    assert set(rev[0].tolist()) == {n - 1 if drift > 0 else 0}


def test_walk_frozen_lanes_then_chains():
    """Identity pointers on a lane's frozen steps (the end of the tensor)
    and a chain below them, lanes frozen for different spans."""
    steps, lanes, n = 120, 4, 900
    src = _table(steps, lanes, n, lambda s: np.maximum(s - 1, 0)).clone()
    for b, frozen in enumerate((0, 5, 33, 119)):
        src[steps - frozen :, b] = torch.arange(n, dtype=torch.int16)
    rev, misses = _walk(src, torch.tensor([800, 700, 600, 500], dtype=torch.int32))
    assert (misses <= 2).all()


def test_walk_random_pointers_and_unaligned_tensor():
    """Random pointers, and a tensor that starts 2 bytes past a 16-byte
    boundary with n not a multiple of 8: the bands follow the addresses
    and the path is unchanged."""
    g = torch.Generator().manual_seed(0)
    n = 301
    base = torch.randint(0, n, (60 * 5 * n + 1,), generator=g, dtype=torch.int16)
    src = base[1:].view(60, 5, n)
    assert (src.data_ptr() // 2) % 8 != (base.data_ptr() // 2) % 8
    bnd = torch.randint(0, n, (5,), generator=g).to(torch.int32)
    _, misses = _walk(src, bnd)
    assert (misses > 0).all()


@pytest.mark.parametrize("model", ["profile", "tie_heavy"])
def test_walk_of_path_decode_pointers_equals_oracle(model):
    """The path kernels' pointers (plain versions) of seeded models,
    uniform and ragged: the emulated walk equals backtrace_plain, its paths
    the port's and the JAX package's oracles."""
    hmm = generate_profile_hmm(200, seed=3) if model == "profile" else generate_tie_heavy_hmm(300, seed=1)
    fd = _decoder(hmm)
    rng = np.random.default_rng(5)
    for lengths in ([90] * 4, [1, 2, 40, 90, 77]):
        seqs = _seqs(rng, lengths, hmm.emit_num - 1)
        st, ln, masked = fd.prepare(seqs)
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        out, src = fused.path(fd._path_arm, fd.em, v0, st[1:], ln if masked else None)
        last = torch.argmin(out, dim=0).to(torch.int32)
        rev, _ = _walk(src, last)
        paths = torch.cat([rev, last[None]], dim=0).T.numpy()
        ref = ref_from_port(hmm)
        for s, p in zip(seqs, paths):
            _, want = viterbi_path_oracle(hmm, s)
            np.testing.assert_array_equal(p[: len(s)], want)
            np.testing.assert_array_equal(p[: len(s)], ref_path_oracle(ref, s)[1])


def test_walk_equals_jax_path_decode_in_interpret_mode():
    """The emulated walk over the port's pointers gives the JAX Pallas
    path decoder's paths (interpret mode)."""
    model = ref_from_port(generate_profile_hmm(126, seed=3))
    ref_sop = RefOperator.from_hmm(model)
    em = model.emission_matrix(pad_to=ref_sop.n)
    pi = model.start_vector(pad_to=ref_sop.n)
    jax_dec = ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)
    fd = fused.FusedStructuredDecoder(structured_operator_from_reference(ref_sop), em, pi, device="cpu")
    seqs = _seqs(np.random.default_rng(9), [24] * 3, 20)
    st, _, _ = fd.prepare(seqs)
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    out, src = fused.path(fd._path_arm, fd.em, v0, st[1:], None)
    last = torch.argmin(out, dim=0).to(torch.int32)
    rev, _ = _walk(src, last)
    paths = torch.cat([rev, last[None]], dim=0).T.numpy()
    for p, (_, want) in zip(paths, jax_dec.decode_path_batch(seqs)):
        np.testing.assert_array_equal(p, want)


def test_walk_of_one_step_reads_the_boundary_band():
    """The first tile's bands are placed around the boundary states, so a
    one-step walk hits whatever its pointers say."""
    n = 700
    src = _table(1, 2, n, lambda s: (s + 350) % n)
    rev, misses = _walk(src, torch.tensor([100, 600], dtype=torch.int32))
    assert misses.tolist() == [0, 0] and rev[0].tolist() == [450, 250]


# ---- svt_scores_fs's one-barrier step --------------------------------------


def _fs_pair(model):
    ref_sop = RefOperator.from_hmm(model)
    em = model.emission_matrix(pad_to=ref_sop.n)
    pi = model.start_vector(pad_to=ref_sop.n)
    jax_dec = ref_fused.FusedStructuredDecoder(ref_sop, em, pi, interpret=True)
    fd = fused.FusedStructuredDecoder(structured_operator_from_reference(ref_sop), em, pi, device="cpu")
    return jax_dec, fd


@pytest.mark.parametrize("b,t", [(1, 2), (3, 17), (40, 24), (130, 9)])
def test_one_barrier_step_equals_plain_and_jax(b, t):
    """On the models of test_torch_fused.py: bit-equal to scores_fs_plain,
    the oracle and the JAX XLA structured path; within almost_equal_vec of
    the JAX FS kernel in interpret mode (its bf16 emission split)."""
    model = ref_from_port(generate_profile_hmm(126, seed=b))
    jax_dec, fd = _fs_pair(model)
    assert fd._fs_ok and jax_dec._fs_ok
    seqs = _seqs(np.random.default_rng(b), [t] * b, 20)
    st, _, masked = fd.prepare(seqs)
    assert not masked
    v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
    got = emulation.scores_fs_one_barrier(fd._fs, fd.em_t, v0, st[1:])
    assert torch.equal(got, fused.scores_fs_plain(fd._fs, fd.em_t, v0, st[1:]))
    got = got.T[:, : model.states_num].numpy()
    xla = RefDecoder(model, mode="structured", use_pallas=False).decode_batch(seqs)
    for g, x, p, s in zip(got, xla, jax_dec.decode_batch(seqs), seqs):
        np.testing.assert_array_equal(g, x)
        np.testing.assert_array_equal(g, ref_scores_oracle(model, s))
        assert almost_equal_vec(g, p)


@pytest.mark.parametrize("n_uni,n_special", [(2, 4), (_build.MAX_UNI, _build.MAX_SPECIAL)])
def test_one_barrier_step_at_the_caps(n_uni, n_special):
    """A row that is both a uniform-row source and special, and the
    uniform rows and special rows at the kernel's caps: bit-equal to
    scores_fs_plain."""
    hmm, sop, t = capped_fs_tables(n_uni, n_special, seed=n_uni)
    flags = t.flags.long()
    both = int(t.uni_src[0])
    assert flags[both] & _build.ST_SPECIAL
    assert (flags & _build.ST_SPECIAL).bool().sum() == n_special
    em_t = torch.as_tensor(hmm.emission_matrix(pad_to=sop.n)).T.contiguous()
    rng = np.random.default_rng(n_special)
    v0 = torch.as_tensor(rng.uniform(0.0, 30.0, size=(sop.n, 6)).astype(np.float32))
    v0[sop.states_num :] = float("inf")
    obs = torch.as_tensor(rng.integers(0, hmm.emit_num, size=(33, 6)).astype(np.int32))
    got = emulation.scores_fs_one_barrier(t, em_t, v0, obs)
    assert torch.equal(got, fused.scores_fs_plain(t, em_t, v0, obs))
    assert torch.isfinite(got[: sop.states_num]).all()


def test_fs_flags_mark_special_rows():
    """FsTables.build sets ST_SPECIAL on every special row and ST_USE_ACC on
    those that start from the bulk candidate; the planned arms' bits are
    unchanged."""
    fd = _decoder(generate_profile_hmm(126, seed=4))
    t = fd._fs
    flags = t.flags.long()
    sp = t.sp_row.tolist()
    assert sorted(torch.nonzero(flags & _build.ST_SPECIAL)[:, 0].tolist()) == sorted(sp)
    use = [r for r, a in zip(sp, t.sp_use_acc.tolist()) if a]
    assert sorted(torch.nonzero(flags & _build.ST_USE_ACC)[:, 0].tolist()) == sorted(use)
    shared = (flags & _build.ST_SHARED).bool()
    bulk = shared.clone()
    bulk[sp] = False
    assert torch.equal((flags & _build.ST_BULK).bool(), bulk)


# ---- the chase probe -------------------------------------------------------


@pytest.mark.parametrize("cls,p", [("chase", 1), ("chase", 5), ("chase_hbm", 1), ("chase_hbm", 3)])
def test_chase_plain_equals_numpy_walk(cls, p):
    """The chase classes' plain version walks p hops a step from state
    b mod n, through one table or through rows (t p + k) mod R, and leaves
    the carry's other rows as they were."""
    rng = np.random.default_rng(p)
    n, lanes, steps = 53, 6, 7
    v0 = torch.as_tensor(rng.normal(5, 1, size=(n, lanes)).astype(np.float32))
    if cls == "chase":
        tab = rng.permutation(n).astype(np.int16)
    else:
        tab = rng.integers(0, n, size=(5, lanes, n)).astype(np.int16)
    got = probes.probe_pass(cls, v0, steps, tab=torch.as_tensor(tab), p=p)
    state = np.arange(lanes) % n
    for t in range(steps):
        for k in range(p):
            state = tab[state] if cls == "chase" else tab[(t * p + k) % 5, np.arange(lanes), state]
    assert got[0].tolist() == state.astype(np.float32).tolist()
    assert torch.equal(got[1:], v0[1:])


def test_chase_refuses_what_the_kernel_cannot_walk():
    v0 = torch.zeros((10, 2))
    with pytest.raises(ValueError, match="walks tab"):
        probes.probe_pass("chase", v0, 3, p=1)
    with pytest.raises(ValueError, match="passes"):
        probes.probe_pass("chase", v0, 3, tab=torch.zeros(10, dtype=torch.int16), p=0)
    with pytest.raises(ValueError, match="lanes_per_cta"):
        probes.probe_pass("chase", v0, 3, tab=torch.zeros(10, dtype=torch.int16), p=1, lanes_per_cta=2)


def test_chase_floor_and_bound_conventions():
    """The chase bound counts a 2-byte read a hop (and the shared table
    once), no operations; the hop constants are what the kernel takes."""
    from spec_viterbi_tpu_torch.probes import bounds, laneblock

    w = bounds.probe_pass("chase", 2432, 256, 3499, 4)
    assert w.ops == 0.0 and w.bytes == 2 * 2432 * 256 * 4 + 3499 * 4 * 256 * 2 + 2432 * 2
    h = bounds.probe_pass("chase_hbm", 2432, 256, 3499, 1)
    assert h.bytes == 2 * 2432 * 256 * 4 + 3499 * 256 * 2
    assert max(max(v) for v in laneblock.CHASE_HOPS.values()) <= probes.CHASE_HOPS
    assert W % 8 == 0
