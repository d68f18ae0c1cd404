"""The port's dense DP, TP and DP × TP decodes, its fused DP pair and
``StreamDP`` against the JAX package.

A seeded profile model of 102 states (``generate_profile_hmm(100)``, padded
to 128) and sequences of 37-129 symbols (the lengths of the JAX package's
``tests/test_parallel.py``) go through the port's entry points on local
groups and grids on the CPU, where ``svt_minplus`` and the fused kernels run
their plain versions (the kernels are held to them on a card by
``tests/test_torch_kernels.py``), and through the JAX functions on the
virtual 8-device CPU mesh.

- Dense scores are bit-equal to the JAX XLA entry points and to the
  port's unsharded dense decoder.
- ``StreamDP`` scores are bit-equal to the port's single-device stream
  and within ``almost_equal_vec`` of the JAX ``StreamDP`` (Pallas in
  interpret mode, with its bf16 emission split); its paths equal the JAX
  ``StreamDP``'s and ``viterbi_path_oracle``'s.
- The dense SP (``decode_time_parallel``) is bit-equal to the JAX
  function on a ``time`` mesh of as many devices (the same block split and
  products) and within ``almost_equal_vec`` of the oracle.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_host import ref_from_port

import spec_viterbi_tpu.parallel as ref_parallel
from spec_viterbi_tpu.hmm import almost_equal_vec
from spec_viterbi_tpu.models.decoder import DeviceHMM as RefDeviceHMM
from spec_viterbi_tpu.ops.fused_pallas import FusedStructuredDecoder as RefFused
from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
from spec_viterbi_tpu.parallel import make_mesh

import spec_viterbi_tpu_torch.parallel as parallel
from spec_viterbi_tpu_torch.hmm import pad_to_lane
from spec_viterbi_tpu_torch import ViterbiDecoder, viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi_tpu_torch.io.generators import (
    generate_banded_hmm,
    generate_profile_hmm,
    generate_random_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.models.decoder import DeviceHMM
from spec_viterbi_tpu_torch.ops import tropical
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.parallel import (
    DATA_AXIS,
    TIME_AXIS,
    StreamDP,
    decode_batch_dp,
    decode_batch_dp_fused,
    decode_batch_dp_tp,
    decode_path_batch_dp_fused,
    decode_time_parallel,
    decode_tp,
    make_fused_dp,
    make_grid,
    make_group,
    state_block,
)

torch.set_num_threads(1)

LENGTHS = (37, 64, 129)  # tests/test_parallel.py's production-model lengths
RAGGED = (37, 64, 129, 1, 2, 90, 41)


@pytest.fixture(scope="module")
def model():
    """(port HMM, JAX HMM, port dense DeviceHMM, JAX DeviceHMM, the port's
    unsharded dense decoder)."""
    hmm = generate_profile_hmm(100, seed=11)
    ref = ref_from_port(hmm)
    return (hmm, ref, DeviceHMM.from_hmm(hmm, device="cpu"), RefDeviceHMM.from_hmm(ref),
            ViterbiDecoder(hmm, mode="dense", device="cpu"))


def _seqs(hmm, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32) for t in lengths]


def _bit_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), i


def test_exports_cover_the_jax_package():
    """Every name of the JAX ``parallel`` package has a counterpart, but
    the JAX sharding helpers."""
    skip = {"batch_sharding", "replicated"}
    counterpart = {"make_mesh": "make_grid"}
    for name in ref_parallel.__all__:
        if name not in skip:
            assert counterpart.get(name, name) in parallel.__all__, name
            assert hasattr(parallel, counterpart.get(name, name)), name


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_dp_matches_jax_and_unsharded(model, shards):
    hmm, _, dev, ref_dev, dec = model
    for lengths, seed in ((LENGTHS, 7), (RAGGED, 8)):
        seqs = _seqs(hmm, lengths, seed)
        got = decode_batch_dp(dev, seqs, make_group("cpu", shards, axis=DATA_AXIS))
        _bit_equal(got, ref_parallel.decode_batch_dp(ref_dev, seqs, make_mesh(data=shards)))
        _bit_equal(got, dec.decode_batch(seqs, bucketed=False))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_tp_matches_jax_and_unsharded(model, shards):
    hmm, _, dev, ref_dev, dec = model
    group = make_group("cpu", shards)
    mesh = make_mesh(state=shards)
    for s in _seqs(hmm, (*LENGTHS, 1, 2), 9):
        got = decode_tp(dev, s, group)
        assert np.array_equal(got, np.asarray(ref_parallel.decode_tp(ref_dev, s, mesh)))
        assert np.array_equal(got, dec.decode(s))
        assert np.array_equal(got, viterbi_scores_oracle(hmm, s))


@pytest.mark.parametrize("data,state", [(2, 2), (4, 2), (2, 4)])
def test_dp_tp_matches_jax_and_unsharded(model, data, state):
    hmm, _, dev, ref_dev, dec = model
    grid = make_grid("cpu", data, state)
    assert grid.shape == {"data": data, "state": state}
    for lengths, seed in ((LENGTHS, 10), (RAGGED, 12)):
        seqs = _seqs(hmm, lengths, seed)
        got = decode_batch_dp_tp(dev, seqs, grid)
        _bit_equal(got, ref_parallel.decode_batch_dp_tp(ref_dev, seqs, make_mesh(data=data, state=state)))
        _bit_equal(got, dec.decode_batch(seqs, bucketed=False))


def test_dense_entry_points_count_their_launches(model, monkeypatch):
    """One ``svt_minplus`` step a shard a step: dense DP one a data shard,
    TP one a state shard, DP × TP one a block; nothing else is called."""
    hmm, _, dev, _, _ = model
    calls = []
    for name in ("dense_step", "dense_step_mv"):
        real = getattr(tropical, name)
        monkeypatch.setattr(tropical, name, lambda *a, _r=real, _n=name, **k: calls.append(
            (_n, tuple(a[0].shape), k.get("row0"))) or _r(*a, **k))
    seqs = _seqs(hmm, (20, 20, 20), 3)
    decode_batch_dp(dev, seqs, make_group("cpu", 2, axis=DATA_AXIS))
    assert calls == [("dense_step", (128, 128), None)] * 38
    calls.clear()
    decode_tp(dev, seqs[0], make_group("cpu", 4))
    assert calls == [("dense_step_mv", (32, 128), None)] * 76
    calls.clear()
    decode_batch_dp_tp(dev, seqs, make_grid("cpu", 2, 2))
    assert calls == [("dense_step", (64, 128), r) for _ in range(2) for _ in range(19) for r in (0, 64)]


def test_dense_step_row0_block_equals_plain_and_square_rows():
    """``dense_step`` with ``row0`` on a rectangular row block equals
    ``dense_step_plain`` and the square step's rows, masked lanes keeping
    the carry's rows from ``row0``."""
    rng = np.random.default_rng(5)
    n, lanes = 96, 11
    a = torch.as_tensor(rng.integers(0, 4, size=(n, n)).astype(np.float32))
    a[rng.uniform(size=a.shape) < 0.2] = float("inf")
    v = torch.as_tensor(rng.integers(0, 9, size=(n, lanes)).astype(np.float32))
    em_t = torch.as_tensor(rng.integers(0, 3, size=(n, 5)).astype(np.float32))
    obs = torch.as_tensor(rng.integers(0, 5, size=(8, lanes)).astype(np.int32))
    lengths = torch.as_tensor(np.resize(np.array([0, 1, 4, 5, 6, 8], np.int32), lanes))
    square = tropical.dense_step(a.T, v, em_t, obs, lengths, 5, torch.empty_like(v))
    for row0, rows in ((0, 32), (32, 32), (40, 56), (95, 1)):
        blk = slice(row0, row0 + rows)
        out = torch.full((rows, lanes), -1.0)
        tropical.dense_step(a.T[blk], v, em_t[blk], obs, lengths, 5, out, row0=row0)
        assert torch.equal(out, tropical.dense_step_plain(a.T[blk], v, em_t[blk], obs, lengths, 5, row0))
        assert torch.equal(out, square[blk])
        assert torch.equal(out[:, lengths <= 5], v[blk][:, lengths <= 5])


def test_sharded_entry_points_check_their_groups(model):
    hmm, _, dev, _, _ = model
    seqs = _seqs(hmm, (5, 6), 1)
    with pytest.raises(ValueError, match="'data' axis"):
        decode_batch_dp(dev, seqs, make_group("cpu", 2))
    with pytest.raises(ValueError, match="'state' axis"):
        decode_tp(dev, seqs[0], make_group("cpu", 2, axis=DATA_AXIS))
    with pytest.raises(ValueError, match="not divisible"):
        decode_tp(dev, seqs[0], make_group("cpu", 3))
    with pytest.raises(ValueError, match="dense DeviceHMM"):
        decode_tp(DeviceHMM.from_hmm(hmm, dense=False, device="cpu"), seqs[0], make_group("cpu", 2))
    with pytest.raises(ValueError, match="a grid takes"):
        parallel.Grid(make_group("cpu", 2), make_group("cpu", 2))
    assert decode_batch_dp(dev, [], make_group("cpu", 2, axis=DATA_AXIS)) == []
    assert decode_batch_dp_tp(dev, [], make_grid("cpu", 2, 2)) == []


def test_dense_tp_takes_the_rows_its_shards_own(model):
    """A local group's shards own every row: ``state_block`` is the whole
    model, and an operator of fewer rows than the process's shards own
    (a rank's block given to a local group) is refused."""
    hmm, _, dev, _, _ = model
    group = make_group("cpu", 4)
    whole = state_block(hmm, group, device="cpu")
    for name in ("a_t", "a", "pi", "emissions"):
        assert torch.equal(getattr(whole, name), getattr(dev, name)), name
    nb = dev.padded // 4
    block = dataclasses.replace(dev, a_t=dev.a_t[:nb], a=dev.a[:, :nb], pi=dev.pi[:nb],
                                emissions=dev.emissions[:, :nb])
    seqs = _seqs(hmm, (9, 4), 2)
    with pytest.raises(ValueError, match="state_block"):
        decode_tp(block, seqs[0], group)
    with pytest.raises(ValueError, match="state_block"):
        decode_batch_dp_tp(block, seqs, make_grid("cpu", 2, 4))


def test_dense_sharding_on_a_dense_class_model():
    """A random dense-class model (every state reaches 40 others): the
    sharded dense decodes equal the oracle bit for bit."""
    hmm = generate_random_hmm(150, trans_per_state=40, emit_range=6, seed=2)
    dev = DeviceHMM.from_hmm(hmm, device="cpu")
    seqs = _seqs(hmm, (40, 3, 17), 4)
    want = [viterbi_scores_oracle(hmm, s) for s in seqs]
    _bit_equal(decode_batch_dp(dev, seqs, make_group("cpu", 4, axis=DATA_AXIS)), want)
    _bit_equal([decode_tp(dev, s, make_group("cpu", 8)) for s in seqs], want)
    _bit_equal(decode_batch_dp_tp(dev, seqs, make_grid("cpu", 2, 4)), want)


# ---- fused DP and StreamDP -------------------------------------------------


@pytest.fixture(scope="module")
def fused_pair(model):
    """(port FusedStructuredDecoder on the CPU, the JAX one in interpret mode)."""
    hmm, ref, *_ = model
    sop = StructuredOperator.from_hmm(hmm)
    ref_sop = RefOperator.from_hmm(ref)
    return (FusedStructuredDecoder(sop, hmm.emission_matrix(pad_to=sop.n),
                                   hmm.start_vector(pad_to=sop.n), device="cpu"),
            RefFused(ref_sop, ref.emission_matrix(pad_to=ref_sop.n),
                     ref.start_vector(pad_to=ref_sop.n), interpret=True))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_make_fused_dp_pair_equals_entry_points(model, fused_pair, shards):
    """The pair ``make_fused_dp`` hands out is kept on the decoder and is
    what the fused DP entry points run: global [T, B] in, gathered out."""
    hmm = model[0]
    fd, _ = fused_pair
    group = make_group("cpu", shards, axis=DATA_AXIS)
    scores_fn, path_fn = make_fused_dp(fd, group)
    assert make_fused_dp(fd, group) == (scores_fn, path_fn)
    assert make_fused_dp(fd, group, masked=False)[0] is not scores_fn
    seqs = _seqs(hmm, (9, 30, 2, 17), 2)
    seqs_t, lengths, _ = fd.prepare(seqs)
    scores = scores_fn(seqs_t, lengths)
    sc, paths = path_fn(seqs_t, lengths)
    assert tuple(scores.shape) == (fd.n, 4) and tuple(paths.shape) == (30, 4)
    want = fd.decode_batch(seqs, bucketed=False)
    _bit_equal(scores.T[:, : fd.states_num], want)
    _bit_equal(sc.T[:, : fd.states_num], want)
    _bit_equal([p[: len(s)] for p, s in zip(paths.T, seqs)],
               [p for _, p in decode_path_batch_dp_fused(fd, seqs, group)])
    _bit_equal(decode_batch_dp_fused(fd, seqs, group), want)


def _stream(eng, block, splits, begin, feed, valid=None):
    st = begin(block[0])
    pos = 1
    for w in splits:
        st = feed(st, block[pos : pos + w]) if valid is None else feed(
            st, block[pos : pos + w], valid=np.clip(valid - pos, 0, w))
        pos += w
    return st


@pytest.mark.parametrize("shards", [2, 4])
def test_stream_dp_scores_match_jax_and_single_device(model, fused_pair, shards):
    hmm = model[0]
    fd, ref = fused_pair
    rng = np.random.default_rng(41)
    block = rng.integers(0, hmm.emit_num, size=(30, 3)).astype(np.int32)
    splits = (8, 0, 13, 8)
    sdp = StreamDP(fd, make_group("cpu", shards, axis=DATA_AXIS))
    st = _stream(fd, block, splits, sdp.begin, sdp.feed)
    got = sdp.scores(st)
    assert len(st.carry) == shards and st.carry[0].shape == (fd.n, 128)  # 128 lanes a shard
    want = fd.stream_scores(_stream(fd, block, splits, fd.stream_begin, fd.stream_feed))
    assert np.array_equal(got, want)
    ref_dp = ref_parallel.StreamDP(ref, make_mesh(data=shards))
    ref_got = ref_dp.scores(_stream(ref, block, splits, ref_dp.begin, ref_dp.feed))
    for i in range(block.shape[1]):
        assert almost_equal_vec(got[i], np.asarray(ref_got[i, : hmm.states_num])), i
        assert np.array_equal(got[i], viterbi_scores_oracle(hmm, block[:, i])), i


def test_stream_dp_paths_match_jax_single_device_and_oracle(model, fused_pair):
    hmm = model[0]
    fd, ref = fused_pair
    rng = np.random.default_rng(43)
    block = rng.integers(0, hmm.emit_num, size=(41, 2)).astype(np.int32)
    sdp = StreamDP(fd, make_group("cpu", 2, axis=DATA_AXIS))
    st = _stream(fd, block, (17, 23), sdp.begin_path, sdp.feed_path)
    assert np.array_equal(sdp.path_scores(st), sdp.scores(st))
    scores, paths = sdp.path_finalize(st)
    assert paths.shape == (2, 41)
    w_scores, w_paths = fd.stream_path_finalize(
        _stream(fd, block, (17, 23), fd.stream_begin_path, fd.stream_feed_path))
    assert np.array_equal(scores, w_scores) and np.array_equal(paths, w_paths)
    ref_dp = ref_parallel.StreamDP(ref, make_mesh(data=2))
    r_scores, r_paths = ref_dp.path_finalize(_stream(ref, block, (17, 23), ref_dp.begin_path,
                                                     ref_dp.feed_path))
    for i in range(2):
        want, opath = viterbi_path_oracle(hmm, block[:, i])
        assert np.array_equal(scores[i], want) and np.array_equal(paths[i], opath), i
        assert almost_equal_vec(scores[i], np.asarray(r_scores[i, : hmm.states_num])), i
        assert np.array_equal(paths[i], np.asarray(r_paths[i])), i


def test_stream_dp_ragged_lanes_and_budget(model, fused_pair):
    """Ragged valid counts: each lane's path is the oracle's up to its
    length; a chunk past a shard's pointer budget is refused, one that
    fits a shard's lanes is taken."""
    hmm = model[0]
    fd, _ = fused_pair
    rng = np.random.default_rng(44)
    lens = np.array([40, 7, 1, 25, 33])
    block = rng.integers(0, hmm.emit_num, size=(40, 5)).astype(np.int32)
    sdp = StreamDP(fd, make_group("cpu", 4, axis=DATA_AXIS))
    st = _stream(fd, block, (20, 19), sdp.begin_path, sdp.feed_path, valid=lens)
    scores, paths = sdp.path_finalize(st)
    for i, t in enumerate(lens):
        want, opath = viterbi_path_oracle(hmm, block[:t, i])
        assert np.array_equal(scores[i], want) and np.array_equal(paths[i, :t], opath), i
    budget = fd.MAX_PATH_BYTES
    try:
        # one shard's 128 lanes x 64 quantized steps fit; no more
        fd.MAX_PATH_BYTES = 64 * fd.n * 128 * 2
        st = sdp.feed_path(sdp.begin_path(block[0]), block[1:40])
        with pytest.raises(ValueError, match="backpointer budget"):
            sdp.feed_path(st, np.zeros((100, 5), np.int32))
    finally:
        fd.MAX_PATH_BYTES = budget
    with pytest.raises(ValueError, match="empty lane set"):
        sdp.begin(np.zeros(0, np.int32))


def test_ops_exports_cover_the_jax_package():
    """The port's ``ops`` exports the JAX package's five tropical functions."""
    import spec_viterbi_tpu.ops as ref_ops

    import spec_viterbi_tpu_torch.ops as ops

    for name in ref_ops.__all__:
        assert name in ops.__all__ and getattr(ops, name) is getattr(tropical, name), name


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_time_parallel_matches_jax_and_oracle(model, shards):
    hmm, ref, _, _, _ = model
    group = make_group("cpu", shards, axis=TIME_AXIS)
    mesh = make_mesh(time=shards)
    for s in _seqs(hmm, (*LENGTHS, 1, 2, shards + 1), 12):
        got = decode_time_parallel(hmm, s, group)
        assert np.array_equal(got, np.asarray(ref_parallel.decode_time_parallel(ref, s, mesh))), len(s)
        assert almost_equal_vec(got, viterbi_scores_oracle(hmm, s)), len(s)


@pytest.mark.parametrize("name", ["banded_unreachable", "tie_heavy_dead_symbol"])
def test_time_parallel_unreachable_states(name):
    """+inf (unreachable states) survives block composition: a +1-chain
    entered at 8 states (later states unreachable for t steps) and the
    tie-heavy model, whose dead symbol drives every score to +inf."""
    if name == "banded_unreachable":
        hmm = generate_banded_hmm(128, (1,), 4, seed=7)
        seqs = _seqs(hmm, (5, 37, 64), 13)
    else:
        hmm = generate_tie_heavy_hmm(60, seed=4)
        seqs = _seqs(hmm, (5, 37, 64), 14)
        seqs[1][20] = hmm.emit_num - 1  # the dead symbol
    ref = ref_from_port(hmm)
    for shards in (2, 4):
        group = make_group("cpu", shards, axis=TIME_AXIS)
        for s in seqs:
            got = decode_time_parallel(hmm, s, group)
            want = viterbi_scores_oracle(hmm, s)
            assert np.isinf(got).any() and np.array_equal(np.isinf(got), np.isinf(want)), len(s)
            assert almost_equal_vec(got, want), len(s)
            ref_got = ref_parallel.decode_time_parallel(ref, s, make_mesh(time=shards))
            assert np.array_equal(got, np.asarray(ref_got)), len(s)


def test_time_parallel_checks_its_group_and_sequence(model, monkeypatch):
    """SP takes a ``time`` group and a non-empty sequence; it launches one
    product a symbol of each shard's padded block and one fold step a shard."""
    hmm = model[0]
    s = _seqs(hmm, (10,), 15)[0]
    with pytest.raises(ValueError, match="'time' axis"):
        decode_time_parallel(hmm, s, make_group("cpu", 2))
    with pytest.raises(ValueError, match="empty"):
        decode_time_parallel(hmm, s[:0], make_group("cpu", 2, axis=TIME_AXIS))
    calls = []
    plain = tropical.minplus

    def counted(a, b, *args, **kwargs):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return plain(a, b, *args, **kwargs)

    monkeypatch.setattr(tropical, "minplus", counted)
    n = pad_to_lane(hmm.states_num)
    decode_time_parallel(hmm, s, make_group("cpu", 4, axis=TIME_AXIS))
    # 9 symbols after the first: blocks of 3, padded with 3 identities
    assert calls == [((1, n, n), (1, n, n))] * 12 + [((1, n, n), (1, n, 1))] * 4
