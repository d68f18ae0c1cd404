"""TP and DP across processes: 2 and 4 gloo ranks on the CPU.

Each world is one spawn of ranks (``torch_parallel_workers.run_rank``)
that meet through a ``file://`` rendezvous under the test's temporary
directory, so parallel test workers never race for a port. Every rank
decodes the same batches through a ``DistributedGroup``: the TP decoder
(halo exchange, all-gathered scores, the min-reduce backtrace) and the DP
entry points (lanes split over the ranks, results all-gathered), and the
dense time-parallel decode (one time block a rank). The
checks hold the ranks' results bit-equal to one process: the TP decoder
on a local group, and the unsharded ``FusedStructuredDecoder``. Each
spawn has its own time limit; ranks still alive at its end are killed
and the test fails.
"""

import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers

from spec_viterbi_tpu_torch import viterbi_path_oracle
from spec_viterbi_tpu_torch.hmm import pad_to_lane
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder
from spec_viterbi_tpu_torch.parallel import (
    FusedTPDecoder,
    init_distributed,
    make_group,
    process_info,
)

torch.set_num_threads(1)

SPAWN_SECONDS = 120  # one spawn takes a few seconds


def _spawn(world: int, out_dir) -> list[dict]:
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=workers.run_rank, args=(r, world, str(out_dir / "rendezvous"), str(out_dir)))
        for r in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_SECONDS
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    if hung:
        pytest.fail(f"ranks {hung} of {world} still running after {SPAWN_SECONDS} s; killed")
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def world(request, tmp_path_factory):
    """(world size, each rank's results), one spawn per world size."""
    size = request.param
    return size, _spawn(size, tmp_path_factory.mktemp(f"gloo{size}"))


def _tp_local(size):
    hmm, sop, chunk = workers.tp_model(size)
    tp = FusedTPDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n),
        make_group("cpu", size), chunk=chunk,
    )
    return hmm, tp, workers.sequences(hmm.emit_num, workers.tp_lengths(chunk), seed=size)


def _dp_single():
    hmm, sop = workers.dp_model()
    fd = FusedStructuredDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device="cpu"
    )
    return fd, {
        name: workers.sequences(hmm.emit_num, lengths, seed=5)
        for name, lengths in (("ragged", workers.DP_LENGTHS), ("uniform", [24] * len(workers.DP_LENGTHS)))
    }


def test_every_rank_returns_the_full_result(world):
    size, ranks = world
    for r, res in enumerate(ranks):
        assert res["process"].tolist() == [r, size]
        assert res.keys() == ranks[0].keys()
        for key, value in res.items():
            if key != "process":
                assert np.array_equal(value, ranks[0][key]), (r, key)


def test_tp_scores_equal_local_group(world):
    size, ranks = world
    _, tp, seqs = _tp_local(size)
    for i, want in enumerate(tp.decode_batch(seqs)):
        assert np.array_equal(ranks[0][f"tp_scores_{i}"], want), i


def test_tp_paths_equal_local_group_and_oracle(world):
    size, ranks = world
    hmm, tp, seqs = _tp_local(size)
    for i, ((sc, pa), s) in enumerate(zip(tp.decode_path_batch(seqs), seqs)):
        assert np.array_equal(ranks[0][f"tp_path_scores_{i}"], sc), i
        assert np.array_equal(ranks[0][f"tp_path_{i}"], pa), i
        want_sc, want_pa = viterbi_path_oracle(hmm, s)
        assert np.array_equal(pa, want_pa) and np.array_equal(sc, want_sc), i


def test_dp_scores_equal_single_process(world):
    _, ranks = world
    fd, batches = _dp_single()
    for name, seqs in batches.items():
        for i, want in enumerate(fd.decode_batch(seqs, bucketed=False)):
            assert np.array_equal(ranks[0][f"dp_{name}_scores_{i}"], want), (name, i)


def test_dp_paths_equal_single_process(world):
    _, ranks = world
    fd, batches = _dp_single()
    for name, seqs in batches.items():
        for i, (sc, pa) in enumerate(fd.decode_path_batch(seqs, bucketed=False)):
            assert np.array_equal(ranks[0][f"dp_{name}_path_scores_{i}"], sc), (name, i)
            assert np.array_equal(ranks[0][f"dp_{name}_path_{i}"], pa), (name, i)


def test_dense_and_structured_ranks_equal_local_forms(world):
    """Dense DP, TP and DP x TP (a 2 x 1 grid on 2 ranks, 2 x 2 on 4) and
    the structured TP over the ranks: bit-equal to the local forms and to
    the oracle."""
    from spec_viterbi_tpu_torch import viterbi_scores_oracle
    from spec_viterbi_tpu_torch.models.decoder import DeviceHMM
    from spec_viterbi_tpu_torch.parallel import (
        DATA_AXIS,
        decode_batch_dp,
        decode_batch_dp_tp,
        decode_batch_structured_tp,
        decode_tp,
        make_grid,
    )

    size, ranks = world
    hmm, _ = workers.dp_model()
    dev = DeviceHMM.from_hmm(hmm, device="cpu")
    seqs = workers.sequences(hmm.emit_num, workers.DP_LENGTHS, seed=7)
    want = np.stack([viterbi_scores_oracle(hmm, s) for s in seqs])
    local = {
        "dense_dp": decode_batch_dp(dev, seqs, make_group("cpu", size, axis=DATA_AXIS)),
        "dense_tp": [decode_tp(dev, s, make_group("cpu", size)) for s in seqs],
        "dense_dp_tp": decode_batch_dp_tp(dev, seqs, make_grid("cpu", *workers.grid_shape(size))),
        "structured_tp": decode_batch_structured_tp(hmm, seqs, make_group("cpu", size)),
    }
    for key, got in local.items():
        assert np.array_equal(ranks[0][key], np.stack(got)), key
        assert np.array_equal(ranks[0][key], want), key


def test_time_parallel_ranks_equal_local_group(world):
    """The dense SP over the ranks (one time block a rank, the blocks
    all-gathered): bit-equal to a local time group of as many shards, and
    within ±1.0 of the oracle."""
    from spec_viterbi_tpu_torch import almost_equal_vec, viterbi_scores_oracle
    from spec_viterbi_tpu_torch.parallel import TIME_AXIS, decode_time_parallel

    size, ranks = world
    hmm, _ = workers.dp_model()
    seqs = workers.sequences(hmm.emit_num, workers.DP_LENGTHS, seed=7)
    local = np.stack([decode_time_parallel(hmm, s, make_group("cpu", size, axis=TIME_AXIS)) for s in seqs])
    assert np.array_equal(ranks[0]["sp"], local)
    for got, s in zip(ranks[0]["sp"], seqs):
        assert almost_equal_vec(got, viterbi_scores_oracle(hmm, s)), len(s)


def test_dense_tp_ranks_hold_only_their_state_block(world):
    """A rank of the dense TP (and of DP x TP's state axis) holds its
    [Nb, Np] block of each operator, Nb of pi and [E, Nb] emissions, and
    no more storage than that: Nb x Np, not Np x Np."""
    size, ranks = world
    hmm, _ = workers.dp_model()
    n = pad_to_lane(hmm.states_num)
    for name, shards in (("tp", size), ("dp_tp", workers.grid_shape(size)[1])):
        nb = n // shards
        want = np.array([[nb, n], [n, nb], [nb, 0], [hmm.emit_num, nb]])
        for r, got in enumerate(ranks):
            assert np.array_equal(got[f"{name}_block_shapes"], want), (name, r)
            assert np.array_equal(got[f"{name}_block_bytes"], 4 * want[:, 0] * np.maximum(want[:, 1], 1)), (name, r)


def test_stream_dp_ranks_equal_local_group_and_single_device(world):
    """StreamDP over the ranks: scores, path scores and ragged paths equal
    the local group's and the single-device stream's."""
    from spec_viterbi_tpu_torch.parallel import DATA_AXIS, StreamDP

    size, ranks = world
    fd, _ = _dp_single()
    block, lens = workers.stream_block(fd.emit_num)
    local = workers.run_stream(StreamDP(fd, make_group("cpu", size, axis=DATA_AXIS)), block, lens)
    single = workers.run_stream(_SingleStream(fd), block, lens)
    for key, got, one in zip(("stream_scores", "stream_path_scores", "stream_paths"), local, single):
        assert np.array_equal(ranks[0][key], got), key
        assert np.array_equal(got, one), key


class _SingleStream:
    """The single-device stream of ``fd`` under StreamDP's method names."""

    def __init__(self, fd):
        self.begin, self.feed, self.scores = fd.stream_begin, fd.stream_feed, fd.stream_scores
        self.begin_path, self.feed_path = fd.stream_begin_path, fd.stream_feed_path
        self.path_finalize = fd.stream_path_finalize


def test_single_process_without_a_world(monkeypatch):
    """No coordinator: nothing is initialized, one process, and a
    distributed group cannot be made."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    info = process_info()
    assert (info["process_id"], info["process_count"]) == (0, 1)
    assert info["global_devices"] == info["local_devices"] >= 1
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_group("cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        init_distributed("localhost:1", num_processes=2)


@pytest.mark.parametrize("shards", [2, 4])
def test_dp_local_group_matches_single_process_and_jax_dp(shards):
    """DP over a local group of data shards (every shard's lanes on one
    device): bit-equal to the single-process decode, and to the JAX
    package's fused DP on its virtual CPU mesh (interpret mode) within
    almost_equal_vec for scores, equal for paths."""
    from test_torch_host import ref_from_port

    from spec_viterbi_tpu.hmm import almost_equal_vec
    from spec_viterbi_tpu.ops.fused_pallas import FusedStructuredDecoder as RefFused
    from spec_viterbi_tpu.ops.structured import StructuredOperator as RefOperator
    from spec_viterbi_tpu.parallel import decode_batch_dp_fused as ref_dp
    from spec_viterbi_tpu.parallel import decode_path_batch_dp_fused as ref_dp_paths
    from spec_viterbi_tpu.parallel import make_mesh

    from spec_viterbi_tpu_torch.parallel import (
        DATA_AXIS,
        decode_batch_dp_fused,
        decode_path_batch_dp_fused,
    )

    fd, batches = _dp_single()
    hmm = ref_from_port(workers.dp_model()[0])
    ref_sop = RefOperator.from_hmm(hmm)
    ref = RefFused(ref_sop, hmm.emission_matrix(pad_to=ref_sop.n),
                   hmm.start_vector(pad_to=ref_sop.n), interpret=True)
    mesh = make_mesh(data=shards)
    group = make_group("cpu", shards, axis=DATA_AXIS)
    for name, seqs in batches.items():
        got = decode_batch_dp_fused(fd, seqs, group)
        for g, w, r in zip(got, fd.decode_batch(seqs, bucketed=False), ref_dp(ref, seqs, mesh)):
            assert np.array_equal(g, w), name
            assert almost_equal_vec(g, np.asarray(r)), name
        got = decode_path_batch_dp_fused(fd, seqs[:4], group)
        for (sc, pa), (wsc, wpa), (rsc, rpa) in zip(
            got, fd.decode_path_batch(seqs[:4], bucketed=False), ref_dp_paths(ref, seqs[:4], mesh)
        ):
            assert np.array_equal(sc, wsc) and np.array_equal(pa, wpa), name
            assert almost_equal_vec(sc, np.asarray(rsc)) and np.array_equal(pa, np.asarray(rpa)), name
