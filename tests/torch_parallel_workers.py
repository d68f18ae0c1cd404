"""Rank workers of ``tests/test_torch_parallel.py``.

Each worker is one rank of a gloo world on the CPU, spawned by the test.
This module imports neither jax nor the JAX package, so a spawned rank
starts with the port alone. A rank writes what it decoded to
``out_dir/rank{r}.npz``; the test compares the files with what one
process computes.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.io.generators import generate_banded_hmm, generate_profile_hmm
from spec_viterbi_tpu_torch.models.decoder import DeviceHMM
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.parallel import (
    DATA_AXIS,
    TIME_AXIS,
    FusedTPDecoder,
    StreamDP,
    decode_batch_dp,
    decode_batch_dp_fused,
    decode_batch_dp_tp,
    decode_batch_structured_tp,
    decode_path_batch_dp_fused,
    decode_time_parallel,
    decode_tp,
    init_distributed,
    make_grid,
    make_group,
    process_info,
    state_block,
)

# (offsets, chunk) of the banded model the TP ranks decode, by world size
TP_CASES = {2: ((1,), 8), 4: ((-1, 1), 4)}


def tp_model(world: int):
    offsets, chunk = TP_CASES[world]
    hmm = generate_banded_hmm(256, offsets, 4, seed=21 + world)
    sop = StructuredOperator.from_hmm(hmm)
    return hmm, sop, chunk


def dp_model():
    hmm = generate_profile_hmm(60, emit_num=6, seed=4)
    return hmm, StructuredOperator.from_hmm(hmm)


def sequences(emit: int, lengths, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, emit, size=int(t)).astype(np.int32) for t in lengths]


def tp_lengths(chunk: int) -> list[int]:
    """Ragged lengths: a length-1 lane, tails of 1 and c - 1 steps."""
    return [1, 2, chunk, chunk + 1, 3 * chunk - 1, 3 * chunk + 1, 40]


DP_LENGTHS = [3, 17, 40, 2, 9, 1, 33]  # 7 lanes: not a multiple of 2 or 4
STREAM_SPLITS = (12, 0, 20)  # chunks after the first symbol: 33 symbols a lane


def grid_shape(world: int) -> tuple[int, int]:
    """(data, state) of the DP x TP grid a world of ranks forms."""
    return 2, world // 2


def stream_block(emit: int) -> tuple[np.ndarray, np.ndarray]:
    """The streamed lanes [T, B] and their ragged lengths."""
    rng = np.random.default_rng(6)
    return rng.integers(0, emit, size=(33, 7)).astype(np.int32), np.array([33, 5, 1, 20, 33, 13, 30])


def run_stream(sdp, block, lens=None):
    """(scores, path scores, paths) of ``sdp`` (a ``StreamDP``) over
    ``block`` in ``STREAM_SPLITS``; the path stream with per-lane valid
    counts where ``lens`` is given."""
    st = sdp.begin(block[0])
    pst = sdp.begin_path(block[0])
    pos = 1
    for w in STREAM_SPLITS:
        st = sdp.feed(st, block[pos : pos + w])
        valid = None if lens is None else np.clip(lens - pos, 0, w)
        pst = sdp.feed_path(pst, block[pos : pos + w], valid=valid)
        pos += w
    return (sdp.scores(st), *sdp.path_finalize(pst))


def run_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    init_distributed(f"file://{init_file}", world, rank, device="cpu")
    info = process_info()
    out = {"process": np.array([info["process_id"], info["process_count"]])}

    hmm, sop, chunk = tp_model(world)
    tp = FusedTPDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n),
        make_group("cpu"), chunk=chunk,
    )
    seqs = sequences(hmm.emit_num, tp_lengths(chunk), seed=world)
    for i, v in enumerate(tp.decode_batch(seqs)):
        out[f"tp_scores_{i}"] = v
    for i, (v, p) in enumerate(tp.decode_path_batch(seqs)):
        out[f"tp_path_scores_{i}"] = v
        out[f"tp_path_{i}"] = p

    hmm, sop = dp_model()
    fd = FusedStructuredDecoder(
        sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n), device="cpu"
    )
    group = make_group("cpu", axis=DATA_AXIS)
    for name, lengths in (("ragged", DP_LENGTHS), ("uniform", [24] * len(DP_LENGTHS))):
        seqs = sequences(hmm.emit_num, lengths, seed=5)
        for i, v in enumerate(decode_batch_dp_fused(fd, seqs, group)):
            out[f"dp_{name}_scores_{i}"] = v
        for i, (v, p) in enumerate(decode_path_batch_dp_fused(fd, seqs, group)):
            out[f"dp_{name}_path_scores_{i}"] = v
            out[f"dp_{name}_path_{i}"] = p

    # the dense, structured and streaming entry points on the same model
    dev = DeviceHMM.from_hmm(hmm, device="cpu")
    seqs = sequences(hmm.emit_num, DP_LENGTHS, seed=7)
    state = make_group("cpu")
    grid = make_grid("cpu", *grid_shape(world), distributed=True)
    tp_block = state_block(hmm, state, device="cpu")
    grid_block = state_block(hmm, grid.state, device="cpu")
    out["dense_dp"] = np.stack(decode_batch_dp(dev, seqs, group))
    out["dense_tp"] = np.stack([decode_tp(tp_block, s, state) for s in seqs])
    out["dense_dp_tp"] = np.stack(decode_batch_dp_tp(grid_block, seqs, grid))
    for name, blk in (("tp", tp_block), ("dp_tp", grid_block)):
        # what the rank holds of the model: shapes and bytes of a_t, a, pi, emissions
        parts = (blk.a_t, blk.a, blk.pi, blk.emissions)
        out[f"{name}_block_shapes"] = np.array([list(p.shape) + [0] * (2 - p.dim()) for p in parts])
        out[f"{name}_block_bytes"] = np.array([p.untyped_storage().nbytes() for p in parts])
    out["structured_tp"] = np.stack(decode_batch_structured_tp(hmm, seqs, state))
    out["sp"] = np.stack([decode_time_parallel(hmm, s, make_group("cpu", axis=TIME_AXIS)) for s in seqs])
    block, lens = stream_block(hmm.emit_num)
    out["stream_scores"], out["stream_path_scores"], out["stream_paths"] = run_stream(
        StreamDP(fd, group), block, lens)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()
