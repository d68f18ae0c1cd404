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
from spec_viterbi_tpu_torch.ops.fused import FusedStructuredDecoder
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.parallel import (
    DATA_AXIS,
    FusedTPDecoder,
    decode_batch_dp_fused,
    decode_path_batch_dp_fused,
    init_distributed,
    make_group,
    process_info,
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
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()
