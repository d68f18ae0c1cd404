"""Operators whose blocks are partly all +inf, for the tests of the block
list that ``svt_minplus`` walks (``tropical.block_list``). Each is the
dense decoder's untransposed matrix ``a`` ([n, n] f32), whose transposed
view ``A = a.T`` the batched step multiplies by; numpy only."""

import numpy as np

from spec_viterbi_tpu_torch.hmm import pad_to_lane
from spec_viterbi_tpu_torch.io.generators import generate_plan7_hmm

NAMES = ("plan7_40", "plan7_500", "blocky_300", "blocky_ties_512", "all_inf", "dense")


def plan7(leng: int) -> np.ndarray:
    """A Plan7 profile's folded operator (``generate_plan7_hmm``) at its
    lane-padded width, as ``DeviceHMM.from_hmm`` builds it."""
    hmm = generate_plan7_hmm(leng, seed=leng)
    return hmm.transition_matrix(pad_to=pad_to_lane(hmm.states_num))


def blocky(n: int, seed: int, ties: bool = False) -> np.ndarray:
    """Seeded values (normal, or integers in [0, 3] that tie everywhere),
    +inf in ~30% of the entries, in ~40% of A's (64-row, 16-k) blocks and
    in every block of the middle 64-row tile."""
    rng = np.random.default_rng(seed)
    if ties:
        a_op = rng.integers(0, 4, size=(n, n)).astype(np.float32)
    else:
        a_op = rng.normal(4.0, 2.0, size=(n, n)).astype(np.float32)
    a_op[rng.uniform(size=(n, n)) < 0.3] = np.inf
    tiles, stages = -(-n // 64), -(-n // 16)
    empty = rng.uniform(size=(tiles, stages)) < 0.4
    empty[tiles // 2] = True
    a_op[np.repeat(np.repeat(empty, 64, axis=0), 16, axis=1)[:n, :n]] = np.inf
    return np.ascontiguousarray(a_op.T)


def operator(name: str) -> np.ndarray:
    if name.startswith("plan7_"):
        return plan7(int(name.split("_")[1]))
    if name == "blocky_300":
        return blocky(300, 1)
    if name == "blocky_ties_512":
        return blocky(512, 2, ties=True)
    if name == "all_inf":
        return np.full((256, 256), np.inf, np.float32)
    if name == "dense":
        return np.random.default_rng(3).normal(4.0, 2.0, size=(256, 256)).astype(np.float32)
    raise ValueError(name)


def brute_blocks(a: np.ndarray, rows: int, stage_k: int) -> np.ndarray:
    """[tiles, stages] bool: whether block (t, s) of ``A = a.T`` holds a
    finite entry, one block at a time."""
    op = a.T
    tiles, stages = -(-op.shape[0] // rows), -(-op.shape[1] // stage_k)
    held = np.zeros((tiles, stages), dtype=bool)
    for t in range(tiles):
        for s in range(stages):
            held[t, s] = np.isfinite(op[t * rows:(t + 1) * rows, s * stage_k:(s + 1) * stage_k]).any()
    return held
