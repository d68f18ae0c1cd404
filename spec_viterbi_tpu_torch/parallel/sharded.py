"""Data-parallel (DP) fused decode over a ``data`` shard group.

The port of the fused DP entry points of
``spec_viterbi_tpu/parallel/sharded.py`` (``decode_batch_dp_fused``,
``decode_path_batch_dp_fused``). The lanes are split evenly over the
group's shards; each shard runs the fused decoder's kernels on its lanes
with no collective until the end, and an all-gather hands every process
the full result, as the JAX package's ``fetch_global`` does.
"""

from __future__ import annotations

import numpy as np

from spec_viterbi_tpu_torch.parallel.mesh import DATA_AXIS


def _lane_split(seqs: list[np.ndarray], group) -> tuple[list[list[np.ndarray]], int]:
    """The lanes of each shard this process holds, and the batch's max
    length. The batch is padded with copies of its first sequence to a
    multiple of the group size (a copy keeps a uniform batch uniform), so
    every shard's result has one shape for the all-gather."""
    if group.axis != DATA_AXIS:
        raise ValueError(f"DP shards the {DATA_AXIS!r} axis, not {group.axis!r}")
    per = -(-len(seqs) // group.size)
    padded = list(seqs) + [seqs[0]] * (per * group.size - len(seqs))
    return [padded[s * per : (s + 1) * per] for s in group.shards()], max(len(s) for s in seqs)


def decode_batch_dp_fused(fd, seqs: list[np.ndarray], group) -> list[np.ndarray]:
    """Fused-kernel batched decode sharded over ``data``; score vectors.

    ``fd`` is a :class:`~spec_viterbi_tpu_torch.ops.fused.FusedStructuredDecoder`
    on this process's device. A uniform-length batch runs unmasked, which
    takes the FS kernel for its class (``fd._fs_ok``), anything else the
    masked kernel; no bucketing."""
    if not seqs:
        return []
    uniform = len({len(s) for s in seqs}) == 1 and len(seqs[0]) >= 2
    lanes, t_max = _lane_split(seqs, group)
    parts = []
    for part in lanes:
        seqs_t, lengths, _ = fd.prepare(part, t_pad=t_max)
        parts.append(fd._scores_core(seqs_t, lengths, masked=not uniform).T)
    v = group.all_gather(parts)[: len(seqs), : fd.states_num].cpu().numpy()
    return [v[i] for i in range(len(seqs))]


def decode_path_batch_dp_fused(
    fd, seqs: list[np.ndarray], group
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Fused-kernel batched path decode sharded over ``data``: [(scores,
    exact path)] per sequence with the oracle's tie rule, through the
    masked path kernel and the backtrace kernel on each shard."""
    if not seqs:
        return []
    lanes, t_max = _lane_split(seqs, group)
    scores, paths = [], []
    for part in lanes:
        seqs_t, lengths, _ = fd.prepare(part, t_pad=t_max)
        sc, p = fd._path_core(seqs_t, lengths, masked=True)
        scores.append(sc.T)
        paths.append(p.T)
    scores = group.all_gather(scores)[: len(seqs), : fd.states_num].cpu().numpy()
    paths = group.all_gather(paths).cpu().numpy()
    return [(scores[i], paths[i, : len(s)].astype(np.int32)) for i, s in enumerate(seqs)]
