"""State-sharded (TP) decode of a structured operator with halo exchange,
and its data-parallel (DP) form.

The port of ``spec_viterbi_tpu/parallel/structured_tp.py``. The JAX package
computes these steps in XLA with no Pallas kernel; here they are plain
PyTorch on the group's device, as ``structured_mv_batch`` is. A state
shard owns ``block = n / K`` rows of the carry, kept in a window of
``h_lo + block + h_hi`` rows whose halo rows hold its neighbours' edge
rows. A step:

- **diagonal** offset ``d`` reads the window ``d`` rows up (``d > 0``) or
  down; the halo rows come from
  :meth:`~spec_viterbi_tpu_torch.parallel.mesh.DistributedGroup.exchange_halo`,
  whose ``+inf`` past the outer edges is the JAX package's ``valid`` mask;
- **scalar rows**, one ``[R + C + Z, B]`` tensor reduced by one
  ``min_reduce_`` a step: the dense rows' sources ``v[s]`` (the owner
  contributes, the others ``+inf``), the dense columns' partial minima,
  and the residual entries' sources. One reduce takes the place of the
  JAX package's ``R + C + Z`` ``pmin``s; a min is exact, so it is
  bit-equal;
- then the dense rows' candidates, the dense columns and residual entries
  on their owner rows, the emission add and the length mask.

In the local form (every shard in one process) the windows are views of
one global carry padded with ``+inf`` rows, so the halos are the
neighbours' rows already and the K blocks are computed at once; the
scalar rows reduce over the K shards in place of the collective.

Restriction (checked): every diagonal offset is smaller than the block,
so a halo only touches adjacent shards.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM, validate_obs_seq
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator, structured_scores_batch
from spec_viterbi_tpu_torch.parallel.mesh import DATA_AXIS, STATE_AXIS
from spec_viterbi_tpu_torch.utils.batching import pad_batch

INF = float("inf")


def structured_tp_supported(sop: StructuredOperator, shards: int) -> bool:
    if sop.n % shards != 0:
        return False
    block = sop.n // shards
    # d == 0 (self-loop diagonal) needs no halo at all — always supported
    return all(abs(d) < block for d in sop.diag_offsets)


def _want_axis(group, axis: str) -> None:
    if group.axis != axis:
        raise ValueError(f"this decode shards the {axis!r} axis, not {group.axis!r}")


def make_structured_tp_decode(sop: StructuredOperator, group):
    """A batched decoder sharded over ``state``,
    ``fn(dv, rv, cv, resv, em_t, pi, seqs_t, lengths) → [B, Np]`` on every
    process: ``dv`` [D, Np], ``rv`` [R, Np], ``cv`` [C, Np] (the operator's
    value rows), ``resv`` [1, Z], ``em_t`` [Np, E], ``pi`` [Np], ``seqs_t``
    [T, B] int, ``lengths`` [B] int, the whole model on the group's device
    (a rank reads its block)."""
    _want_axis(group, STATE_AXIS)
    shards = group.size
    if not structured_tp_supported(sop, shards):
        raise ValueError("structured TP needs |diag offset| < block size")
    block = sop.n // shards
    h_lo = max([d for d in sop.diag_offsets if d > 0], default=0)
    h_hi = max([-d for d in sop.diag_offsets if d < 0], default=0)
    win = h_lo + block + h_hi
    owned = list(group.shards())
    pos = {s: i for i, s in enumerate(owned)}  # shard → its place in this process
    n_rows, n_cols, n_res = len(sop.row_idx), len(sop.col_idx), sop.residual_nnz
    slots = n_rows + n_cols + n_res
    # the scalar rows a step reads from the carry: (slot, place, local row)
    # of each dense row's and residual entry's source this process owns
    sources = zip([*range(n_rows), *range(n_rows + n_cols, slots)], [*sop.row_idx, *sop.res_src.tolist()])
    gather = [(q, pos[s // block], s % block) for q, s in sources if s // block in pos]
    # (place, local row, slot) of each dense column and residual target it owns
    targets = zip(range(n_rows, slots), [*sop.col_idx, *sop.res_dst.tolist()])
    scatter = [(pos[c // block], c % block, q) for q, c in targets if c // block in pos]

    def tp_decode(dv, rv, cv, resv, em_t, pi, seqs_t, lengths) -> torch.Tensor:
        dev = pi.device
        k, lanes, steps = len(owned), seqs_t.shape[1], seqs_t.shape[0]

        def idx(x):
            return torch.as_tensor(x, dtype=torch.long, device=dev)

        rows = idx(owned)[:, None] * block + torch.arange(block, device=dev)[None]  # [K, block]
        dv_b, rv_b = dv[:, rows, None], rv[:, rows, None]  # [*, K, block, 1]
        cv_b = cv[:, rows, None]
        em_b = em_t[rows.reshape(-1)]  # [K·block, E]
        obs = seqs_t.long()
        keep = torch.arange(steps, device=dev)[:, None] < lengths.to(dev)[None, :]  # [T, B]
        g_src = idx([h_lo + p * block + l for _, p, l in gather])  # carry rows of the sources
        g_dst = idx([q * k + p for q, p, _ in gather])  # their places in the [slots, K] rows
        s_dst = idx([p * block + l for p, l, _ in scatter])[:, None].expand(-1, lanes)
        s_src = idx([q - n_rows for _, _, q in scatter])
        res_add = resv.reshape(-1)[:n_res, None]
        # a ping-pong pair of padded carries: +inf rows past the outer
        # edges; a rank's halo rows are refreshed before each step
        bufs = [torch.full((h_lo + k * block + h_hi, lanes), INF, device=dev) for _ in range(2)]
        inner = slice(h_lo, h_lo + k * block)
        bufs[0][inner] = em_b.index_select(1, obs[0]) + pi[rows].reshape(-1, 1)
        # the scalar rows of every shard this process holds, [slots, K, B];
        # a row a shard does not own stays +inf
        sc = torch.full((slots, k, lanes), INF, device=dev)
        for t in range(1, steps):
            cur, nxt = bufs[(t - 1) % 2], bufs[t % 2]
            if not group.is_local:
                group.exchange_halo(cur, h_lo, block, h_hi)
            w = cur.as_strided((k, win, lanes), (block * lanes, lanes, 1))
            u = None
            for q, d in enumerate(sop.diag_offsets):
                cand = dv_b[q] + w[:, h_lo - d : h_lo - d + block]
                u = cand if u is None else torch.minimum(u, cand, out=u)
            if u is None:
                u = torch.full((k, block, lanes), INF, device=dev)
            sc.view(-1, lanes).index_copy_(0, g_dst, cur.index_select(0, g_src))
            if n_cols:  # the dense columns' partial minima over this process's blocks
                torch.amin(cv_b + w[None, :, h_lo : h_lo + block], dim=2, out=sc[n_rows : n_rows + n_cols])
            red = group.min_reduce_(sc.amin(dim=1))  # [slots, B]: one reduce over the shards
            for q in range(n_rows):
                torch.minimum(u, rv_b[q] + red[q], out=u)
            if scatter:  # dense columns and residual entries on their owner rows
                cand = red[n_rows:] if not n_res else torch.cat(
                    [red[n_rows : n_rows + n_cols], res_add + red[n_rows + n_cols :]])
                u.view(-1, lanes).scatter_reduce_(0, s_dst, cand.index_select(0, s_src), reduce="amin")
            v_new = em_b.index_select(1, obs[t]).add_(u.view(-1, lanes))
            torch.where(keep[t], v_new, cur[inner], out=nxt[inner])
        out = bufs[(steps - 1) % 2][inner].view(k, block, lanes)
        return group.all_gather(list(out)).T

    return tp_decode


def make_structured_dp_decode(sop: StructuredOperator, group):
    """A batched structured decoder sharded over ``data``,
    ``fn(em_t, pi, seqs_t, lengths) → [B, Np]`` on every process: each
    shard runs the plain structured step (``structured_mv_batch``) on its
    lanes, with no collective until the scores are gathered."""
    _want_axis(group, DATA_AXIS)
    arrs = sop.to(group.device)

    def dp_decode(em_t, pi, seqs_t, lengths) -> torch.Tensor:
        if seqs_t.shape[1] % group.size:
            raise ValueError(f"{seqs_t.shape[1]} lanes do not split over {group.size} shards")
        per = seqs_t.shape[1] // group.size
        parts = []
        for s in group.shards():
            obs = seqs_t[:, s * per : (s + 1) * per]
            v0 = em_t[:, obs[0].long()] + pi[:, None]
            parts.append(structured_scores_batch(
                sop, arrs, em_t, v0, obs[1:], lengths[s * per : (s + 1) * per]).T)
        return group.all_gather(parts)

    return dp_decode


def _staged(hmm: HMM, seqs: list[np.ndarray], multiple: int, device):
    """(operator, em_t, pi, seqs_t, lengths) on ``device``, the batch padded
    as the JAX package pads it (``min_t=2``)."""
    sop = StructuredOperator.from_hmm(hmm)
    seqs = [validate_obs_seq(s, hmm.emit_num) for s in seqs]
    batch, lengths = pad_batch(seqs, multiple, min_t=2)
    n = sop.n
    return (
        sop,
        torch.as_tensor(np.ascontiguousarray(hmm.emission_matrix(pad_to=n).T), device=device),
        torch.as_tensor(hmm.start_vector(pad_to=n), device=device),
        torch.as_tensor(batch.T.copy(), device=device),
        torch.as_tensor(lengths, device=device),
    )


def decode_batch_structured_dp(hmm: HMM, seqs: list[np.ndarray], group) -> list[np.ndarray]:
    """Data-parallel batched structured decode over ``data``; the batch is
    padded to a multiple of (shards × 8) lanes."""
    if not seqs:
        return []
    sop, em_t, pi, seqs_t, lengths = _staged(hmm, seqs, group.size * 8, group.device)
    v = make_structured_dp_decode(sop, group)(em_t, pi, seqs_t, lengths)
    v = v[: len(seqs), : hmm.states_num].cpu().numpy()
    return [v[i] for i in range(len(seqs))]


def decode_batch_structured_tp(hmm: HMM, seqs: list[np.ndarray], group) -> list[np.ndarray]:
    """Batched decode with the structured operator sharded over ``state``;
    the batch is padded to a multiple of 8 lanes."""
    if not seqs:
        return []
    sop, em_t, pi, seqs_t, lengths = _staged(hmm, seqs, 8, group.device)
    n, dev = sop.n, group.device

    def rows(a):
        return torch.as_tensor(a if a.shape[0] else np.zeros((0, n), np.float32), device=dev)

    resv = sop.res_vals.reshape(1, -1) if sop.residual_nnz else np.zeros((1, 1), np.float32)
    fn = make_structured_tp_decode(sop, group)
    v = fn(rows(sop.diag_vals), rows(sop.row_vals), rows(sop.col_vals),
           torch.as_tensor(resv, device=dev), em_t, pi, seqs_t, lengths)
    v = v[: len(seqs), : hmm.states_num].cpu().numpy()
    return [v[i] for i in range(len(seqs))]
