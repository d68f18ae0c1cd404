"""Structure-aware (min,+) operators: diagonals + dense rows/cols + residual.

The port of ``spec_viterbi_tpu/ops/structured.py``. The decomposition
(:meth:`StructuredOperator.from_hmm`) is numpy and builds the JAX
package's operator field for field (the tests hold the two equal), in
passes over the transitions rather than one a component; the matvec is
plain PyTorch. Every corpus model decomposes into one dense
source row, two dense destination columns and the +1 diagonal; whatever
an arbitrary HMM leaves over goes to a COO residual applied by
scatter-min.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM, MOD_PROB_DTYPE, ZERO_PROB, pad_to_lane


class OperatorTensors(NamedTuple):
    """The value arrays of a :class:`StructuredOperator` on one device."""

    diag_vals: torch.Tensor  # [D, n] f32
    row_vals: torch.Tensor  # [R, n] f32
    col_vals: torch.Tensor  # [C, n] f32
    res_src: torch.Tensor  # [Z] int64
    res_dst: torch.Tensor  # [Z] int64
    res_vals: torch.Tensor  # [Z] f32


@dataclasses.dataclass(frozen=True)
class StructuredOperator:
    """A −log2-space transition operator in structured form.

    Semantics (state-major, ``v`` is the incoming score carry)::

        u[i] = min(
            min_k  diag_vals[k, i] + v[i - diag_offsets[k]],
            min_k  row_vals[k, i]  + v[row_idx[k]],
            (for i = col_idx[k])  min_j col_vals[k, j] + v[j],
            (residual)            min over entries (s→i): res_vals + v[s],
        )

    All value arrays are +inf-padded; a diagonal's out-of-range rows hold
    +inf, so a cyclic shift of ``v`` needs no mask.
    """

    n: int  # padded state count
    states_num: int
    diag_offsets: tuple[int, ...]
    diag_vals: np.ndarray  # [D, n]
    row_idx: tuple[int, ...]
    row_vals: np.ndarray  # [R, n]
    col_idx: tuple[int, ...]
    col_vals: np.ndarray  # [C, n]
    res_src: np.ndarray  # [Z] int32
    res_dst: np.ndarray  # [Z] int32
    res_vals: np.ndarray  # [Z] f32
    nnz: int

    @property
    def num_components(self) -> int:
        return len(self.diag_offsets) + len(self.row_idx) + len(self.col_idx)

    @property
    def residual_nnz(self) -> int:
        return int(self.res_vals.shape[0])

    def cost_ratio(self) -> float:
        """Structured work / dense work per matvec (lower is better)."""
        comp = self.num_components * self.n + self.residual_nnz
        return comp / float(self.n * self.n)

    @classmethod
    def from_hmm(
        cls,
        hmm: HMM,
        pad_to: int | None = None,
        dense_threshold: int | None = None,
        max_diags: int = 8,
    ) -> "StructuredOperator":
        """Decompose the transition matrix ``A[src, dst]``.

        A source/destination is "dense" when its degree reaches
        ``dense_threshold`` (default ``max(16, N/16)``); among the
        remaining entries, offsets covering ≥ the threshold become
        diagonals (up to ``max_diags``); everything else is residual COO.
        The JAX package's decomposition, field for field, in passes over
        the transitions whose number does not grow with the components'.
        """
        n_real = hmm.states_num
        n = pad_to if pad_to is not None else pad_to_lane(n_real)
        thresh = dense_threshold if dense_threshold is not None else max(16, n_real // 16)

        src = np.asarray(hmm.trans_rows, dtype=np.int64)
        dst = np.asarray(hmm.trans_cols, dtype=np.int64)
        val = np.asarray(hmm.trans_probs, dtype=MOD_PROB_DTYPE)
        nnz = val.shape[0]

        # 1. dense source rows
        row_idx = [int(s) for s in np.nonzero(np.bincount(src, minlength=n_real) >= thresh)[0]]
        alive = np.ones(nnz, dtype=bool)
        row_vals, taken = _class_values(row_idx, src, alive, dst, val, n, 0, n_real)
        alive &= ~taken

        # 2. dense destination columns (among remaining entries)
        col_idx: list[int] = []
        if alive.any():
            deg = np.bincount(dst[alive], minlength=n_real)
            col_idx = [int(c) for c in np.nonzero(deg >= thresh)[0]]
        col_vals, taken = _class_values(col_idx, dst, alive, src, val, n, 0, n_real)
        alive &= ~taken

        # 3. diagonals (among remaining entries)
        diag_offsets: list[int] = []
        offs = dst - src
        if alive.any():
            uniq, counts = np.unique(offs[alive], return_counts=True)
            order = np.argsort(-counts)
            for j in order[:max_diags]:
                if counts[j] >= thresh:
                    diag_offsets.append(int(uniq[j]))
        # value indexed by output (dst) state: diag_vals[k, i] = A[i-d, i]
        diag_vals, taken = _class_values(diag_offsets, offs, alive, dst, val, n,
                                         1 - n_real, 2 * n_real - 1)
        alive &= ~taken

        # 4. residual COO
        res_src = src[alive].astype(np.int32)
        res_dst = dst[alive].astype(np.int32)
        res_vals = val[alive].astype(MOD_PROB_DTYPE)

        return cls(
            n=n,
            states_num=n_real,
            diag_offsets=tuple(diag_offsets),
            diag_vals=diag_vals,
            row_idx=tuple(row_idx),
            row_vals=row_vals,
            col_idx=tuple(col_idx),
            col_vals=col_vals,
            res_src=res_src,
            res_dst=res_dst,
            res_vals=res_vals,
            nnz=nnz,
        )

    def to(self, device: torch.device | str) -> OperatorTensors:
        """Torch copies of the value arrays on ``device`` (the indices
        stay static Python)."""
        return OperatorTensors(
            torch.as_tensor(self.diag_vals, device=device),
            torch.as_tensor(self.row_vals, device=device),
            torch.as_tensor(self.col_vals, device=device),
            torch.as_tensor(self.res_src, dtype=torch.int64, device=device),
            torch.as_tensor(self.res_dst, dtype=torch.int64, device=device),
            torch.as_tensor(self.res_vals, device=device),
        )


# a class of at most this many members is taken one member at a time, a
# larger one in one pass through a lookup table: at the corpus's MSV shape
# (one row, two columns, one diagonal) the comparisons cost less than the
# table's gathers (0.29-0.35 against 0.43 ms at 2,407 states on the CPU)
FEW_MEMBERS = 4


def _class_values(members: list[int], keys: np.ndarray, alive: np.ndarray, at: np.ndarray,
                  val: np.ndarray, n: int, lo: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """One component class of the decomposition: for each member ``m``, a
    +inf-padded row of length ``n`` holding, at ``at[e]``, the least
    ``val[e]`` over the alive entries ``e`` with ``keys[e] == m`` (keys lie
    in ``[lo, lo + size)``). Returns (the rows [len(members), n], the
    entries taken). Either way a cell sees its entries' updates in COO
    order, so the rows are the same to the sign of a zero, and the time
    grows with the entries, not with members × entries, past a few."""
    rows = np.full((len(members), n), ZERO_PROB, dtype=MOD_PROB_DTYPE)
    if len(members) <= FEW_MEMBERS:
        taken = np.zeros(keys.shape, dtype=bool)
        for k, m in enumerate(members):
            hit = alive & (keys == m)
            np.minimum.at(rows[k], at[hit], val[hit])
            taken |= hit
        return rows, taken
    table = np.full(size, -1, dtype=np.int64)
    table[np.asarray(members, dtype=np.int64) - lo] = np.arange(len(members))
    slot = table[keys - lo]
    taken = alive & (slot >= 0)
    np.minimum.at(rows.reshape(-1), slot[taken] * n + at[taken], val[taken])
    return rows, taken


def structured_mv_batch(
    op: StructuredOperator, arrs: OperatorTensors, v: torch.Tensor
) -> torch.Tensor:
    """Batched structured tropical matvec. v: [n, B] state-major."""
    diag_vals, row_vals, col_vals, res_src, res_dst, res_vals = arrs
    u = torch.full_like(v, float("inf"))
    for k, d in enumerate(op.diag_offsets):
        u = torch.minimum(u, diag_vals[k][:, None] + torch.roll(v, d, dims=0))
    for k, s in enumerate(op.row_idx):
        u = torch.minimum(u, row_vals[k][:, None] + v[s][None, :])
    if op.col_idx:
        cu = (col_vals[:, :, None] + v[None, :, :]).amin(dim=1)  # [C, B]
        ci = list(op.col_idx)
        u[ci] = torch.minimum(u[ci], cu)
    if op.residual_nnz:
        cand = res_vals[:, None] + v[res_src]  # [Z, B]
        u = u.scatter_reduce(
            0, res_dst[:, None].expand_as(cand), cand, reduce="amin"
        )
    return u


# source index of a row that no finite candidate reached yet
NO_SOURCE = np.iinfo(np.int32).max


def take_pair(u, src, cand, cand_src):
    """Adopt ``(cand, cand_src)`` where it precedes ``(u, src)`` under the
    tie rule: a lower value, or an equal finite value from a lower
    source."""
    better = (cand < u) | ((cand == u) & (cand_src < src) & torch.isfinite(cand))
    return torch.where(better, cand, u), torch.where(better, cand_src, src)


def structured_mv_argmin(
    op: StructuredOperator, arrs: OperatorTensors, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched structured matvec plus the winning source state per output.

    ``v`` [n, B] state-major → ``(u [n, B] f32, src [n, B] int64)``; the
    batch dimension written out takes the place of the JAX package's
    ``vmap`` of its single-lane version. Tie rule, a lexicographic min over
    ``(value, source)`` among finite candidates: the lowest source index
    wins a tie, a tie whose value is infinite never adopts a source, and a
    row that no finite candidate reaches points to 0 (as ``argmin`` over an
    all-inf row does). It is a total order, so the order in which the
    components are taken does not matter.
    """
    diag_vals, row_vals, col_vals, res_src, res_dst, res_vals = arrs
    n, b = v.shape
    rows = torch.arange(n, device=v.device)[:, None]
    u = torch.full_like(v, float("inf"))
    src = torch.full((n, b), NO_SOURCE, dtype=torch.int64, device=v.device)
    take = take_pair
    for k, d in enumerate(op.diag_offsets):
        # wrap rows hold +inf in diag_vals, so they never adopt a source
        cand = diag_vals[k][:, None] + torch.roll(v, d, dims=0)
        u, src = take(u, src, cand, rows - d)
    for k, s in enumerate(op.row_idx):
        u, src = take(u, src, row_vals[k][:, None] + v[s][None, :], torch.full_like(src, s))
    if op.col_idx:
        # argmin over the f32-rounded sums, as the oracle forms a_t + v: the
        # lowest index among the equal minima
        s_mat = col_vals[:, :, None] + v[None, :, :]  # [C, n, B]
        cu = s_mat.amin(dim=1)  # [C, B]
        cs = torch.where(s_mat == cu[:, None, :], rows[None], n).amin(dim=1)
        ci = list(op.col_idx)
        u[ci], src[ci] = take(u[ci], src[ci], cu, cs)
    for z in range(op.residual_nnz):
        # the residual entries one at a time, under the same rule
        s_, d_ = int(op.res_src[z]), int(op.res_dst[z])
        cand = res_vals[z] + v[s_]
        u[d_], src[d_] = take(u[d_], src[d_], cand, torch.full_like(src[d_], s_))
    src = torch.where(src == NO_SOURCE, 0, src)
    return u, src


def structured_path_batch(
    op: StructuredOperator,
    arrs: OperatorTensors,
    em_t: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None,
    ptr_dtype: torch.dtype,
    base: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The masked scan over :func:`structured_mv_argmin`.

    Advances ``v0`` [n, B] through ``obs`` [T-1, B] like
    :func:`structured_scores_batch` and returns ``(carry [n, B],
    src [T-1, B, n])``: ``src[k, b, i]`` is the state at step ``k`` from
    which lane ``b`` reached state ``i`` at step ``k + 1``, plus ``base``,
    stored as ``ptr_dtype``. A row no finite candidate reaches stores 0. A
    lane past its length keeps its carry and writes identity pointers
    (``src[k, b, i] = i + base``), so a backtrace through its padding stays
    put. ``lengths=None`` runs every step. ``base`` maps the rows of a
    state window to global states (``parallel/fused_tp.py``).
    """
    n, b = v0.shape
    src_all = torch.empty((obs.shape[0], b, n), dtype=ptr_dtype, device=v0.device)
    ident = torch.arange(n, device=v0.device)[:, None] + base
    v = v0
    for k in range(obs.shape[0]):
        u, src = structured_mv_argmin(op, arrs, v)
        if base:
            src = torch.where(torch.isinf(u), 0, src + base)
        v_new = em_t[:, obs[k].long()] + u
        if lengths is not None:
            keep = ((k + 1) < lengths)[None, :]
            v_new = torch.where(keep, v_new, v)
            src = torch.where(keep, src, ident)
        src_all[k] = src.T
        v = v_new
    return v, src_all


def structured_scores_batch(
    op: StructuredOperator,
    arrs: OperatorTensors,
    em_t: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None,
) -> torch.Tensor:
    """The structured recurrence, one step per torch call sequence.

    Advances ``v0`` [n, B] through ``obs`` [T-1, B]:
    ``v ← em_t[:, o] + structured_mv_batch(v)``; lane ``b`` freezes once
    step ``k + 1`` reaches ``lengths[b]`` (no mask when ``lengths`` is
    None). ``em_t`` is the [n, E] emission table. Returns [n, B].
    """
    v = v0
    for k in range(obs.shape[0]):
        v_new = em_t[:, obs[k].long()] + structured_mv_batch(op, arrs, v)
        if lengths is not None:
            v_new = torch.where(((k + 1) < lengths)[None, :], v_new, v)
        v = v_new
    return v
