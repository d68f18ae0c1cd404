"""Fused whole-sequence structured Viterbi on the GPU: scores, exact
paths and streaming.

The port of ``spec_viterbi_tpu/ops/fused_pallas.py``. One kernel launch
runs the whole T-step recurrence of a batch, with each lane's carry held
on chip (``csrc/scores.cu``, ``csrc/path.cu``):

- :func:`scores_masked` replaces the masked Pallas kernel
  ``_make_unrolled_kernel``: each lane stopping at its own length. It
  takes ragged and bucketed batches, uniform batches outside the FS class,
  and the stream feeds. Two arms, chosen by the tables it is given:
  :class:`MaskedTables` launch the generic ``svt_scores_masked`` (any
  fused-eligible operator), :class:`FsTables` the planned
  ``svt_scores_masked_planned`` (the FS kernel with lengths), as the
  Pallas kernel takes the uniform plans when it has them.
- :func:`scores_fs` (kernel ``svt_scores_fs``) replaces the frame-shifted
  Pallas kernel ``_make_fs_kernel``: unmasked, for the single-diagonal
  operators whose dense rows and columns collapse into the uniform plans
  (``_fs_ok``), i.e. uniform-length batches of corpus-shaped models; one
  barrier a step, the emissions fetched a step ahead.
- :func:`path` replaces ``_make_path_kernel``: the masked or unmasked
  recurrence with ``(value, source)`` pairs under the oracle's tie rule,
  writing int16 backpointers ``[T-1, B, n]``. Two arms as
  :func:`scores_masked`'s: ``svt_path`` (generic) and ``svt_path_planned``,
  whose dense columns take an exact two-pass argmin (:func:`_column_source`).

:class:`FusedStructuredDecoder` picks each arm once, when it is built,
from the plans.
- :func:`backtrace` (kernel ``svt_backtrace``) replaces
  ``_backtrace_kernel``: the reverse walk from a boundary state, staged
  through shared memory ahead of the walk
  (``probes/emulation.py::backtrace_staged`` repeats its schedule).

All read the emission row ``em[o_t]`` directly and compute in exact f32
with real ``+inf``, so scores are bit-equal to the numpy oracle and paths
equal ``viterbi_path_oracle``'s. The TPU-specific parts of the JAX module
have no counterpart here: the one-hot MXU emission select and its bf16
splits, the finite ``BIG`` stand-in for +inf, rolls with inf-baked wrap
rows, the rotating frame, unroll and lane-block planning, VMEM limits,
narrow symbol uploads and lane padding.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import validate_obs_seq
from spec_viterbi_tpu_torch.ops import _build
from spec_viterbi_tpu_torch.ops.structured import (
    NO_SOURCE,
    OperatorTensors,
    StructuredOperator,
    structured_path_batch,
    structured_scores_batch,
    take_pair,
)
from spec_viterbi_tpu_torch.utils.batching import bucket_plan, quantize_t

# lane block of the bucket plans: kept at the JAX package's value so a
# ragged batch is cut into the same buckets (and runs the same kernels)
BB = 128

# Fused kernel eligibility: each residual entry costs a special-row update.
MAX_FUSED_RESIDUAL = 8

# Uniform-column decomposition cap: scalar-row corrections across all cols.
MAX_COL_EXTRAS = 8

# int16 backpointers address at most this many states
INT16_STATES = np.iinfo(np.int16).max

# Launch counts of the kernels; a wrapper adds one where it launches its
# kernel and nowhere else; the window kernels of parallel/fused_tp.py
# count here too.
launches = {
    "scores_masked": 0, "scores_masked_planned": 0, "scores_fs": 0,
    "path": 0, "path_planned": 0, "backtrace": 0,
    "scores_window": 0, "path_window": 0,
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# The share of a device's memory that one path call's backpointer tensor
# may take. The rest holds the operator tables and carries, the caller's
# other tensors (a dense level-2 stack takes 10.43 GB at 2,432 states), a
# check against the plain version (a second pointer tensor) and the
# allocator's slack. On an 80 GB card one call holds 1,152 lanes of
# 3,500 symbols at 2,432 states.
PATH_MEMORY_SHARE = 0.25
# The budget on the CPU: a constant, so that a CPU decode chunks its lanes
# the same way on every host.
CPU_PATH_BYTES = 6 << 30


def path_budget_bytes(device: torch.device | str) -> int:
    """The pointer budget of one path call on ``device``:
    ``PATH_MEMORY_SHARE`` of a CUDA device's ``total_memory``, and
    ``CPU_PATH_BYTES`` on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_PATH_BYTES
    return int(torch.cuda.get_device_properties(device).total_memory * PATH_MEMORY_SHARE)


def _plan_uniform_cols(sop: StructuredOperator):
    """Collapse near-uniform dense columns into ONE shared masked reduce.

    Copied from the JAX package. Profile-HMM columns are almost constant,
    so ``min_j(cv_k[j] + v_j)`` decomposes as
    ``min(c_k + R, scalar corrections)`` with ``R = min_{j∈shared} v_j``
    computed ONCE for all columns. This is BIT-exact for the score
    values: f32 rounding is monotone, so ``round(c + min_j v_j) ==
    min_j round(c + v_j)``, and every row outside the shared support
    contributes through an explicit scalar candidate with its true value —
    the same multiset of candidates as the generic reduce.

    Returns ``(mask [n, 1] f32, [(target_row, base, [(j, val), …]), …])``
    or None (no cols / too many corrections → keep the generic reduces).
    """
    if not sop.col_idx:
        return None
    cols = []
    for k in range(len(sop.col_idx)):
        col = sop.col_vals[k]
        fin = np.nonzero(np.isfinite(col))[0]
        if fin.size == 0:
            return None
        vals, counts = np.unique(col[fin], return_counts=True)
        base = float(vals[np.argmax(counts)])
        dev = {int(j): float(col[j]) for j in fin if col[j] != base}
        cols.append((set(fin.tolist()), base, dev, int(sop.col_idx[k])))
    all_dev: set[int] = set()
    for _, _, dev, _ in cols:
        all_dev |= set(dev)
    shared = set.intersection(*(s for s, *_ in cols)) - all_dev
    entries = []
    extras_total = 0
    for support, base, dev, target in cols:
        extras = sorted(dev.items())
        extras += [(j, base) for j in sorted(support - shared - set(dev))]
        extras_total += len(extras)
        entries.append((target, base, extras))
    if extras_total > MAX_COL_EXTRAS:
        return None
    mask = np.full((sop.n, 1), np.inf, np.float32)
    mask[sorted(shared), 0] = 0.0
    return mask, entries


def fused_eligible(sop: StructuredOperator) -> bool:
    return (
        sop.residual_nnz <= MAX_FUSED_RESIDUAL
        and sop.num_components + sop.residual_nnz <= 24
    )


def _plan_uniform_rows(sop: StructuredOperator):
    """Collapse near-uniform dense ROWS into scalar broadcast candidates.

    Copied from the JAX package. The bulk candidate ``rv_k + v[s_k]``
    becomes ``c_k + v[s_k]``, one scalar per lane. The uniform candidate
    then reaches rows it should not, so:

    - deviation rows with ``val < c_k`` get an extra min with the true
      candidate (the bogus ``c_k + v[s]`` can never undercut it);
    - deviation rows with ``val > c_k`` and real rows OUTSIDE the support
      are fully recomputed from scalar candidates — the same multiset the
      generic bulk would produce at that row;
    - padding rows (≥ states_num) get a finite bogus candidate, but their
      emission is +inf, so they stay +inf.

    Returns ``(uni, fixes, recompute)`` or None:
      uni       = ((s_k, c_k), …) per row component
      fixes     = ((row, val, s_k), …) extra specials mins
      recompute = ((row, ((dv_val, src), …), ((rv_val, s_m), …)), …)
    """
    if not sop.row_idx or not sop.diag_offsets:
        return None
    uni, fixes = [], []
    recompute_rows: set[int] = set()
    for k, s in enumerate(sop.row_idx):
        row = sop.row_vals[k]
        fin = np.nonzero(np.isfinite(row))[0]
        if fin.size == 0:
            return None
        vals, counts = np.unique(row[fin], return_counts=True)
        base = float(vals[np.argmax(counts)])
        uni.append((int(s), base))
        for j in fin:
            if row[j] != base:
                if row[j] < base:
                    fixes.append((int(j), float(row[j]), int(s)))
                else:
                    recompute_rows.add(int(j))
        recompute_rows |= set(range(sop.states_num)) - set(fin.tolist())
    if len(fixes) + len(recompute_rows) > MAX_COL_EXTRAS:
        return None
    recompute = []
    for r in sorted(recompute_rows):
        dc = tuple(
            (float(sop.diag_vals[k][r]), (r - d) % sop.n)
            for k, d in enumerate(sop.diag_offsets)
            if np.isfinite(sop.diag_vals[k][r])
        )
        rc = tuple(
            (float(sop.row_vals[m][r]), int(sop.row_idx[m]))
            for m in range(len(sop.row_idx))
            if np.isfinite(sop.row_vals[m][r])
        )
        recompute.append((r, dc, rc))
    return tuple(uni), tuple(fixes), tuple(recompute)


# ---- the masked kernel: svt_scores_masked ---------------------------------


@dataclasses.dataclass(frozen=True)
class MaskedTables:
    """What :func:`scores_masked` needs of one operator on one device."""

    sop: StructuredOperator
    arrs: OperatorTensors
    desc: _build.ScoresDesc

    @classmethod
    def build(cls, sop: StructuredOperator, arrs: OperatorTensors) -> "MaskedTables":
        special = sorted(set(sop.col_idx) | set(sop.res_dst.tolist()))
        caps = (
            (len(sop.diag_offsets), _build.MAX_DIAG, "diagonals"),
            (len(sop.row_idx), _build.MAX_ROW, "dense rows"),
            (len(sop.col_idx), _build.MAX_COL, "dense columns"),
            (sop.residual_nnz, _build.MAX_RES, "residual entries"),
            (len(special), _build.MAX_SPECIAL, "special rows"),
        )
        for count, cap, what in caps:
            if count > cap:
                raise ValueError(f"operator has {count} {what}; the kernel takes {cap}")
        desc = _build.ScoresDesc(
            n=sop.n,
            n_diag=len(sop.diag_offsets),
            n_row=len(sop.row_idx),
            n_col=len(sop.col_idx),
            n_res=sop.residual_nnz,
            n_special=len(special),
        )
        desc.diag_off[: len(sop.diag_offsets)] = sop.diag_offsets
        desc.row_idx[: len(sop.row_idx)] = sop.row_idx
        desc.col_idx[: len(sop.col_idx)] = sop.col_idx
        desc.res_src[: sop.residual_nnz] = sop.res_src.tolist()
        desc.res_dst[: sop.residual_nnz] = sop.res_dst.tolist()
        desc.res_val[: sop.residual_nnz] = sop.res_vals.tolist()
        desc.sp_row[: len(special)] = special
        return cls(sop, arrs, desc)


def scores_masked_plain(
    t: "MaskedTables | FsTables",
    em_t: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None,
) -> torch.Tensor:
    """Plain version of the arm of :func:`scores_masked` that ``t``
    selects: the per-step structured loop (``MaskedTables``), or the
    uniform plans' arithmetic with lengths (``FsTables``,
    :func:`scores_fs_plain`). ``em_t`` [n, E], ``v0`` [n, B], ``obs``
    [T-1, B] int32, ``lengths`` [B] int32 or None (unmasked) → [n, B]."""
    if isinstance(t, FsTables):
        return scores_fs_plain(t, em_t, v0, obs, lengths)
    return structured_scores_batch(t.sop, t.arrs, em_t, v0, obs, lengths)


def scores_masked(
    t: "MaskedTables | FsTables",
    em: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None,
) -> torch.Tensor:
    """Advance ``v0`` [n, B] through ``obs`` [T-1, B]; lane ``b`` takes
    ``lengths[b] - 1`` steps (all steps when ``lengths`` is None).
    ``em`` is the [E, n] emission table. Returns [n, B] f32.

    ``MaskedTables`` launch the generic arm (``svt_scores_masked``),
    ``FsTables`` the planned arm (``svt_scores_masked_planned``); the two
    compute the same function bit for bit."""
    if v0.device.type == "cpu":
        return scores_masked_plain(t, em.T, v0, obs, lengths)
    planned = isinstance(t, FsTables)
    _check_cuda(t.n if planned else t.sop.n, em, v0, obs, lengths)
    out = torch.empty_like(v0)
    b = v0.shape[1]
    if b == 0:
        return out
    lib = _build.library()
    lens = None if lengths is None else lengths.data_ptr()
    stream = torch.cuda.current_stream(v0.device).cuda_stream
    with torch.cuda.device(v0.device):
        if planned:
            rc = lib.svt_scores_masked_planned(
                ctypes.byref(t.desc), t.dv.data_ptr(), t.flags.data_ptr(), em.data_ptr(),
                v0.data_ptr(), obs.data_ptr(), lens, out.data_ptr(), b, obs.shape[0], stream,
            )
            _build.check(lib, rc, "svt_scores_masked_planned")
            launches["scores_masked_planned"] += 1
            return out
        diag_vals, row_vals, col_vals, *_ = t.arrs
        rc = lib.svt_scores_masked(
            ctypes.byref(t.desc),
            diag_vals.data_ptr(), row_vals.data_ptr(), col_vals.data_ptr(),
            em.data_ptr(), v0.data_ptr(), obs.data_ptr(), lens,
            out.data_ptr(), b, obs.shape[0], stream,
        )
        _build.check(lib, rc, "svt_scores_masked")
        launches["scores_masked"] += 1
    return out


# ---- the frame-shifted kernel: svt_scores_fs ------------------------------


@dataclasses.dataclass(frozen=True)
class FsTables:
    """What :func:`scores_fs` needs of one FS-class operator on one device.

    Every special row (column target, row-plan fix or recomputed row) is
    one entry: its value is ``min`` over the bulk candidate (if
    ``use_acc``), its scalar candidates ``val + v[src]``, and
    ``rmin_base + r_min`` (``rmin_base`` is +inf where the row is no
    column's target). The host flattens the plans into this one table;
    min is exact, so the flattening changes no value.

    The same tables drive the planned arms of :func:`scores_masked` and
    :func:`path`. For the path, dense column ``c`` (its target is special
    row ``col_slot[c]``, its base ``col_base[c]``) gives its shared part
    as one ``(value, source)`` candidate (:func:`_column_source`), and the
    uniform rows reach only the ``n_real`` real states.
    """

    n: int
    n_real: int
    d: int
    dv: torch.Tensor  # [n] f32, the single diagonal
    flags: torch.Tensor  # [n] uint8: ST_SHARED | ST_BULK | ST_SPECIAL | ST_USE_ACC
    uni_src: torch.Tensor  # [U] int64
    uni_val: torch.Tensor  # [U] f32
    sp_row: torch.Tensor  # [S] int64
    sp_use_acc: torch.Tensor  # [S] bool
    sp_shared: torch.Tensor  # [S] bool
    sp_rmin_base: torch.Tensor  # [S] f32
    cand_slot: torch.Tensor  # [K] int64, index into the special rows
    cand_src: torch.Tensor  # [K] int64
    cand_val: torch.Tensor  # [K] f32
    col_slot: torch.Tensor  # [C] int64, the special row of each column's target
    col_base: torch.Tensor  # [C] f32
    desc: _build.FsDesc

    @classmethod
    def build(cls, sop: StructuredOperator, col_plan, row_plan, shared_mask,
              device: torch.device) -> "FsTables":
        n = sop.n
        d = int(sop.diag_offsets[0])
        uni, fixes, recompute = row_plan
        rows: dict[int, dict] = {}

        def entry(r: int) -> dict:
            return rows.setdefault(r, {"use_acc": True, "rmin": np.inf, "cands": []})

        for target, base, extras in col_plan:
            entry(target)["rmin"] = base
            entry(target)["cands"] += [(val, j) for j, val in extras]
        for row, val, s_k in fixes:
            entry(row)["cands"].append((val, s_k))
        for row, dcands, rcands in recompute:
            entry(row)["use_acc"] = False
            entry(row)["cands"] += list(dcands) + list(rcands)
        shared = shared_mask[:, 0] == 0.0
        special = sorted(rows)
        n_cands = sum(len(rows[r]["cands"]) for r in special)
        caps = (
            (len(uni), _build.MAX_UNI, "uniform rows"),
            (len(special), _build.MAX_SPECIAL, "special rows"),
            (n_cands, _build.MAX_CANDS, "scalar candidates"),
        )
        for count, cap, what in caps:
            if count > cap:
                raise ValueError(f"operator has {count} {what}; the FS kernel takes {cap}")

        flags = np.where(shared, _build.ST_SHARED, 0).astype(np.uint8)
        bulk = shared.copy()
        bulk[special] = False
        flags[bulk] |= _build.ST_BULK
        flags[special] |= _build.ST_SPECIAL
        flags[[r for r in special if rows[r]["use_acc"]]] |= _build.ST_USE_ACC

        sp_use_acc = [rows[r]["use_acc"] for r in special]
        sp_shared = [bool(shared[r]) for r in special]
        sp_rmin = [rows[r]["rmin"] for r in special]
        cand_slot, cand_src, cand_val = [], [], []
        for s, r in enumerate(special):
            for val, src in rows[r]["cands"]:
                cand_slot.append(s)
                cand_src.append(int(src))
                cand_val.append(val)

        desc = _build.FsDesc(n=n, d=d, n_uni=len(uni), n_special=len(special))
        desc.uni_src[: len(uni)] = [s for s, _ in uni]
        desc.uni_val[: len(uni)] = [c for _, c in uni]
        desc.sp_row[: len(special)] = special
        desc.sp_flags[: len(special)] = [
            (_build.SP_USE_ACC if a else 0) | (_build.SP_SHARED if sh else 0)
            for a, sh in zip(sp_use_acc, sp_shared)
        ]
        desc.sp_rmin_base[: len(special)] = sp_rmin
        begin = np.searchsorted(cand_slot, np.arange(len(special) + 1)).tolist()
        desc.sp_begin[: len(begin)] = begin
        desc.cand_src[:n_cands] = cand_src
        desc.cand_val[:n_cands] = cand_val
        col_slot = [special.index(target) for target, _, _ in col_plan]
        col_base = [base for _, base, _ in col_plan]
        desc.n_real = sop.states_num
        desc.n_col = len(col_plan)
        desc.col_base[: len(col_plan)] = col_base
        desc.sp_col[: len(special)] = [
            col_slot.index(s) if s in col_slot else -1 for s in range(len(special))
        ]

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        return cls(
            n=n, n_real=sop.states_num, d=d,
            dv=f32(sop.diag_vals[0]),
            flags=torch.as_tensor(flags, device=device),
            uni_src=i64([s for s, _ in uni]), uni_val=f32([c for _, c in uni]),
            sp_row=i64(special),
            sp_use_acc=torch.as_tensor(sp_use_acc, dtype=torch.bool, device=device),
            sp_shared=torch.as_tensor(sp_shared, dtype=torch.bool, device=device),
            sp_rmin_base=f32(sp_rmin),
            cand_slot=i64(cand_slot), cand_src=i64(cand_src), cand_val=f32(cand_val),
            col_slot=i64(col_slot), col_base=f32(col_base),
            desc=desc,
        )


def _masked_min(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-lane min over the rows of ``x`` [m, B] where ``mask`` [m]."""
    inf = torch.full_like(x, float("inf"))
    return torch.where(mask[:, None], x, inf).amin(dim=0)


def scores_fs_plain(
    t: FsTables,
    em_t: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of ``svt_scores_fs`` (and, with ``lengths``, of
    ``svt_scores_masked_planned``): the same uniform-plan candidate
    arithmetic, step by step, in torch; lane ``b`` freezes once step
    ``k + 1`` reaches ``lengths[b]``. ``em_t`` [n, E] → [n, B]."""
    shared = (t.flags & _build.ST_SHARED).bool()
    bulk = (t.flags & _build.ST_BULK).bool()
    inf = float("inf")
    v = v0
    r_min = _masked_min(shared, v)  # [B]
    n_b = v.shape[1]
    for k in range(obs.shape[0]):
        em_sel = em_t[:, obs[k].long()]  # [n, B]
        ub = (t.uni_val[:, None] + v[t.uni_src]).amin(dim=0)  # [B]
        shifted = torch.roll(v, t.d, dims=0)  # wrap rows meet +inf in dv
        acc = torch.minimum(t.dv[:, None] + shifted, ub[None, :])
        v_new = em_sel + acc
        p = torch.where(t.sp_use_acc[:, None], acc[t.sp_row], torch.full_like(acc[t.sp_row], inf))
        if t.cand_slot.numel():
            cand = t.cand_val[:, None] + v[t.cand_src]
            p = p.scatter_reduce(0, t.cand_slot[:, None].expand(-1, n_b), cand, reduce="amin")
        p = torch.minimum(p, t.sp_rmin_base[:, None] + r_min[None, :])
        val = em_sel[t.sp_row] + p
        v_new[t.sp_row] = val
        # a frozen lane's r_min is never read again
        r_min = torch.minimum(_masked_min(bulk, v_new), _masked_min(t.sp_shared, val))
        if lengths is not None:
            v_new = torch.where(((k + 1) < lengths)[None, :], v_new, v)
        v = v_new
    return v


def scores_fs(
    t: FsTables, em: torch.Tensor, v0: torch.Tensor, obs: torch.Tensor
) -> torch.Tensor:
    """Advance every lane of ``v0`` [n, B] through all of ``obs``
    [T-1, B] (uniform lengths). ``em`` is the [E, n] emission table.
    Returns [n, B] f32."""
    if v0.device.type == "cpu":
        return scores_fs_plain(t, em.T, v0, obs)
    _check_cuda(t.n, em, v0, obs, None)
    out = torch.empty_like(v0)
    b = v0.shape[1]
    if b == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(v0.device):
        rc = lib.svt_scores_fs(
            ctypes.byref(t.desc),
            t.dv.data_ptr(), t.flags.data_ptr(), em.data_ptr(), v0.data_ptr(),
            obs.data_ptr(), out.data_ptr(), b, obs.shape[0],
            torch.cuda.current_stream(v0.device).cuda_stream,
        )
        _build.check(lib, rc, "svt_scores_fs")
        launches["scores_fs"] += 1
    return out


def scores_fs_shape(n: int, batch: int, device: torch.device) -> dict:
    """The shape ``svt_scores_fs`` launches for ``batch`` lanes of ``n``
    states on ``device``, as the card reports it: threads a lane, lanes a
    CTA, registers a thread and resident CTAs an SM."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    lib = _build.library()
    threads, regs, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.svt_scores_fs_shape(n, batch, ctypes.byref(threads), ctypes.byref(regs), ctypes.byref(ctas))
    _build.check(lib, rc, "svt_scores_fs_shape")
    return {"threads_a_lane": threads.value, "lanes_a_cta": 1, "registers": regs.value,
            "ctas_per_sm": ctas.value}


# ---- the path kernels: svt_path and svt_backtrace -------------------------


def _column_source(v: torch.Tensor, shared: torch.Tensor, base: torch.Tensor,
                   m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared part of one planned dense column, as one ``(value,
    source)`` candidate per lane: ``M = fl(base + m)`` with ``m`` the min
    of the carry ``v`` [n, B] over the ``shared`` rows [n] (monotone
    rounding makes it the min of the sums), and the LOWEST shared row
    ``i`` with ``fl(base + v[i]) == M`` (``NO_SOURCE`` where none).

    The second pass is what makes the argmin exact: two carries that
    differ can give one sum (4095.999267578125 and 4095.9990234375 both
    give 4096.9990234375 with base 1.0), and the oracle then takes the
    lower row, where the argmin of ``v`` would take the smaller carry."""
    mc = base + m
    rows = torch.arange(v.shape[0], device=v.device)[:, None]
    hit = shared[:, None] & (base + v == mc[None, :])
    return mc, torch.where(hit, rows, NO_SOURCE).amin(dim=0)


def path_planned_plain(
    t: FsTables,
    em_t: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``svt_path_planned``: the uniform plans'
    arithmetic with ``(value, source)`` pairs, step by step, the two-pass
    column argmin included (the shared min ``m`` of each step is taken from
    the previous step's carry). ``em_t`` [n, E] → (carry [n, B] f32,
    src [T-1, B, n] int16), equal to :func:`path_plain` of the operator's
    ``MaskedTables``."""
    n, b = v0.shape
    dev = v0.device
    inf = float("inf")
    shared = (t.flags & _build.ST_SHARED).bool()
    rows = torch.arange(n, device=dev)[:, None]
    real = rows < t.n_real
    n_sp = t.sp_row.shape[0]
    slot = torch.cat([t.cand_slot, t.col_slot])[:, None].expand(-1, b)
    src_all = torch.empty((obs.shape[0], b, n), dtype=torch.int16, device=dev)
    v = v0
    m = _masked_min(shared, v)  # [B]
    for k in range(obs.shape[0]):
        em_sel = em_t[:, obs[k].long()]  # [n, B]
        ub = torch.full((b,), inf, device=dev)
        us = torch.full((b,), NO_SOURCE, dtype=torch.int64, device=dev)
        for val, s in zip(t.uni_val[:, None] + v[t.uni_src], t.uni_src.tolist()):
            ub, us = take_pair(ub, us, val, s)
        # bulk: the diagonal (wrap rows meet +inf in dv), then the uniform
        # pair on the real rows
        u, s = take_pair(torch.full_like(v, inf), torch.full((n, b), NO_SOURCE, device=dev),
                         t.dv[:, None] + torch.roll(v, t.d, dims=0), rows - t.d)
        u, s = take_pair(u, s, torch.where(real, ub[None, :], inf), us[None, :].expand(n, b))
        # special rows: the bulk pair where used, then the lexicographic min
        # over their scalar candidates and their column's shared part
        su = torch.where(t.sp_use_acc[:, None], u[t.sp_row], inf)
        ss = torch.where(t.sp_use_acc[:, None], s[t.sp_row], NO_SOURCE)
        cols = [_column_source(v, shared, base, m) for base in t.col_base]
        cand = torch.cat([t.cand_val[:, None] + v[t.cand_src], *(mc[None] for mc, _ in cols)])
        cand_src = torch.cat([t.cand_src[:, None].expand(-1, b), *(ic[None] for _, ic in cols)])
        if cand.shape[0]:
            vmin = torch.full((n_sp, b), inf, device=dev).scatter_reduce(0, slot, cand, reduce="amin")
            tie = (cand == vmin.gather(0, slot)) & torch.isfinite(cand)
            smin = torch.full((n_sp, b), NO_SOURCE, device=dev).scatter_reduce(
                0, slot, torch.where(tie, cand_src, NO_SOURCE), reduce="amin")
            su, ss = take_pair(su, ss, vmin, smin)
        u[t.sp_row] = su
        s[t.sp_row] = ss
        v_new = em_sel + u
        src = torch.where(torch.isinf(u), 0, s)
        if lengths is not None:
            keep = ((k + 1) < lengths)[None, :]
            v_new = torch.where(keep, v_new, v)
            src = torch.where(keep, src, rows)
        src_all[k] = src.T
        m = _masked_min(shared, v_new)
        v = v_new
    return v, src_all


def path_plain(
    t: "MaskedTables | FsTables",
    em_t: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the arm of :func:`path` that ``t`` selects: the
    masked argmin scan (``MaskedTables``) or :func:`path_planned_plain`
    (``FsTables``). ``em_t`` [n, E] → (carry [n, B] f32, src [T-1, B, n]
    int16)."""
    if isinstance(t, FsTables):
        return path_planned_plain(t, em_t, v0, obs, lengths)
    return structured_path_batch(t.sop, t.arrs, em_t, v0, obs, lengths, torch.int16)


def path(
    t: "MaskedTables | FsTables",
    em: torch.Tensor,
    v0: torch.Tensor,
    obs: torch.Tensor,
    lengths: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance ``v0`` [n, B] through ``obs`` [T-1, B] as :func:`scores_masked`
    does, and keep the winning source of every step: returns
    ``(carry [n, B] f32, src [T-1, B, n] int16)``. A lane past its length
    writes identity pointers. ``em`` is the [E, n] emission table.

    ``MaskedTables`` launch the generic arm (``svt_path``), ``FsTables``
    the planned arm (``svt_path_planned``, an even state count); the two
    compute the same function bit for bit."""
    planned = isinstance(t, FsTables)
    n = t.n if planned else t.sop.n
    if n > INT16_STATES:
        raise ValueError(f"{n} states do not fit int16 backpointers")
    if v0.device.type == "cpu":
        return path_plain(t, em.T, v0, obs, lengths)
    _check_cuda(n, em, v0, obs, lengths)
    if planned and n % 2:
        raise ValueError(f"the planned path kernel takes an even state count, not {n}")
    steps, b = obs.shape
    out = torch.empty_like(v0)
    bp = torch.empty((steps, b, n), dtype=torch.int16, device=v0.device)
    if b == 0:
        return out, bp
    lib = _build.library()
    lens = None if lengths is None else lengths.data_ptr()
    stream = torch.cuda.current_stream(v0.device).cuda_stream
    with torch.cuda.device(v0.device):
        if planned:
            rc = lib.svt_path_planned(
                ctypes.byref(t.desc), t.dv.data_ptr(), t.flags.data_ptr(), em.data_ptr(),
                v0.data_ptr(), obs.data_ptr(), lens, out.data_ptr(), bp.data_ptr(), b, steps,
                stream,
            )
            _build.check(lib, rc, "svt_path_planned")
            launches["path_planned"] += 1
            return out, bp
        diag_vals, row_vals, col_vals, *_ = t.arrs
        rc = lib.svt_path(
            ctypes.byref(t.desc),
            diag_vals.data_ptr(), row_vals.data_ptr(), col_vals.data_ptr(),
            em.data_ptr(), v0.data_ptr(), obs.data_ptr(), lens,
            out.data_ptr(), bp.data_ptr(), b, steps, stream,
        )
        _build.check(lib, rc, "svt_path")
        launches["path"] += 1
    return out, bp


def backtrace_plain(src: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Plain version of ``svt_backtrace``: one ``gather`` of the [B, n]
    pointer row per step. ``src`` [T, B, n] (any integer type),
    ``boundary`` [B] → ``rev`` [T, B] int32, ``rev[t]`` the states at
    position ``t``, ``rev[T]`` being ``boundary``."""
    steps, b = src.shape[:2]
    rev = torch.empty((steps, b), dtype=torch.int32, device=src.device)
    state = boundary.long()[:, None]
    for k in range(steps - 1, -1, -1):
        state = src[k].gather(1, state).long()
        rev[k] = state[:, 0]
    return rev


def backtrace(src: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Walk ``src`` [T, B, n] int16 back from ``boundary`` [B] int32 (the
    states one position past the last pointer row) → ``rev`` [T, B]
    int32."""
    if src.device.type == "cpu":
        return backtrace_plain(src, boundary)
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    steps, b, n = src.shape
    for x, dtype, shape, name in (
        (src, torch.int16, (steps, b, n), "src"),
        (boundary, torch.int32, (b,), "boundary"),
    ):
        if x.device != src.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape} on {src.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rev = torch.empty((steps, b), dtype=torch.int32, device=src.device)
    if b == 0 or steps == 0:
        return rev
    lib = _build.library()
    with torch.cuda.device(src.device):
        rc = lib.svt_backtrace(
            src.data_ptr(), boundary.data_ptr(), rev.data_ptr(), b, n, steps,
            torch.cuda.current_stream(src.device).cuda_stream,
        )
        _build.check(lib, rc, "svt_backtrace")
        launches["backtrace"] += 1
    return rev


def _check_cuda(n, em, v0, obs, lengths) -> None:
    """What the kernels take: contiguous CUDA tensors of one device."""
    if v0.device.type != "cuda":
        raise ValueError(f"no kernel for device {v0.device}")
    if 2 * n * 4 + 4096 > _build.MAX_SMEM:
        raise ValueError(f"{n} states do not fit one block's shared memory")
    b = v0.shape[1]
    want = [
        (em, torch.float32, (em.shape[0], n), "em"),
        (v0, torch.float32, (n, b), "v0"),
        (obs, torch.int32, (obs.shape[0], b), "obs"),
    ]
    if lengths is not None:
        want.append((lengths, torch.int32, (b,), "lengths"))
    for x, dtype, shape, name in want:
        if x.device != v0.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape} on {v0.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _expand_symbols(flat, off, last, t_total: int) -> torch.Tensor:
    """Ragged → rectangular ``[T, B]`` on the device:
    ``out[t, b] = flat[min(off[b] + t, last[b])]`` — time padding repeats
    each lane's final symbol (padded steps are masked)."""
    t_iota = torch.arange(t_total, dtype=torch.int64, device=flat.device)[:, None]
    idx = torch.minimum(off[None, :] + t_iota, last[None, :])
    return flat[idx]


def stage_batch(seqs: list[np.ndarray], emit_num: int, device: torch.device,
                t_pad: int | None = None):
    """Validate a batch and upload it once → (seqs_t [T, B] int32,
    lengths [B] int32, masked) on ``device``; T is at least 2 and at least
    ``t_pad``. ``masked`` is False only when every lane runs every step."""
    seqs = [validate_obs_seq(s, emit_num) for s in seqs]
    if any(len(s) == 0 for s in seqs):
        # the recurrence consumes seq[0] before any masking
        raise ValueError("cannot decode an empty sequence")
    t_min = max(2, t_pad or 2)
    b = len(seqs)
    t_total = max(t_min, max(len(s) for s in seqs))
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    off = np.zeros(b, dtype=np.int64)
    np.cumsum(lengths[: b - 1], out=off[1:])
    last = off + lengths - 1
    seqs_t = _expand_symbols(
        torch.as_tensor(np.concatenate(seqs), device=device),
        torch.as_tensor(off, device=device),
        torch.as_tensor(last, device=device),
        t_total,
    )
    # mask when lengths differ OR when padding added timesteps every
    # lane would otherwise run (uniform length-1 batch, t_pad overshoot)
    masked = (
        len({len(s) for s in seqs}) > 1
        or max(len(s) for s in seqs) < t_min
    )
    return seqs_t, torch.as_tensor(lengths, device=device), masked


class StreamState(NamedTuple):
    """Resumable streaming-decode state: the device carry and the lane count."""

    carry: torch.Tensor  # [n, B] f32, +inf as the semiring zero
    b_real: int


class StreamChunk(NamedTuple):
    """One retained chunk of a path stream: the staged device symbols
    (T-quantized, reused as they are by the finalize re-run) and the real
    step count."""

    syms: torch.Tensor  # [T_q, B] int32
    lengths: torch.Tensor  # [B] int32, per lane valid + 1
    t_c: int


class PathStreamState(NamedTuple):
    """Streaming exact-path state: the carry plus, per fed chunk, the carry
    at the chunk's start (``checkpoints``) and the chunk (``chunks``)."""

    carry: torch.Tensor  # [n, B]
    b_real: int
    checkpoints: tuple  # of [n, B] carries
    chunks: tuple  # of StreamChunk


def model_key(prefix: str, sop: StructuredOperator, emissions, pi) -> str:
    """Content fingerprint guarding persisted stream states: values and
    structure (two models can share value bytes and differ in diagonal
    offsets), with shape and dtype delimiters. ``prefix`` names the
    engine, so a state of another engine (or of the JAX package, whose
    carries are ``BIG``-clamped) is refused."""
    h = hashlib.sha1(prefix.encode() + b"|")
    for a in (
        emissions, pi,
        sop.diag_vals, sop.row_vals, sop.col_vals, sop.res_vals,
        np.asarray(sop.diag_offsets, np.int64),
        np.asarray(sop.row_idx, np.int64),
        np.asarray(sop.col_idx, np.int64),
        np.asarray(sop.res_src, np.int64),
        np.asarray(sop.res_dst, np.int64),
    ):
        a = np.ascontiguousarray(a)
        h.update(f"{a.shape}{a.dtype}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


class _StreamAPI:
    """The streaming-decode protocol, shared by both stream engines.

    ``stream_begin/feed/scores`` (constant-memory scores over unbounded
    input), the ``stream_*_path`` family (exact paths by checkpoint and
    rematerialize), and ``stream_save/load``. An engine provides
    ``device``, ``n``, ``states_num``, ``emit_num``, ``em_t`` [n, E],
    ``pi`` [n], ``_model_key``, ``path_supported`` and the compute hooks
    ``_feed(carry, syms, lengths)``, ``_path_pointers(carry, syms,
    lengths) → src [T, B, n]`` and ``_backtrace(src, boundary)``. Two
    engines exist: :class:`FusedStructuredDecoder` (the kernels) and
    :class:`~spec_viterbi_tpu_torch.models.streaming_xla.PlainStreamDecoder`
    (the plain structured scan, any operator). Both carries are in +inf
    space, [n, B], with no lane padding.
    """

    def stream_begin(self, first_symbols: np.ndarray) -> StreamState:
        """[B] first symbols → streaming state (device carry [n, B])."""
        return StreamState(*self._begin(first_symbols))

    def stream_feed(self, state: StreamState, chunk: np.ndarray, valid=None) -> StreamState:
        """Advance the carry by a [T_c, B] block of symbols.

        ``valid`` (optional, [B] ints): per-lane count of real symbols in
        this chunk; lane ``i`` advances by ``valid[i]`` steps and then
        freezes (a finished lane passes 0). Omitted = every lane takes the
        whole chunk. Symbols past a lane's valid count must still be in the
        alphabet (pad with 0); they are masked off, never decoded.

        The chunk is padded to the ``quantize_t`` grid and run masked
        (padding steps freeze the carry), as in the JAX package."""
        prep = self._prep_stream_chunk(state.b_real, chunk, valid)
        if prep is None:
            return state
        syms, lengths = self._stage(*prep)
        return StreamState(self._feed(state.carry, syms, lengths), state.b_real)

    def _prep_stream_chunk(self, b_real: int, chunk, valid=None):
        """Validate a streaming chunk → ([T_c, B] int32, t_c, valid [B] |
        None), or None for an empty chunk."""
        chunk = np.asarray(chunk, dtype=np.int32)
        if chunk.ndim != 2 or chunk.shape[1] != b_real:
            raise ValueError(f"chunk must be [T_c, {b_real}], got {chunk.shape}")
        t_c = chunk.shape[0]
        if t_c == 0:
            return None
        validate_obs_seq(chunk.reshape(-1), self.emit_num)
        if valid is not None:
            valid = np.asarray(valid, dtype=np.int32)
            if valid.shape != (b_real,):
                raise ValueError(f"valid must be [{b_real}], got {valid.shape}")
            if (valid < 0).any() or (valid > t_c).any():
                raise ValueError(f"valid counts must be in [0, {t_c}]")
        return chunk, t_c, valid

    def _stage(self, chunk, t_c: int, valid=None):
        """T-quantize and upload a validated [t_c, B] chunk → (syms [T_q, B]
        int32, lengths [B] int32) on the device.

        The masked keep-condition is (step + 1) < lengths, so lane length
        ``valid_i + 1`` (``t_c + 1`` uniform) runs exactly steps
        0..valid_i-1: per-lane raggedness and the quantization pad ride
        the same mask."""
        t_q = quantize_t(t_c)
        if t_q != t_c:
            chunk = np.pad(chunk, ((0, t_q - t_c), (0, 0)))
        if valid is None:
            lengths = np.full(chunk.shape[1], t_c + 1, np.int32)
        else:
            lengths = (valid + 1).astype(np.int32)
        return (
            torch.as_tensor(np.ascontiguousarray(chunk), device=self.device),
            torch.as_tensor(lengths, device=self.device),
        )

    def _begin(self, first_symbols) -> tuple[torch.Tensor, int]:
        """[B] first symbols → (carry [n, B], B)."""
        syms = validate_obs_seq(first_symbols, self.emit_num)
        if len(syms) == 0:
            raise ValueError("cannot stream an empty lane set")
        s = torch.as_tensor(syms, device=self.device).long()
        return self.em_t[:, s] + self.pi[:, None], len(syms)

    def _extract(self, carry: torch.Tensor, b_real: int) -> torch.Tensor:
        return carry.T[:b_real, : self.states_num]

    def _last_state(self, carry: torch.Tensor) -> torch.Tensor:
        """Per-lane argmin end state (ties → lowest, all-inf → 0), [B] int32."""
        return torch.argmin(carry, dim=0).to(torch.int32)

    def _path_block(self, carry, syms, lengths, boundary, b_real: int):
        """One finalize block: rematerialize the chunk's backpointers from
        its checkpoint and walk them back from ``boundary`` (the states at
        the chunk's end, position p + T_q).

        Returns (piece [T_q, b_real] int32, the states at positions
        p+1..p+T_q; entries past the real chunk length repeat the boundary
        through the identity pad pointers, and the caller slices [:t_c]),
        and the new boundary rev[0], the states at position p."""
        src = self._path_pointers(carry, syms, lengths)
        rev = self._backtrace(src, boundary)  # [T_q, B], positions p..p+T_q-1
        piece = torch.cat([rev[1:], boundary[None]], dim=0)
        return piece[:, :b_real], rev[0]

    def stream_scores(self, state: StreamState) -> np.ndarray:
        """Current [B, states_num] scores; the state stays valid, so peeking
        mid-stream is allowed."""
        return self._extract(state.carry, state.b_real).cpu().numpy()

    # ---- streaming exact-path decode: checkpoint + rematerialize ----
    #
    # Exact paths need every step's backpointer, but one [T, B, n] pointer
    # tensor caps T at the memory budget. The path stream instead keeps the
    # O(n·B) carry at each chunk boundary during the forward pass (scores
    # only), and ``stream_path_finalize`` re-runs the pointer pass one
    # chunk at a time in reverse, walking back across chunk boundaries.
    # Device memory stays O(chunk); total device work is about 2x the
    # forward pass. Paths equal the one-shot path decode's and the oracle's.

    def _check_path_stream(self) -> None:
        """Engine veto hook for path streaming (pointer-type limits)."""

    def stream_begin_path(self, first_symbols: np.ndarray) -> PathStreamState:
        """[B] first symbols → path-streaming state."""
        self._check_path_stream()
        return PathStreamState(*self._begin(first_symbols), (), ())

    def stream_feed_path(
        self, state: PathStreamState, chunk: np.ndarray, valid=None
    ) -> PathStreamState:
        """Advance by a [T_c, B] block, checkpointing the pre-chunk carry.

        ``valid``: per-lane real-symbol counts as in :meth:`stream_feed`;
        frozen steps store identity pointers at finalize, so a ragged
        lane's path repeats its end state past its true length (the caller
        slices to ``1 + Σ valid``). The chunk's quantized length must fit
        the single-call backpointer budget (``path_supported``), since
        finalize re-runs it as one call."""
        prep = self._prep_stream_chunk(state.b_real, chunk, valid)
        if prep is None:
            return state
        _, t_c, _ = prep
        t_q = quantize_t(t_c)
        if not self.path_supported(t_q + 1, batch=state.b_real):
            raise ValueError(
                f"path chunk of {t_c} symbols ({t_q} quantized) exceeds the "
                f"backpointer budget at {state.b_real} lanes; feed smaller chunks"
            )
        syms, lengths = self._stage(*prep)
        return PathStreamState(
            self._feed(state.carry, syms, lengths),
            state.b_real,
            state.checkpoints + (state.carry,),
            state.chunks + (StreamChunk(syms, lengths, t_c),),
        )

    # current [B, states_num] scores of a path stream (peeking)
    stream_path_scores = stream_scores

    def stream_path_finalize(self, state: PathStreamState) -> tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, states_num], paths [B, T_total]), T_total = 1 + Σ
        chunk lengths. The state is not consumed: feeding may continue.

        The score extract, the boundary argmin and every reverse path
        block are enqueued back to back, then copied to the host."""
        scores = self._extract(state.carry, state.b_real)
        boundary = self._last_state(state.carry)
        pieces = []
        for rec, ckpt in zip(reversed(state.chunks), reversed(state.checkpoints)):
            piece, boundary = self._path_block(ckpt, rec.syms, rec.lengths, boundary, state.b_real)
            pieces.append((piece, rec.t_c))
        path = np.concatenate(
            [
                boundary.cpu().numpy()[None, : state.b_real],  # states at position 0
                *[p.cpu().numpy()[:t_c] for p, t_c in reversed(pieces)],
            ],
            axis=0,
        )  # [T_total, B]
        return scores.cpu().numpy(), path.T

    # ---- stream-state persistence --------------------------------------

    def stream_save(self, state, path: str) -> None:
        """Persist a StreamState or PathStreamState to ``path`` (.npz),
        published atomically."""
        payload = {
            "carry": state.carry.cpu().numpy(),
            "b_real": np.int64(state.b_real),
            "model_key": np.bytes_(self._model_key.encode()),
        }
        if isinstance(state, PathStreamState):
            payload["n_chunks"] = np.int64(len(state.chunks))
            for k, (ck, rec) in enumerate(zip(state.checkpoints, state.chunks)):
                payload[f"ckpt_{k}"] = ck.cpu().numpy()
                payload[f"chunk_{k}"] = rec.syms.cpu().numpy()
                payload[f"tc_{k}"] = np.int64(rec.t_c)
                payload[f"len_{k}"] = rec.lengths.cpu().numpy()
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)  # atomic publish

    def stream_load(self, path: str):
        """Load a stream state saved by :meth:`stream_save` of an engine of
        the same kind for the same model; resumes bit for bit (the carry is
        the whole forward state)."""
        with np.load(path) as z:
            if bytes(z["model_key"]).decode() != self._model_key:
                raise ValueError("stream state was saved for a different model/decoder")
            b_real = int(z["b_real"])

            def carry(key):
                c = z[key]
                if c.shape != (self.n, b_real) or c.dtype != np.float32:
                    raise ValueError(f"{key}: want float32 ({self.n}, {b_real}), got {c.dtype} {c.shape}")
                return torch.as_tensor(c, device=self.device)

            state_carry = carry("carry")
            if "n_chunks" not in z:
                return StreamState(state_carry, b_real)
            ckpts, chunks = [], []
            for k in range(int(z["n_chunks"])):
                ckpts.append(carry(f"ckpt_{k}"))
                syms = validate_obs_seq(z[f"chunk_{k}"].reshape(-1), self.emit_num)
                syms = syms.reshape(-1, b_real)
                lengths = np.asarray(z[f"len_{k}"], np.int32)
                if lengths.shape != (b_real,):
                    raise ValueError(f"len_{k}: want ({b_real},), got {lengths.shape}")
                chunks.append(StreamChunk(
                    torch.as_tensor(syms, device=self.device),
                    torch.as_tensor(lengths, device=self.device),
                    int(z[f"tc_{k}"]),
                ))
            return PathStreamState(state_carry, b_real, tuple(ckpts), tuple(chunks))


class FusedStructuredDecoder(_StreamAPI):
    """Whole-sequence fused decoder for one HMM: batched scores, exact
    paths, and the streaming protocol on the kernels."""

    def __init__(
        self,
        sop: StructuredOperator,
        emissions: np.ndarray,
        pi: np.ndarray,
        *,
        device: torch.device | str,
    ):
        if not fused_eligible(sop):
            raise ValueError(
                f"operator too irregular for the fused kernel "
                f"(components={sop.num_components}, residual={sop.residual_nnz})"
            )
        self.device = torch.device(device)
        self.sop = sop
        n = sop.n
        self.n = n
        self.states_num = sop.states_num
        self.emit_num = emissions.shape[0]
        self.em = torch.as_tensor(
            np.ascontiguousarray(emissions, np.float32), device=self.device
        )  # [E, n]
        self.em_t = self.em.T.contiguous()  # [n, E]
        self.pi = torch.as_tensor(np.asarray(pi, np.float32), device=self.device)
        self._masked = MaskedTables.build(sop, sop.to(self.device))

        plan = _plan_uniform_cols(sop)
        self._col_plan = plan[1] if plan else None
        self._row_plan = _plan_uniform_rows(sop)
        self._fs_ok = (
            self._col_plan is not None
            and self._row_plan is not None
            and sop.residual_nnz == 0
            and len(sop.diag_offsets) == 1
            and sop.diag_offsets[0] % n != 0
        )
        self._fs = (
            FsTables.build(sop, self._col_plan, self._row_plan, plan[0], self.device)
            if self._fs_ok
            else None
        )
        # the arms of the masked scores and path kernels, chosen here once
        # from the plans: the planned arms take the FS class (the planned
        # path kernel an even state count), the generic arms the rest
        self._scores_arm = self._masked if self._fs is None else self._fs
        self._path_arm = self._masked if self._fs is None or n % 2 else self._fs
        self._model_key = model_key("torch-fused", sop, emissions, pi)
        # the memory budget of one path call's int16 backpointer tensor;
        # the tests set it lower to force lane chunks and refusals
        self.MAX_PATH_BYTES = path_budget_bytes(self.device)

    def _scores_core(self, seqs_t, lengths, masked: bool) -> torch.Tensor:
        """State-major fused decode: [T, B] symbols → [n, B] scores."""
        v0 = self.em_t[:, seqs_t[0].long()] + self.pi[:, None]
        obs = seqs_t[1:]
        if not masked and self._fs_ok:
            # uniform-length batches of the single-diagonal class
            return scores_fs(self._fs, self.em, v0, obs)
        return scores_masked(self._scores_arm, self.em, v0, obs, lengths if masked else None)

    def _run(self, seqs_t, lengths, masked: bool = True, b_real: int | None = None):
        """Returns [B, n] scores; ``b_real`` slices to [b_real, states_num]."""
        out = self._scores_core(seqs_t, lengths, masked).T
        return out if b_real is None else out[:b_real, : self.states_num]

    def prepare(self, seqs: list[np.ndarray], t_pad: int | None = None):
        """Validate and upload a batch once; returns (seqs_t, lengths, masked).

        A uniform-length batch runs unmasked. ``t_pad`` forces the time
        dimension to a fixed (e.g. bucket-quantized) length.
        """
        return stage_batch(seqs, self.emit_num, self.device, t_pad)

    def run_prepared(self, handle) -> torch.Tensor:
        """Fused decode of a prepared batch; returns [B, n] device scores."""
        seqs_t, lengths, masked = handle
        return self._run(seqs_t, lengths, masked=masked)

    def decode_batch(
        self, seqs: list[np.ndarray], bucketed: bool = True
    ) -> list[np.ndarray]:
        """Decode a set of sequences; returns final score vectors.

        Ragged multi-block batches are length-bucketed (`bucket_plan`):
        each bucket runs only its own quantized max length. Every bucket
        is enqueued before the one device-to-host copy.
        """
        if not seqs:
            return []
        plan = (
            bucket_plan([len(s) for s in seqs], lane_block=BB)
            if bucketed
            else None
        )
        if plan is None:
            seqs_t, lengths, masked = self.prepare(seqs)
            v = self._run(seqs_t, lengths, masked=masked, b_real=len(seqs)).cpu().numpy()
            return [v[i] for i in range(len(seqs))]
        outs = []
        for idx, t_q in plan:
            st, ln, masked = self.prepare([seqs[i] for i in idx], t_pad=t_q)
            outs.append(self._run(st, ln, masked=masked, b_real=len(idx)))
        v = torch.cat(outs, dim=0).cpu().numpy()
        result: list[np.ndarray | None] = [None] * len(seqs)
        row = 0
        for idx, _ in plan:
            for i in idx:
                result[i] = v[row]
                row += 1
        return result

    # ---- exact paths -----------------------------------------------------

    def _path_core(self, seqs_t, lengths, masked: bool):
        """State-major fused path decode: [T, B] symbols → (scores [n, B],
        path [T, B] int32)."""
        v0 = self.em_t[:, seqs_t[0].long()] + self.pi[:, None]
        out, src = path(self._path_arm, self.em, v0, seqs_t[1:], lengths if masked else None)
        # first index on ties, 0 for an all-inf column: the oracle's argmin
        last = torch.argmin(out, dim=0).to(torch.int32)
        rev = backtrace(src, last)  # [T-1, B]
        return out, torch.cat([rev, last[None]], dim=0)

    def _run_path(self, seqs_t, lengths, masked: bool = True, b_real: int | None = None):
        """(scores [B, n], paths [B, T] int16) on the device; ``b_real``
        slices to [b_real, states_num] and [b_real, T]. The path is int16
        (``path_supported`` guarantees the states fit) and is widened on
        the host."""
        scores, paths = self._path_core(seqs_t, lengths, masked)
        scores, paths = scores.T, paths.T
        if b_real is not None:
            scores = scores[:b_real, : self.states_num]
            paths = paths[:b_real]
        return scores, paths.to(torch.int16)

    def path_supported(self, t_max: int, batch: int = BB) -> bool:
        """Whether ONE fused path call of this shape fits the budget.

        `decode_path_batch` additionally chunks wide batches into
        successive budget-sized calls, so a batch is decodable whenever
        ``path_supported(t_max)`` holds at the default 128-lane block.
        """
        if self.n > INT16_STATES:
            return False
        b_pad = ((batch + BB - 1) // BB) * BB
        return max(0, t_max - 1) * self.n * b_pad * 2 <= self.MAX_PATH_BYTES

    def _path_lane_budget(self, t_q: int) -> int:
        """Max lanes (multiple of 128) whose backpointer tensor fits."""
        per_lane = max(1, t_q - 1) * self.n * 2
        return (self.MAX_PATH_BYTES // per_lane) // BB * BB

    def decode_path_batch(
        self, seqs: list[np.ndarray], bucketed: bool = True
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """[(scores, path)] per sequence, with the oracle's tie rule.

        Bucketing (see `decode_batch`) also shrinks the backpointer tensor:
        each bucket allocates ``t_q·n·lanes`` instead of every lane paying
        the global max length, and each bucket is cut into calls of at most
        ``_path_lane_budget`` lanes. Every call is staged and launched
        before the first device-to-host copy.
        """
        if not seqs:
            return []
        if bucketed:
            lens = [len(s) for s in seqs]
            plan = bucket_plan(lens, lane_block=BB) or [(list(range(len(seqs))), max(lens))]
            calls = []
            for idx, t_q in plan:
                if not self.path_supported(t_q):
                    # the quantization overshoot (≤1.5×) may cross the budget
                    # even when the real lengths fit: run at the real length
                    t_q = max(lens[i] for i in idx)
                    if not self.path_supported(t_q):
                        raise ValueError(
                            f"path decode of length {t_q} exceeds the "
                            f"backpointer budget even at {BB} lanes; use "
                            f"the per-sequence path decode"
                        )
                step = max(BB, self._path_lane_budget(t_q))
                calls += [(idx[i : i + step], t_q) for i in range(0, len(idx), step)]
        else:
            t_max = max(len(s) for s in seqs)
            if not self.path_supported(t_max, batch=len(seqs)):
                # refuse before any launch: the one whole-batch pointer
                # tensor would not fit the budget
                raise ValueError(
                    f"whole-batch path decode ({len(seqs)} lanes × {t_max} "
                    f"steps) exceeds the backpointer budget; use bucketed=True"
                )
            calls = [(list(range(len(seqs))), t_max)]
        # a blocking upload waits for the stream, so stage every call first
        staged = [self.prepare([seqs[i] for i in idx], t_pad=t_q) for idx, t_q in calls]
        outs = [
            self._run_path(st, ln, masked=masked, b_real=len(idx))
            for (idx, _), (st, ln, masked) in zip(calls, staged)
        ]
        result: list[tuple[np.ndarray, np.ndarray] | None] = [None] * len(seqs)
        for (idx, _), (scores, paths) in zip(calls, outs):
            scores = scores.cpu().numpy()
            paths = paths.cpu().numpy()
            for row, i in enumerate(idx):
                result[i] = (scores[row], paths[row, : len(seqs[i])].astype(np.int32))
        return result

    # ---- the stream engine hooks (see _StreamAPI) ------------------------

    def _check_path_stream(self) -> None:
        if self.n > INT16_STATES:
            raise ValueError("path streaming needs int16-addressable states")

    def _feed(self, carry, syms, lengths):
        # One masked B1 launch (its arm chosen at __init__); the kernel stops
        # each lane at lengths[b] - 1. Path streams use the same feed: B1 is
        # exact f32 like B3, so the checkpoints equal the carries B3 re-runs
        # from, and the JAX package's separate exact-emission feed for paths
        # is not needed.
        return scores_masked(self._scores_arm, self.em, carry, syms, lengths)

    def _path_pointers(self, carry, syms, lengths):
        return path(self._path_arm, self.em, carry, syms, lengths)[1]

    def _backtrace(self, src, boundary):
        return backtrace(src, boundary)
