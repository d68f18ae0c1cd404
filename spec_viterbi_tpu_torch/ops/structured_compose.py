"""Tropical composition of structured operators: level-L specialization
without densification.

A copy of ``spec_viterbi_tpu/ops/structured_compose.py`` (numpy only),
held bit-equal to it by ``tests/test_torch_spec_structured.py``. The
dense level-L specialization materializes ``emit_num^L`` dense N×N tuple
operators (``GraphBLAS_spec_impl.cpp:15-36``): 10.43 GB at level 2 for
the port's 2,407-state stand-in (``SpecializedViterbi``, with its identity
symbol). This module removes that wall: the structured component family

- ``DIAG(d, vals)``   : M[i, i−d] = vals[i]
- ``RANK1(u, w)``     : M[i, j] = u[i] + w[j]   (tropical outer product)

is **closed under (min,+) matrix products**:

    DIAG(d1,a) ⊗ DIAG(d2,b)   = DIAG(d1+d2, a[i] + b[i−d1])
    DIAG(d,a)  ⊗ RANK1(u,w)   = RANK1(a + shift(u, d), w)
    RANK1(u,w) ⊗ DIAG(d,b)    = RANK1(u, shift(w+b, −d))
    RANK1(u1,w1) ⊗ RANK1(u2,w2) = RANK1(u1 + (w1 ⊙ u2), w2)   (scalar dot)

so a length-L tuple operator ``M_{o_L} ⊗ … ⊗ M_{o_1}`` is again a small sum
(tropical min) of diagonals and rank-1 terms, each stored as O(N) vectors:
level-L memory is ``E^L · (#components) · N`` floats instead of
``E^L · N²``. Dense rows (w = point), dense columns (u = point), and
residual COO entries are all RANK1 specializations, so every
`StructuredOperator` converts losslessly.

Components whose value vectors are entirely +inf are pruned (most cross
products die this way), and near-point rank-1 terms stay cheap to apply.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spec_viterbi_tpu_torch.ops.structured import StructuredOperator

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class Diag:
    offset: int
    vals: np.ndarray  # [N], vals[i] = M[i, i-offset]


@dataclasses.dataclass(frozen=True)
class Rank1:
    u: np.ndarray  # [N]
    w: np.ndarray  # [N]; M[i, j] = u[i] + w[j]


def _point(n: int, idx: int, val: float = 0.0) -> np.ndarray:
    v = np.full(n, INF, dtype=np.float32)
    v[idx] = val
    return v


def _shift_dst(vec: np.ndarray, d: int) -> np.ndarray:
    """out[i] = vec[i−d], out-of-range = +inf."""
    n = vec.shape[0]
    out = np.full(n, INF, dtype=np.float32)
    if d >= 0:
        out[d:] = vec[: n - d] if d else vec
    else:
        out[: n + d] = vec[-d:]
    return out


def from_structured(sop: StructuredOperator) -> list:
    """Convert a StructuredOperator's components to [Diag | Rank1]."""
    comps: list = []
    for k, d in enumerate(sop.diag_offsets):
        comps.append(Diag(d, sop.diag_vals[k].astype(np.float32)))
    n = sop.n
    for k, s in enumerate(sop.row_idx):
        comps.append(Rank1(sop.row_vals[k].astype(np.float32), _point(n, s)))
    for k, c in enumerate(sop.col_idx):
        comps.append(Rank1(_point(n, c), sop.col_vals[k].astype(np.float32)))
    for s, dst, v in zip(sop.res_src, sop.res_dst, sop.res_vals):
        comps.append(Rank1(_point(n, int(dst), float(v)), _point(n, int(s))))
    return comps


def _alive(c) -> bool:
    if isinstance(c, Diag):
        return bool(np.any(np.isfinite(c.vals)))
    return bool(np.any(np.isfinite(c.u))) and bool(np.any(np.isfinite(c.w)))


def compose_pair(a, b):
    """Component product ``a ⊗ b`` (apply b first, then a); None if dead."""
    if isinstance(a, Diag) and isinstance(b, Diag):
        vals = a.vals + _shift_dst(b.vals, a.offset)
        out = Diag(a.offset + b.offset, vals)
    elif isinstance(a, Diag):
        out = Rank1(a.vals + _shift_dst(b.u, a.offset), b.w)
    elif isinstance(b, Diag):
        # (R1 ⊗ D)[i,j] = u[i] + min_k (w[k] + [k-d == j] b[k])
        #              = u[i] + w[j+d] + b[j+d]
        out = Rank1(a.u, _shift_dst(a.w + b.vals, -b.offset))
    else:
        with np.errstate(invalid="ignore"):
            dot = float(np.min(a.w + b.u))
        if not np.isfinite(dot):
            return None
        out = Rank1(a.u + np.float32(dot), b.w)
    return out if _alive(out) else None


def compose(ops_a: list, ops_b: list, merge: bool = True) -> list:
    """All pairwise products, pruned; ``M_A ⊗ M_B`` as a component list."""
    out: list = []
    for a in ops_a:
        for b in ops_b:
            c = compose_pair(a, b)
            if c is not None:
                out.append(c)
    return _merge(out) if merge else out


def _merge(comps: list) -> list:
    """Cheap consolidations: equal-offset diagonals min together; rank-1
    terms sharing a point-w (same source column) min their u vectors."""
    if not comps:
        return []  # a fully annihilated product (e.g. a dead symbol)
    diags: dict[int, np.ndarray] = {}
    rank1s: list[Rank1] = []
    for c in comps:
        if isinstance(c, Diag):
            if c.offset in diags:
                diags[c.offset] = np.minimum(diags[c.offset], c.vals)
            else:
                diags[c.offset] = c.vals
        else:
            rank1s.append(c)

    # group point-w rank1s by source index (dense-row-like terms)
    by_src: dict[int, np.ndarray] = {}
    rest: list[Rank1] = []
    for c in rank1s:
        finite = np.isfinite(c.w)
        if finite.sum() == 1:
            s = int(np.nonzero(finite)[0][0])
            u = c.u + c.w[s]
            by_src[s] = np.minimum(by_src[s], u) if s in by_src else u
        else:
            rest.append(c)

    out: list = [Diag(d, v) for d, v in sorted(diags.items())]
    n = next(iter(diags.values())).shape[0] if diags else (
        rest[0].u.shape[0] if rest else next(iter(by_src.values())).shape[0]
    )
    out += [Rank1(u, _point(n, s)) for s, u in sorted(by_src.items())]
    out += rest
    return [c for c in out if _alive(c)]


# --------------------------------------------------------------------------
# Batched (array-form) composition: the production build path.
#
# The pairwise compose()/compose_pair() API above operates on one component
# at a time (kept for tests and algebra clarity). Building level-L stacks
# with it costs ~E^L · |A|·|B| tiny NumPy calls. The batched form keeps
# every level as
# padded arrays — diag stack [P, D, N] + rank-1 stacks [P, R, N] — and
# composes all P tuples per new symbol in whole-array ops. Slot structure
# replaces the per-instance point-w merge: a composed level has
#   diags:  {d_a + d_b} (min-merged by offset)
#   rank1s: the B slots (w inherited; u min-merged over every A component
#           that lands there) + one slot per (A-rank1 × B-diag) product,
# so the slot count grows LINEARLY per level (R' = R_b + Ra·Db), better
# than the ~2× growth of the instance-merged form.
# --------------------------------------------------------------------------


def batched_level1(sop: StructuredOperator, em: np.ndarray):
    """Level-1 operator stack in array form, emissions folded into dst.

    Returns ``(offsets, dv [E, D, N], uu [E, R, N], ww [E, R, N])`` where
    slot order is rows, cols, residual entries (``from_structured`` order).
    Dead symbols keep their (all-inf) slots so every symbol shares one
    schema — required for the vectorized level step.
    """
    base = from_structured(sop)
    diags = [c for c in base if isinstance(c, Diag)]
    r1s = [c for c in base if isinstance(c, Rank1)]
    e, n = em.shape
    offsets = tuple(c.offset for c in diags)
    with np.errstate(invalid="ignore"):
        if diags:
            dv = np.stack([c.vals for c in diags])[None] + em[:, None, :]
        else:
            dv = np.zeros((e, 0, n), np.float32)
        if r1s:
            uu = np.stack([c.u for c in r1s])[None] + em[:, None, :]
            ww = np.broadcast_to(
                np.stack([c.w for c in r1s])[None], (e, len(r1s), n)
            ).copy()
        else:
            uu = np.zeros((e, 0, n), np.float32)
            ww = np.zeros((e, 0, n), np.float32)
    return offsets, dv.astype(np.float32), uu.astype(np.float32), ww


def _shift_dst_batch(x: np.ndarray, d: int) -> np.ndarray:
    """Batched ``_shift_dst`` along the last axis: out[..., i] = x[..., i−d]."""
    n = x.shape[-1]
    out = np.full_like(x, INF)
    if d == 0:
        return x.copy()
    if d > 0:
        out[..., d:] = x[..., : n - d]
    else:
        out[..., : n + d] = x[..., -d:]
    return out


def _shift_bool(x: np.ndarray, d: int) -> np.ndarray:
    """``_shift_dst_batch`` on boolean footprints (False = +inf)."""
    out = np.zeros_like(x)
    n = x.shape[-1]
    if d == 0:
        return x
    if d > 0:
        out[..., d:] = x[..., : n - d]
    else:
        out[..., : n + d] = x[..., -d:]
    return out


def _slot_plan(l1, prev):
    """A-priori slot aliveness from finiteness footprints.

    A composed entry at ``(e, p, i)`` is finite only where both factors
    are, and the batch axes are independent under broadcasting, so a slot
    is alive iff the any-over-batch footprints of its factors intersect
    (exact for diag products and diag×rank1 u-merges; conservative for
    rank1×rank1, where the e-axis couples ``auu`` and ``aww`` — a false
    "alive" just stores an all-inf slot, which is the min-identity and
    semantically inert). The slabs are therefore allocated at their final
    pruned size, with no post-hoc prune and copy.

    Returns ``(out_offsets, diag_pairs, g1_slots, g2_slots)`` where
    ``diag_pairs[slot] = [(ka, kb), …]`` lists live contributing pairs,
    ``g1_slots = [(r, [ka…], [a…]), …]`` the live inherited slots with
    their live diag/rank1 contributors, and ``g2_slots = [(a, kb), …]``.
    """
    offs_a, adv, auu, aww = l1
    offs_b, bdv, buu, bww = prev
    fa_d = np.isfinite(adv).any(axis=0)  # [Da, n]
    fb_d = np.isfinite(bdv).any(axis=0)  # [Db, n]
    fa_u = np.isfinite(auu).any(axis=0)  # [Ra, n]
    fa_w = np.isfinite(aww).any(axis=0)
    fb_u = np.isfinite(buu).any(axis=0)  # [Rb, n]
    fb_w = np.isfinite(bww).any(axis=0)
    fa_u_any = fa_u.any(axis=-1)  # [Ra]
    fb_w_any = fb_w.any(axis=-1)  # [Rb]

    pairs: dict[int, list[tuple[int, int]]] = {}
    for ka, d_a in enumerate(offs_a):
        for kb, d_b in enumerate(offs_b):
            if (fa_d[ka] & _shift_bool(fb_d[kb], d_a)).any():
                pairs.setdefault(d_a + d_b, []).append((ka, kb))
    out_offsets = sorted(pairs)
    diag_pairs = [pairs[d] for d in out_offsets]

    g1_slots = []
    for r in range(buu.shape[1]):
        if not fb_w_any[r]:
            continue  # w all-inf: slot is inert whatever u merges in
        kas = [
            ka
            for ka, d_a in enumerate(offs_a)
            if (fa_d[ka] & _shift_bool(fb_u[r], d_a)).any()
        ]
        aas = [
            a
            for a in range(auu.shape[1])
            if fa_u_any[a] and (fa_w[a] & fb_u[r]).any()
        ]
        if kas or aas:
            g1_slots.append((r, kas, aas))

    g2_slots = [
        (a, kb)
        for a in range(auu.shape[1])
        for kb in range(len(offs_b))
        if fa_u_any[a] and (fa_w[a] & fb_d[kb]).any()
    ]
    return out_offsets, diag_pairs, g1_slots, g2_slots


def batched_compose_level(l1, prev, threads: int | None = None):
    """One ``add_level`` step in array form: all E symbols × all P tuples.

    ``l1 = (offsets_a, adv [E,Da,N], auu [E,Ra,N], aww [E,Ra,N])`` is the
    level-1 stack; ``prev = (offsets_b, bdv [P,Db,N], buu [P,Rb,N],
    bww [P,Rb,N])`` the previous level. Output tuple index is ``p + o·P``
    (new symbol = most-significant radix digit, matching
    ``GraphBLAS_spec_impl.cpp:15-36`` and the scalar path). All-inf diag
    offsets and rank-1 slots are pruned globally.

    Dead slots are identified BEFORE allocation from finiteness footprints
    (`_slot_plan`), so the ``[E, P, slots, N]`` output slabs are allocated
    at their final pruned size — no post-hoc copy — with ``np.empty``
    (the JAX package pre-faults them with its ``populate_empty``, a
    first-touch measure for its build machines; the contents are the
    same). The fill is a thread pool over P-chunks with ``out=``-parameter
    ufuncs (NumPy releases the GIL on large arrays), writing each slab
    exactly once.
    """
    import concurrent.futures
    import os as _os

    offs_a, adv, auu, aww = l1
    offs_b, bdv, buu, bww = prev
    e, _, n = adv.shape
    p = bdv.shape[0]

    out_offsets, diag_pairs, g1_slots, g2_slots = _slot_plan(l1, prev)
    dc = len(out_offsets)
    rc = len(g1_slots) + len(g2_slots)
    dv_out = np.empty((e, p, dc, n), np.float32)
    uu_out = np.empty((e, p, rc, n), np.float32)
    ww_out = np.empty((e, p, rc, n), np.float32)

    # shifted B stacks shared across symbols and chunks (only offsets a
    # live contributor actually uses)
    used_d = {offs_a[ka] for pl in diag_pairs for ka, _ in pl} | {
        offs_a[ka] for _, kas, _ in g1_slots for ka in kas
    }
    shifted_bdv = {d_a: _shift_dst_batch(bdv, d_a) for d_a in used_d}
    shifted_buu = {d_a: _shift_dst_batch(buu, d_a) for d_a in used_d}

    def fill(p0: int, p1: int) -> None:
        sl = slice(p0, p1)
        buf = np.empty((e, p1 - p0, n), np.float32)
        with np.errstate(invalid="ignore"):
            # diagonals: Diag(d_a) ⊗ Diag(d_b) → Diag(d_a+d_b), min-merged
            for slot, pair_list in enumerate(diag_pairs):
                acc = dv_out[:, sl, slot, :]
                acc[:] = INF
                for ka, kb in pair_list:
                    np.add(
                        adv[:, None, ka, :],
                        shifted_bdv[offs_a[ka]][None, sl, kb, :],
                        out=buf,
                    )
                    np.minimum(acc, buf, out=acc)
            # group 1: w inherited from B slot r; u min-merged over every
            # live A component landing there (diag shifts + rank-1 dots)
            for slot, (r, kas, aas) in enumerate(g1_slots):
                acc = uu_out[:, sl, slot, :]
                acc[:] = INF
                for ka in kas:
                    np.add(
                        adv[:, None, ka, :],
                        shifted_buu[offs_a[ka]][None, sl, r, :],
                        out=buf,
                    )
                    np.minimum(acc, buf, out=acc)
                for a in aas:
                    np.add(aww[:, None, a, :], buu[None, sl, r, :], out=buf)
                    dot = buf.min(axis=-1)  # [E, pc]
                    np.add(auu[:, None, a, :], dot[:, :, None], out=buf)
                    np.minimum(acc, buf, out=acc)
                ww_out[:, sl, slot, :] = bww[None, sl, r, :]
            # group 2: Rank1(a) ⊗ Diag(d_b) → Rank1(a.u, shift(a.w+b.vals))
            for slot, (a, kb) in enumerate(g2_slots, start=len(g1_slots)):
                d_b = offs_b[kb]
                np.add(aww[:, None, a, :], bdv[None, sl, kb, :], out=buf)
                ww_out[:, sl, slot, :] = _shift_dst_batch(buf, -d_b)
                uu_out[:, sl, slot, :] = auu[:, None, a, :]

    nt = threads or min(4, _os.cpu_count() or 1)
    if nt > 1 and p >= 2 * nt:
        bounds = np.linspace(0, p, nt + 1, dtype=int)
        with concurrent.futures.ThreadPoolExecutor(max_workers=nt) as pool:
            list(pool.map(lambda i: fill(bounds[i], bounds[i + 1]), range(nt)))
    else:
        fill(0, p)

    return (
        tuple(out_offsets),
        dv_out.reshape(e * p, dc, n),
        uu_out.reshape(e * p, rc, n),
        ww_out.reshape(e * p, rc, n),
    )


def batched_levels(sop: StructuredOperator, em: np.ndarray, level: int):
    """Level-1 … level-L stacks in array form; returns (l1, lL)."""
    l1 = batched_level1(sop, em)
    cur = l1
    for _ in range(level - 1):
        cur = batched_compose_level(l1, cur)
    return l1, cur


def apply_components(comps: list, v: np.ndarray) -> np.ndarray:
    """NumPy oracle apply: ``u[i] = min over components`` (for tests)."""
    n = v.shape[0]
    out = np.full(n, INF, dtype=np.float32)
    for c in comps:
        if isinstance(c, Diag):
            cand = c.vals + _shift_dst(v, c.offset)
        else:
            with np.errstate(invalid="ignore"):
                dot = np.min(c.w + v)
            cand = c.u + dot if np.isfinite(dot) else np.full(n, INF, np.float32)
        out = np.minimum(out, cand)
    return out


def to_dense(comps: list, n: int) -> np.ndarray:
    """Dense [N, N] TN matrix of a component list (for tests)."""
    m = np.full((n, n), INF, dtype=np.float32)
    for c in comps:
        if isinstance(c, Diag):
            for i in range(n):
                j = i - c.offset
                if 0 <= j < n and np.isfinite(c.vals[i]):
                    m[i, j] = min(m[i, j], c.vals[i])
        else:
            with np.errstate(invalid="ignore"):
                m = np.minimum(m, c.u[:, None] + c.w[None, :])
    return m
