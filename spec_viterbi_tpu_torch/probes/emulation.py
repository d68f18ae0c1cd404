"""Torch emulations of the order in which the redesigned kernels work.

Each emulation computes what its kernel computes, in the kernel's order
and driven by the same tables and constants, with plain tensor
operations. The tests hold them equal to the plain versions of
``ops/fused.py`` on the CPU, which the kernels equal on the card, and
``chip_smoke.py`` runs :func:`backtrace_staged` on the card's own pointer
tensors to count the misses of the main path's walks.

- :func:`backtrace_staged`: ``svt_backtrace``'s staged walk
  (``csrc/path.cu``). A tile of ``BT_TILE`` steps has, for each step, a
  band of ``BT_BAND`` pointers staged from its row ``BT_AHEAD`` tiles
  ahead of the walk, placed from the state at the tile's start and the
  drift learned from the steps just walked, and the 8 pointers around the
  row's state 0 (the hub chunk). A state outside both is a miss: that
  pointer is read from the tensor itself and the bands not yet walked are
  placed again from there, unless the step before missed and jumped (the
  walk is adrift), when the pointer is only read. Which pointer is read
  never depends on the bands, so the path is ``backtrace_plain``'s; the
  bands decide only where the kernel waits.
- :func:`scores_fs_one_barrier`: ``svt_scores_fs``'s step with one
  barrier (``csrc/scores.cu``): every row, special ones included, is
  formed by its owner from the previous carry, the shared column min
  ``r_min`` and the uniform rows' scalar ``ub``; both of those for the next
  step are reduced from the new carry in the same pass, each uniform-row
  source contributing its slot's value plus its new score.
"""

from __future__ import annotations

import torch

from spec_viterbi_tpu_torch.ops import _build

NO_BAND = -(1 << 30)  # row-relative band start of a row with no band


def _align_down(x: torch.Tensor | int, mis: int):
    """The largest element index <= x whose address is 16-byte aligned,
    for an int16 tensor whose first element sits ``mis`` elements past a
    16-byte boundary."""
    return x - ((x + mis) & 7)


def backtrace_staged(src: torch.Tensor, boundary: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``svt_backtrace``'s walk of ``src`` [T, B, n] int16 from ``boundary``
    [B] → (``rev`` [T, B] int32, equal to ``backtrace_plain``'s, and the
    misses of each lane [B] int64). The bands' 16-byte alignment follows
    ``src``'s address, as the kernel's copies do."""
    steps, batch, n = src.shape
    mis = (src.data_ptr() // src.element_size()) % 8  # elements past a 16-byte boundary
    k_tile, w, ahead = _build.BT_TILE, _build.BT_BAND, _build.BT_AHEAD
    dev = boundary.device
    i64 = dict(dtype=torch.int64, device=dev)
    lanes = torch.arange(batch, **i64)
    total = steps * batch * n
    lo_al, hi_al = _align_down(7, mis), _align_down(total, mis)
    banded = hi_al - w >= lo_al
    rel = torch.full((steps, batch), NO_BAND, **i64)  # row-relative band start
    hub = torch.full((steps, batch), NO_BAND, **i64)  # row-relative start of the chunk of state 0
    s = boundary.to(torch.int64)
    dq = torch.zeros(batch, **i64)  # the drift, dq / 2^16 a step
    ref_r = torch.full((batch,), steps - 1, **i64)
    ref_s = s.clone()
    misses = torch.zeros(batch, **i64)
    adrift = torch.zeros(batch, dtype=torch.bool, device=dev)  # the last step missed and jumped
    rev = torch.empty((steps, batch), dtype=torch.int32, device=dev)
    ntiles = -(-steps // k_tile)

    def top(x: int) -> int:  # the first (highest) row of tile x
        return steps - 1 - x * k_tile

    def place(r_hi: int, r_lo: int, anchor_r, anchor_s, mask=None) -> None:
        """Bands and hub chunks of rows r_hi down to r_lo, from the anchor
        (the state ``anchor_s`` enters row ``anchor_r``) and the drift."""
        if r_hi < r_lo or not banded:
            return
        rows = torch.arange(r_lo, r_hi + 1, **i64)[:, None]
        pred = anchor_s[None, :] + ((dq[None, :] * (anchor_r[None, :] - rows) + 32768) >> 16)
        base = (rows * batch + lanes[None, :]) * n
        lo = _align_down(base + (pred - w // 2).clamp_min(0), mis)
        lo = torch.minimum(lo, _align_down(base + n + 7, mis) - w).clamp(lo_al, hi_al - w)
        hl = _align_down(base, mis).clamp(lo_al, hi_al - 8)
        sl = slice(r_lo, r_hi + 1)
        keep = torch.ones_like(lo, dtype=torch.bool) if mask is None else mask[None, :]
        rel[sl] = torch.where(keep, lo - base, rel[sl])
        hub[sl] = torch.where(keep, hl - base, hub[sl])

    def learn(r: int, mask) -> None:
        """Take the drift of the stretch since the reference point, once it
        is ``BT_MIN_ROWS`` steps long (truncated as C's division)."""
        rows = ref_r - r
        ok = mask & (rows >= _build.BT_MIN_ROWS)
        new = torch.div((s - ref_s) * 65536, rows.clamp_min(1), rounding_mode="trunc")
        dq.copy_(torch.where(ok, new, dq))

    full = torch.ones(batch, dtype=torch.bool, device=dev)
    for x in range(min(ahead, ntiles)):
        place(top(x), max(top(x) - k_tile + 1, 0), ref_r, s)
    for j in range(ntiles):
        r0 = top(j)
        learn(r0, full)
        ref_r.fill_(r0)
        ref_s.copy_(s)
        if j + ahead < ntiles:
            x = j + ahead
            place(top(x), max(top(x) - k_tile + 1, 0), ref_r, s)
        end = max(top(min(j + ahead, ntiles - 1)) - k_tile + 1, 0)  # last row in flight
        for r in range(r0, max(r0 - k_tile, -1), -1):
            off, off_hub = s - rel[r], s - hub[r]
            miss = ((off < 0) | (off >= w)) & ((off_hub < 0) | (off_hub >= 8))
            misses.add_(miss.long())
            restage = miss & ~adrift
            if bool(restage.any()):
                learn(r, restage)
                place(r - 1, end, torch.full_like(s, r), s, restage)
            s_new = src[r].gather(1, s[:, None])[:, 0].to(torch.int64)
            jump = (s_new - s).abs() > _build.BT_JUMP
            ref_r.copy_(torch.where(jump, r - 1, ref_r))
            ref_s.copy_(torch.where(jump, s_new, ref_s))
            adrift = miss & jump
            rev[r] = s_new.to(torch.int32)
            s = s_new
    return rev, misses


def scores_fs_one_barrier(t, em_t: torch.Tensor, v0: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """``svt_scores_fs``'s step order on the FS tables ``t``
    (``fused.FsTables``): ``em_t`` [n, E], ``v0`` [n, B], ``obs`` [T-1, B]
    → [n, B], equal to ``scores_fs_plain`` bit for bit.

    Each step reads the previous step's partials ``(r_min, ub)``; the
    special rows (``ST_SPECIAL`` in ``t.flags``) park their own candidates,
    ``sp_rmin_base + r_min`` and their scalar ones, in their slots of the
    new carry; the bulk pass takes the diagonal pair and ``ub``, and at a
    special row the parked value (``ST_USE_ACC``: the min of both); the new
    carry's partials follow: ``r_min`` over the ``ST_SHARED`` rows, ``ub``
    over the uniform rows' sources, each slot's value plus its new score."""
    inf = float("inf")
    flags = t.flags.to(torch.int64)
    shared = (flags & _build.ST_SHARED).bool()
    special = (flags & _build.ST_SPECIAL).bool()[:, None]
    use_acc = (flags & _build.ST_USE_ACC).bool()[:, None]
    b = v0.shape[1]

    def partials(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        r_min = torch.where(shared[:, None], v, inf).amin(dim=0)
        if t.uni_src.numel() == 0:
            return r_min, torch.full_like(r_min, inf)
        return r_min, (t.uni_val[:, None] + v[t.uni_src]).amin(dim=0)

    r_min, ub = partials(v0)
    v = v0
    for k in range(obs.shape[0]):
        park = torch.full_like(v, inf)
        own = t.sp_rmin_base[:, None] + r_min[None, :]
        if t.cand_slot.numel():
            own = own.scatter_reduce(0, t.cand_slot[:, None].expand(-1, b),
                                     t.cand_val[:, None] + v[t.cand_src], reduce="amin")
        park[t.sp_row] = own
        a = torch.minimum(t.dv[:, None] + torch.roll(v, t.d, dims=0), ub[None, :])
        a = torch.where(special, torch.where(use_acc, torch.minimum(a, park), park), a)
        v = em_t[:, obs[k].long()] + a
        r_min, ub = partials(v)
    return v
