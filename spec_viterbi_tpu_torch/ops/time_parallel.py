"""Time-parallel single-sequence decode via the structured closure.

The port of ``spec_viterbi_tpu/ops/time_parallel.py``. A batch fills the
fused kernels' lanes; a single sequence occupies one lane, one CTA of the
card. This module maps TIME BLOCKS of one sequence onto lanes:

1. **Compose** (parallel over blocks): the ``T−1`` recurrence steps split
   into ``nb = (T−1)//k`` blocks of ``k`` symbols, and each block's
   operator ``M_block = M_{o_k} ⊗ … ⊗ M_{o_1}`` is built in the
   banded+low-rank closure of :mod:`.structured_compose`: a band of
   ``W = k·span+1`` diagonals (``span = max(D) − min(D)``) plus
   ``S = R1·k`` rank-1 slots (``R1`` a level-1 operator), never dense.
   All ``nb`` blocks compose together over a ``[nb, ·, N]`` layout, by a
   loop over the ``k−1`` steps (``compose="scan"``) or ``log2(k)``
   pairwise levels (``"tree"``).
2. **Fold** (sequential, short): the ``nb`` block operators applied to
   the frontier in order; the frontier before each block is kept.
3. **Tail**: the ``(T−1) mod k`` leftover symbols, the plain structured
   step.
4. **Paths** (optional): every block's backpointers rematerialized in
   ONE launch of the fused path kernel (lane ``b`` = block ``b``, from
   its kept frontier), then one backtrace launch across the blocks.

The two (min,+) contractions of the compose and of the fold (a slot
store against a rank-1 component's ``w``, then the resulting dots
against the components' ``u``) go through the hand-written product
:func:`~spec_viterbi_tpu_torch.ops.tropical.minplus` (``svt_minplus``;
its plain version on a CPU tensor), on strided views: no ``[nb, R1, S,
N]`` broadcast is built. The band products and shifts are elementwise
PyTorch, as the JAX package computes its whole compose in XLA.

Exactness: every compose, fold and tail value is a min of candidates that
are each one rounded f32 add of the same two operands as in the JAX
module, so the scores are bit-equal to the JAX ``TimeParallelDecoder``
with the same ``k`` and ``compose``. Against serial decode they drift by
ulps (the operator values pre-combine before they meet the frontier),
within the reference's ±1.0 contract; scan and tree differ from each
other the same way. Paths are rematerialized with the exact serial
per-step rules, so they equal the oracle's unless an ulp drift crosses
an argmin tie.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import validate_obs_seq
from spec_viterbi_tpu_torch.ops import fused, tropical
from spec_viterbi_tpu_torch.ops.structured import (
    StructuredOperator,
    structured_mv_batch,
    structured_path_batch,
)
from spec_viterbi_tpu_torch.ops.structured_compose import batched_level1

INF = float("inf")

# Composed-band width ceiling: per compose step the band product costs
# m·W state passes over [nb, N]; past ~256 slots the compose work swamps
# the lanes it parallelizes over. Every Pfam corpus model has span = 0
# (W = 1); the cap only gates wide synthetic multi-diagonal bands.
MAX_BAND_SLOTS = 256


def _band_geometry(sop: StructuredOperator, k: int) -> tuple[int, int, int]:
    """(min_d, span, W): the composed block band after ``k`` steps holds
    offsets ``k·min_d + j`` for ``j`` in [0, W)."""
    if sop.diag_offsets:
        min_d = min(sop.diag_offsets)
        span = max(sop.diag_offsets) - min_d
    else:
        min_d, span = 0, 0
    return min_d, span, k * span + 1


def time_parallel_supported(sop: StructuredOperator, k: int = 8) -> bool:
    """Any structured operator composes in the banded+low-rank closure;
    the only gate is the composed band width ``k·span+1`` staying within
    ``MAX_BAND_SLOTS``."""
    _, _, w = _band_geometry(sop, k)
    return w <= MAX_BAND_SLOTS


def _shift(x: torch.Tensor, d: int, dim: int = -1) -> torch.Tensor:
    """out[..., i, ...] = x[..., i−d, ...] along ``dim``, +inf fill."""
    if d == 0:
        return x
    n = x.shape[dim]
    out = torch.full_like(x, INF)
    if abs(d) < n:
        if d > 0:
            out.narrow(dim, d, n - d).copy_(x.narrow(dim, 0, n - d))
        else:
            out.narrow(dim, 0, n + d).copy_(x.narrow(dim, -d, n + d))
    return out


def _dots_then_cross(u_b: torch.Tensor, w_a: torch.Tensor, u_a: torch.Tensor) -> torch.Tensor:
    """``min_r (u_a[g,r,n] + min_m (w_a[g,r,m] + u_b[g,s,m]))`` → [G, S, N]:
    the rank-1 × rank-1 term of a product, in two ``minplus`` launches.
    The first gives the dots transposed, ``[G, S, R]`` (``u_b`` read
    through its strides), which is the second's A as it stands."""
    dots_t = tropical.minplus(u_b, w_a.transpose(1, 2).contiguous())  # [G, S, R]
    return tropical.minplus(dots_t, u_a.contiguous())  # K = R


class TimeParallelDecoder:
    """Single-sequence decoder that trades lane occupancy for latency.

    ``compose`` picks the block-composition schedule:

    - ``"scan"`` (default): a loop over the ``k−1`` steps on slot and band
      stores padded to their final size with +inf (dead slots stay dead
      through every product rule).
    - ``"tree"``: pairwise merges, ``log2(k)`` levels (``k`` must be a
      power of two). The store is touched once a level, not once a step.
      Float association differs from the scan and from serial decode;
      both stay inside the ±1.0 contract, and paths rematerialize with
      the exact serial rules either way.

    Runs on ``device``: the contractions launch ``svt_minplus`` on a CUDA
    device and take its plain version on the CPU.
    """

    def __init__(
        self,
        sop: StructuredOperator,
        emissions,
        pi,
        k: int = 8,
        compose: str = "scan",
        *,
        device: torch.device | str,
    ):
        if not time_parallel_supported(sop, k):
            raise ValueError(
                f"composed band would exceed {MAX_BAND_SLOTS} slots at k={k} "
                "(see time_parallel_supported)"
            )
        if compose not in ("scan", "tree"):
            raise ValueError(f"compose must be 'scan' or 'tree', got {compose!r}")
        if compose == "tree" and (k & (k - 1)):
            raise ValueError(f"tree compose needs k a power of two, got {k}")
        self.device = torch.device(device)
        self.compose = compose
        self.sop = sop
        self.k = int(k)
        self.n = sop.n
        self.states_num = sop.states_num
        em = np.asarray(emissions, dtype=np.float32)
        self.emit_num = int(em.shape[0])
        self.min_d, self.span, self.w_band = _band_geometry(sop, self.k)
        offsets, dv1, uu1, ww1 = batched_level1(sop, em)
        assert offsets == tuple(sop.diag_offsets)
        self.offsets = offsets
        self.r1 = uu1.shape[1]  # rank-1 slots per level-1 operator

        def up(x):
            return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32), device=self.device)

        self._dv1 = up(dv1)  # [E, m, N]
        self._uu1 = up(uu1)  # [E, R1, N]
        self._ww1 = up(ww1)  # [E, R1, N]
        self._em_t = up(em.T)  # [N, E]
        self._pi = up(pi)
        self._arrs = sop.to(self.device)

    # ---- phase 1: block-operator composition (lanes = time blocks) ------

    def _compose_blocks(self, syms: torch.Tensor):
        """syms [nb, k] int64 → (bv [nb, W, N] band, uu/ww [nb, R1·k, N]
        rank-1 slots): band slot ``j`` holds the diagonal at offset
        ``k·min_d + j``."""
        if self.compose == "scan":
            return self._compose_scan(syms)
        return self._compose_tree(syms)

    def _compose_scan(self, syms: torch.Tensor):
        """The loop over steps 1..k−1, A = this step's level-1 operator,
        B = the running block operator. Band slot ``j`` at time ``t`` holds
        the diagonal at offset ``t·min_d + j`` (A's diagonal ``d_i`` shifts
        slot indices by ``d_i − min_d``); inherited rank-1 slots keep their
        w and min-merge their u over A's diagonal shifts and A's rank-1
        dots; A's R1 rank-1 components land in slot block ``t``, their w
        composed through B's band."""
        k, r1, w_band = self.k, self.r1, self.w_band
        min_d, offsets = self.min_d, self.offsets
        dv1, uu1, ww1 = self._dv1, self._uu1, self._ww1
        nb, n = syms.shape[0], self.n
        s_tot = r1 * k

        bv = torch.full((nb, w_band, n), INF, device=self.device)
        for i, d_i in enumerate(offsets):
            bv[:, d_i - min_d] = dv1[syms[:, 0], i]
        acc_u = torch.full((nb, s_tot, n), INF, device=self.device)
        acc_w = torch.full((nb, s_tot, n), INF, device=self.device)
        if r1:
            acc_u[:, :r1] = uu1[syms[:, 0]]
            acc_w[:, :r1] = ww1[syms[:, 0]]

        for t in range(1, k):
            o_t = syms[:, t]
            a_dv = dv1[o_t]  # [nb, m, N]
            a_u = uu1[o_t]  # [nb, R1, N]
            a_w = ww1[o_t]
            # Band(A) ⊗ Band(B): offset d_i lands at slot j + (d_i − min_d)
            new_bv = torch.full_like(bv, INF)
            for i, d_i in enumerate(offsets):
                term = a_dv[:, i, None, :] + _shift(_shift(bv, d_i - min_d, dim=1), d_i)
                new_bv = torch.minimum(new_bv, term)
            # inherited slots: Diag(a) ⊗ Rank1(b)  ∪  Rank1(a) ⊗ Rank1(b)
            new_u = torch.full_like(acc_u, INF)
            for i, d_i in enumerate(offsets):
                new_u = torch.minimum(new_u, a_dv[:, i, None, :] + _shift(acc_u, d_i))
            if r1:
                new_u = torch.minimum(new_u, _dots_then_cross(acc_u, a_w, a_u))
                # new slots at block t: Rank1(a) ⊗ Band(b, offsets t·min_d+j)
                y = a_w[:, :, None, :] + bv[:, None, :, :]  # [nb, R1, W, N]
                z = y[:, :, 0, :]
                for j in range(1, w_band):
                    z = torch.minimum(z, _shift(y[:, :, j, :], -j))
                new_u[:, t * r1 : (t + 1) * r1] = a_u
                acc_w[:, t * r1 : (t + 1) * r1] = _shift(z, -(t * min_d))
            bv, acc_u = new_bv, new_u
        return bv, acc_u, acc_w

    def _compose_tree(self, syms: torch.Tensor):
        """Pairwise merges C = A ⊗ B (A later in time) of two t-operator
        composites, log2(k) levels; the same output layout as
        :meth:`_compose_scan`.

        - band: offset sums, ``new_bv[i+j] = A_bv[i] + shift(B_bv[j],
          t·min_d + i)`` min-merged; width 2W−1.
        - B's slots keep their w; their u min-merges A's band applied to
          it with the cross term ``min_a (u_a + dot(w_a, U_s))``.
        - A's slots keep their u; their w composes through B's band
          (``min_j shift(w_a + B_bv[j], −(t·min_d+j))``).
        """
        k, r1 = self.k, self.r1
        min_d, span = self.min_d, self.span
        dv1, uu1, ww1 = self._dv1, self._uu1, self._ww1
        nb, n = syms.shape[0], self.n

        flat = syms.reshape(nb * k)
        bv = torch.full((nb * k, span + 1, n), INF, device=self.device)
        for i, d_i in enumerate(self.offsets):
            bv[:, d_i - min_d] = dv1[flat, i]
        uu = uu1[flat]  # [L, R1, N]
        ww = ww1[flat]

        t = 1
        while t < k:
            a_bv, b_bv = bv[1::2], bv[0::2]  # A later, B earlier
            a_u, b_u = uu[1::2], uu[0::2]
            a_w, b_w = ww[1::2], ww[0::2]
            w_band = bv.shape[1]  # t·span + 1

            new_bv = torch.full((a_bv.shape[0], 2 * w_band - 1, n), INF, device=self.device)
            for i in range(w_band):
                term = a_bv[:, i, None, :] + _shift(b_bv, t * min_d + i)
                new_bv[:, i : i + w_band] = torch.minimum(new_bv[:, i : i + w_band], term)

            if r1:
                u_inh = _dots_then_cross(b_u, a_w, a_u)
                for i in range(w_band):
                    u_inh = torch.minimum(u_inh, a_bv[:, i, None, :] + _shift(b_u, t * min_d + i))
                y = a_w[:, :, None, :] + b_bv[:, None, :, :]  # [L/2, S_A, W, N]
                w_new = _shift(y[:, :, 0, :], -(t * min_d))
                for j in range(1, w_band):
                    w_new = torch.minimum(w_new, _shift(y[:, :, j, :], -(t * min_d + j)))
                uu = torch.cat([u_inh, a_u], dim=1)
                ww = torch.cat([b_w, w_new], dim=1)
            else:  # purely banded: keep the (empty) slot axis paired up
                uu, ww = a_u, a_w
            bv = new_bv
            t *= 2

        assert bv.shape[1] == self.w_band
        return bv, uu, ww

    # ---- phase 2: sequential fold over block operators ------------------

    def _fold(self, v: torch.Tensor, bv: torch.Tensor, acc_u: torch.Tensor, acc_w: torch.Tensor):
        """Apply the nb block operators in order → (v_final [N], frontiers
        [nb, N]), ``frontiers[b]`` the carry BEFORE block ``b``. The rank-1
        part of a block is two J = 1 ``minplus`` launches: the slots' dots
        against ``v``, then ``u`` (read transposed) against the dots."""
        base = self.k * self.min_d  # band slot j = offset base + j
        fronts = v.new_empty((bv.shape[0], self.n))
        for b in range(bv.shape[0]):
            fronts[b] = v
            diag = bv[b, 0] + _shift(v, base)
            for j in range(1, self.w_band):
                diag = torch.minimum(diag, bv[b, j] + _shift(v, base + j))
            if acc_u.shape[1]:  # purely banded operators carry no rank-1 slots
                dots = tropical.minplus(acc_w[b : b + 1], v[None, :, None])  # [1, S, 1]
                cand = tropical.minplus(acc_u[b : b + 1].transpose(1, 2), dots)  # [1, N, 1]
                diag = torch.minimum(diag, cand[0, :, 0])
            v = diag
        return v, fronts

    # ---- phase 3: the serial tail ---------------------------------------

    def _tail(self, v: torch.Tensor, syms) -> torch.Tensor:
        """The leftover symbols, one plain structured step each."""
        carry = v[:, None]
        for o in syms:
            carry = self._em_t[:, int(o), None] + structured_mv_batch(self.sop, self._arrs, carry)
        return carry[:, 0]

    # ---- public API -----------------------------------------------------

    def plan(self, t: int) -> tuple[int, int]:
        """(full blocks, tail steps) for a T-symbol sequence."""
        nb = (t - 1) // self.k
        return nb, (t - 1) - nb * self.k

    def decode(self, seq: np.ndarray) -> np.ndarray:
        """Final score vector; time-parallel compose + fold + serial tail."""
        v, _, _, _, _ = self._decode_parts(seq)
        return v[: self.states_num].cpu().numpy()

    def _decode_parts(self, seq: np.ndarray):
        """(v [N], frontiers [nb, N] or None, the carry after the blocks,
        nb, tail) on the device."""
        seq = validate_obs_seq(seq, self.emit_num)
        if not len(seq):
            raise ValueError("cannot decode an empty sequence")
        nb, tail = self.plan(len(seq))
        v = self._em_t[:, int(seq[0])] + self._pi
        frontiers = None
        if nb:
            syms = torch.as_tensor(seq[1 : 1 + nb * self.k].astype(np.int64), device=self.device)
            v, frontiers = self._fold(v, *self._compose_blocks(syms.reshape(nb, self.k)))
        v_blocks = v  # carry after all full blocks, before the tail
        if tail:
            v = self._tail(v, seq[1 + nb * self.k :].tolist())
        return v, frontiers, v_blocks, nb, tail

    def decode_path(self, seq: np.ndarray, engine=None) -> tuple[np.ndarray, np.ndarray]:
        """(scores, path): exact per-step rules rematerialized per block.

        ``engine``: a :class:`~spec_viterbi_tpu_torch.ops.fused.FusedStructuredDecoder`
        for this operator on this decoder's device. With it (and int16
        pointers, ``n ≤ INT16_STATES``) every block's pointers come from
        ONE launch of its path kernel from the kept frontiers (lane b =
        block b, unmasked), the tail's from one 1-lane launch from the
        carry after the blocks, and the walk is one ``svt_backtrace``
        launch. Without it, the plain argmin scan (int32 pointers) and the
        plain walk.
        """
        seq = validate_obs_seq(seq, self.emit_num)
        v, frontiers, v_blocks, nb, tail = self._decode_parts(seq)
        kernels = engine is not None and self.n <= fused.INT16_STATES
        if kernels and engine.em.device != v.device:
            raise ValueError(f"the engine runs on {engine.em.device}, this decoder on {v.device}")

        def pointers(v0: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
            """src [steps, lanes, N] of the serial rules from ``v0`` [N, lanes]."""
            if kernels:
                return fused.path(engine._path_arm, engine.em, v0, obs, None)[1]
            return structured_path_batch(self.sop, self._arrs, self._em_t, v0, obs, None, torch.int32)[1]

        seq_d = torch.as_tensor(seq, device=self.device)
        pieces = []
        if nb:
            obs = seq_d[1 : 1 + nb * self.k].reshape(nb, self.k).T.contiguous()  # [k, nb]
            src = pointers(frontiers.T.contiguous(), obs)  # [k, nb, N]
            # time order: step j of block b is global step b·k + j
            pieces.append(src.transpose(0, 1).reshape(nb * self.k, 1, self.n))
        if tail:
            pieces.append(pointers(v_blocks[:, None].contiguous(), seq_d[1 + nb * self.k :, None].contiguous()))
        last = torch.argmin(v).to(torch.int32)[None]  # first index on ties
        if pieces:
            src_all = torch.cat(pieces).contiguous()  # [T-1, 1, N]
            walk = fused.backtrace if kernels else fused.backtrace_plain
            path = torch.cat([walk(src_all, last)[:, 0], last])
        else:
            path = last
        return v[: self.states_num].cpu().numpy(), path.cpu().numpy().astype(np.int32)
