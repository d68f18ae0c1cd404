"""Level-L specialization with structured (diagonal + rank-1) tuple operators.

The port of ``spec_viterbi_tpu/models/spec_structured.py``. Same API as
:class:`~spec_viterbi_tpu_torch.models.specializer.SpecializedViterbi`
(``spec_with`` / ``run_spec`` / ``run_spec_batch`` / ``get_level``), but
the tuple operators are stored as O(N) component vectors through the
tropical closure of
:mod:`spec_viterbi_tpu_torch.ops.structured_compose`: level-L memory is
``E^L · components · N`` floats instead of the dense ``E^L · N²``.

Decode consumes ``seq[1:]`` in chunks of ``level`` through the composed
components (a gather of a few [N] vectors a chunk instead of one dense
[N, N] matrix), and the remainder through the level-1 components
(``GraphBLAS_spec_impl.cpp:64-89``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi_tpu_torch.models.decoder import resolve_device
from spec_viterbi_tpu_torch.models.specializer import make_chunked_decode, to_device
from spec_viterbi_tpu_torch.ops import fused
from spec_viterbi_tpu_torch.ops import structured_compose as sc
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.utils.cache import OperatorCache


def _apply(offsets, dvals, u, w, v):
    """One component list on one carry: ``dvals`` [D, N], ``u``/``w``
    [R, N], ``v`` [N] → [N]. Diagonal candidates through a cyclic shift
    (the wrapped rows hold +inf), then the rank-1 terms
    ``min_r(u_r + min_n(w_r + v))``."""
    out = torch.full_like(v, float("inf"))
    for k, d in enumerate(offsets):
        out = torch.minimum(out, dvals[k] + torch.roll(v, d))
    if u.shape[0]:
        dots = torch.amin(w + v[None, :], dim=1)  # [R]
        out = torch.minimum(out, torch.amin(u + dots[:, None], dim=0))
    return out


def _apply_batch(offsets, dvb, uub, wwb, v):
    """:func:`_apply` a lane: each lane's gathered components ``dvb``
    [B, D, N], ``uub``/``wwb`` [B, R, N] on the lane-major carry ``v``
    [B, N] → [B, N]."""
    out = torch.full_like(v, float("inf"))
    for k, d in enumerate(offsets):
        out = torch.minimum(out, dvb[:, k, :] + torch.roll(v, d, dims=1))
    if uub.shape[1]:
        dots = torch.amin(wwb + v[:, None, :], dim=2)  # [B, R]
        out = torch.minimum(out, torch.amin(uub + dots[:, :, None], dim=1))
    return out


class StructuredSpecializedViterbi:
    """Re-specializable level-L decoder over structured tuple operators.

    Two decode forms, which cross-validate:

    - **factored** (``cuda``, a fused-eligible operator, ``use_kernels``
      not False): the level-1 structured operator applied ``level``
      symbols at a time inside the whole-sequence kernels of
      :class:`~spec_viterbi_tpu_torch.ops.fused.FusedStructuredDecoder`
      (``svt_scores_fs`` for uniform batches, the masked kernel for ragged
      ones). Sequential application is the composed operator, so this form
      is bit-equal to the non-specialized decode and never reads the
      level-L stacks.
    - **composed** (every other case: the CPU, ``use_kernels=False``, an
      operator outside the fused class): the stored level-L component
      vectors gathered by tuple index and applied in plain PyTorch, the
      direct materialization of ``precalc_obs_handlers.at(tuple) ⊗ v``
      (``GraphBLAS_spec_impl.cpp:64-81``). Bit-equal to the JAX package's
      composed form; within ``almost_equal_vec`` of the oracle.

    ``cache`` persists the composed stacks (``kind="struct"``), written in
    the background. ``device`` is required: ``"cpu"`` or ``"cuda[:i]"``.
    """

    def __init__(
        self,
        level: int = 1,
        use_kernels: bool | None = None,
        cache: OperatorCache | None = None,
        *,
        device: torch.device | str,
    ):
        if level < 1:
            raise ValueError("level must be >= 1")
        self.level = level
        self.cache = cache
        self.device = resolve_device(device)
        self._use_kernels = use_kernels
        self._specialized = False
        self._fused = None
        self._store_thread: threading.Thread | None = None

    def get_level(self) -> int:
        return self.level

    @staticmethod
    def spec_memory_bytes(states_num: int, emit_num: int, level: int) -> int:
        """Upper-bound estimate: E^L tuples × component vectors × N floats.

        The slot-structured composition grows the rank-1 slot count
        linearly a level (R' = R_b + R_a·D_a), so the estimate is
        ``6·level + 2`` vectors a tuple."""
        vectors = 6 * level + 2
        return (emit_num**level) * vectors * pad_to_lane(states_num) * 4

    def spec_with(self, hmm: HMM) -> None:
        """(Re)build the operators for ``hmm``; the previous ones are
        dropped first."""
        self._specialized = False
        self._fused = None
        n = pad_to_lane(hmm.states_num)
        self.n = n
        self.states_num = hmm.states_num
        self.emit_num = hmm.emit_num

        sop = StructuredOperator.from_hmm(hmm, pad_to=n)
        em = hmm.emission_matrix(pad_to=n)
        pi = hmm.start_vector(pad_to=n)

        cached = None
        if self.cache is not None:
            cached = self.cache.load(hmm.fingerprint(), self.level, n, kind="struct")
        if cached is not None and "l1_offsets" not in cached:
            cached = None  # a foreign or old schema under this key: rebuild
        if cached is not None:
            l1_offsets = tuple(int(d) for d in cached["l1_offsets"])
            all_offsets = tuple(int(d) for d in cached["tuple_offsets"])
            dv1, uu1, ww1 = cached["dv1"], cached["uu1"], cached["ww1"]
            dv, uu, ww = cached["dv"], cached["uu"], cached["ww"]
        else:
            (l1_offsets, dv1, uu1, ww1), (all_offsets, dv, uu, ww) = sc.batched_levels(
                sop, em, self.level
            )
            if self.cache is not None:
                self._store_thread = self.cache.store_async(
                    hmm.fingerprint(),
                    self.level,
                    n,
                    {
                        "l1_offsets": np.asarray(l1_offsets, np.int64),
                        "tuple_offsets": np.asarray(all_offsets, np.int64),
                        "dv1": dv1, "uu1": uu1, "ww1": ww1,
                        "dv": dv, "uu": uu, "ww": ww,
                    },
                    kind="struct",
                )

        self.tuple_offsets = tuple(all_offsets)
        self.l1_offsets = tuple(l1_offsets)
        self.num_components = int(dv.shape[1] + uu.shape[1])
        # the upload is lazy: cache loads are memory-mapped, and the
        # factored form never reads the level-L stacks
        self._arrays_host = (dv, uu, ww, dv1, uu1, ww1)
        self._arrays_dev = None
        self.start_ops = torch.as_tensor(em + pi[None, :], device=self.device)  # [E, N]
        self._decode = make_chunked_decode(
            self.level,
            self.emit_num,
            start_fn=lambda o, _: self.start_ops[o],
            chunk_fn=lambda v, i, _: self._apply_tuple(v, i),
            tail_fn=lambda v, o, _: self._apply_symbol(v, o),
        )
        if (
            self._use_kernels is not False
            and self.device.type == "cuda"
            and fused.fused_eligible(sop)
        ):
            self._fused = fused.FusedStructuredDecoder(sop, em, pi, device=self.device)
        self._specialized = True

    @property
    def arrays(self) -> tuple[torch.Tensor, ...]:
        """(dv, uu, ww, dv1, uu1, ww1) on the device, uploaded on first use."""
        if self._arrays_dev is None:
            self._arrays_dev = tuple(to_device(a, self.device) for a in self._arrays_host)
        return self._arrays_dev

    def _apply_tuple(self, v, i: int):
        dv, uu, ww = self.arrays[:3]
        return _apply(self.tuple_offsets, dv[i], uu[i], ww[i], v)

    def _apply_symbol(self, v, o: int):
        dv1, uu1, ww1 = self.arrays[3:]
        return _apply(self.l1_offsets, dv1[o], uu1[o], ww1[o], v)

    def _decode_batch_uniform(self, seqs_t: torch.Tensor) -> torch.Tensor:
        """The composed decode of one uniform-length batch: ``seqs_t``
        [T, B] symbols on the device → [B, N] scores on the device.

        Each chunk's tuple index is per lane ([B], formed on the device);
        the chunk applies each lane's gathered components, with the same
        positional chunk/tail split as :meth:`run_spec`. The loop issues
        a few PyTorch calls a chunk and never waits on the device."""
        dv, uu, ww, dv1, uu1, ww1 = self.arrays
        seqs_t = seqs_t.long()
        v = self.start_ops[seqs_t[0]]  # [B, N]
        rest = seqs_t[1:]
        n_full = rest.shape[0] // self.level
        if n_full:
            chunks = rest[: n_full * self.level].reshape(n_full, self.level, -1)
            radix = self.emit_num ** torch.arange(self.level, device=rest.device)
            idxs = (chunks * radix[None, :, None]).sum(dim=1)  # [n_full, B]
            for i in idxs:
                v = _apply_batch(self.tuple_offsets, dv[i], uu[i], ww[i], v)
        for o in rest[n_full * self.level :]:
            v = _apply_batch(self.l1_offsets, dv1[o], uu1[o], ww1[o], v)
        return v

    def run_spec(self, seq: np.ndarray) -> np.ndarray:
        """Final score vector of one sequence."""
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec(seq)")
        if self._fused is not None:
            return self._fused.decode_batch([np.asarray(seq)])[0]
        seq = validate_obs_seq(seq, self.emit_num)
        if len(seq) == 0:
            raise ValueError("cannot decode an empty sequence")
        return self._decode(seq)[: self.states_num].cpu().numpy()

    def run_spec_batch(self, seqs: list[np.ndarray]) -> list[np.ndarray]:
        """Batched specialized decode.

        In factored form the whole batch rides the fused decoder (ragged
        batches bucketed and masked). The composed form needs positionally
        aligned chunk and tail boundaries, and its radix (``emit_num``) has
        no identity symbol to pad with, so it buckets lanes by exact
        length and decodes each bucket as one batch."""
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec_batch")
        if not seqs:
            return []
        if self._fused is not None:
            return self._fused.decode_batch(seqs)
        seqs = [validate_obs_seq(s, self.emit_num) for s in seqs]
        if any(len(s) == 0 for s in seqs):
            raise ValueError("cannot decode an empty sequence")
        by_len: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            by_len.setdefault(len(s), []).append(i)
        outs = []
        for _, idxs in sorted(by_len.items()):
            batch = torch.as_tensor(np.stack([seqs[i] for i in idxs], axis=1), device=self.device)
            outs.append((idxs, self._decode_batch_uniform(batch)[:, : self.states_num]))
        out: list[np.ndarray | None] = [None] * len(seqs)
        for idxs, v in outs:
            v = v.cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = v[j]
        return out
