"""HMM specialization: precomputed (min,+) operators, level-L tuple operators.

The port of ``spec_viterbi_tpu/models/specializer.py``. API parity target:
``Viterbi_spec_impl``: ``spec_with(hmm)`` (re-specializable),
``run_Viterbi_spec(seq)`` (here ``run_spec``), ``get_level()``.

Level-1 specialization precomputes, per observation symbol ``o``:

- ``start_ops[o] = diag(emit_o) ⊗ π``   (n-vector)
- ``ops[o]       = diag(emit_o) ⊗ Aᵀ``  (n×n matrix)

In log space the diagonal product is a row-wise add, so the whole level-1
stack is one broadcast, ``emissions[:, :, None] + Aᵀ[None]``, with the
tropical identity appended at index ``E`` as a padding symbol.

Level L > 1 collapses L consecutive steps into one operator per
observation L-tuple: a dense ``[(E+1)^L, n, n]`` stack indexed by the
radix-``E+1`` encoding of the tuple (earliest symbol the least significant
digit), built by one (min,+) product launch per new symbol and level:

    T_l[p + i·P] = ops[i] ⊗ T_{l-1}[p]

Decode consumes ``seq[1:]`` in chunks of ``level``, one matvec a chunk,
and finishes the remainder with level-1 operators. On ``cuda`` every
product goes through the hand-written kernel ``svt_minplus``
(:mod:`spec_viterbi_tpu_torch.ops.tropical`); the batched decode reads
each lane's tuple operator in place, through the kernel's index vector.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder, resolve_device
from spec_viterbi_tpu_torch.ops import dispatch, tropical
from spec_viterbi_tpu_torch.utils.batching import quantize_t
from spec_viterbi_tpu_torch.utils.cache import OperatorCache


def _build_level1(a_t: torch.Tensor, pi: torch.Tensor, em: torch.Tensor):
    """``(start_ops [E, n], ops [E+1, n, n])``: the level-1 stack with a
    trailing identity operator (0 on the diagonal, +inf elsewhere) at index
    ``E``. Applying it leaves the carry unchanged, so ragged sequences pad
    to a common length with it; the tuple radix is ``E+1``."""
    e, n = em.shape
    start_ops = em + pi[None, :]
    ops = torch.empty((e + 1, n, n), dtype=a_t.dtype, device=a_t.device)
    torch.add(em[:, :, None], a_t[None, :, :], out=ops[:e])
    ops[e].fill_(float("inf")).fill_diagonal_(0.0)
    return start_ops, ops


def _add_level(ops: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
    """``ops ⊗ t_prev``: [E, n, n] ⊗ [P, n, n] → [E·P, n, n]; output index
    ``p + i·P`` applies the new symbol ``i`` last in time. One product a
    new symbol (G = P, the shared ``ops[i]`` read row-major: the JAX
    package's ``ops_t`` transpose is a stride here)."""
    e, p = ops.shape[0], t_prev.shape[0]
    t_next = torch.empty((e * p, *t_prev.shape[1:]), dtype=t_prev.dtype, device=t_prev.device)
    for i in range(e):
        tropical.minplus(ops[i][None], t_prev, out=t_next[i * p : (i + 1) * p])
    return t_next


def make_chunked_decode(level: int, emit_num: int, start_fn, chunk_fn, tail_fn, operands=None):
    """The chunked-decode skeleton: ``seq[0]`` takes the start operator;
    the remaining T−1 symbols go ``level`` at a time through
    ``chunk_fn(v, tuple_index, operands)`` (the radix-``emit_num`` encoding,
    earliest symbol least significant); the final ``(T−1) mod level``
    symbols go through ``tail_fn(v, symbol, operands)``. ``seq`` is a
    validated host array: the indices are formed on the host, so the loop
    never waits on the device."""

    def decode(seq: np.ndarray):
        v = start_fn(int(seq[0]), operands)
        rest = np.asarray(seq[1:], dtype=np.int64)
        n_full = len(rest) // level
        if n_full:
            chunks = rest[: n_full * level].reshape(n_full, level)
            for i in (chunks @ emit_num ** np.arange(level, dtype=np.int64)).tolist():
                v = chunk_fn(v, i, operands)
        for o in rest[n_full * level :].tolist():
            v = tail_fn(v, o, operands)
        return v

    return decode


class SpecializedViterbi:
    """Re-specializable specialized decoder (``Viterbi_spec_impl`` parity).

    ``level`` is the number of observation handlers combined into one
    operator. The tuple operators take ``(emit_num+1)^level · n² · 4``
    bytes (:meth:`spec_memory_bytes`; the +1 is the identity padding
    symbol). At level 1 a structured-eligible model decodes through
    :class:`ViterbiDecoder` (the fused kernels on ``cuda``), which needs no
    dense stack; ``use_kernels=False`` pins that delegate's plain loop.
    ``cache`` persists the dense stacks (:class:`OperatorCache`).
    ``device`` is required: ``"cpu"`` or ``"cuda[:i]"``.
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
        self.start_ops = None  # [E, n]
        self.ops = None  # [E+1, n, n]
        self.tuple_ops = None  # [(E+1)^level, n, n]
        self.states_num = 0
        self.emit_num = 0
        self._delegate = None

    def get_level(self) -> int:
        return self.level

    @staticmethod
    def spec_memory_bytes(states_num: int, emit_num: int, level: int) -> int:
        # +1: the identity padding symbol joins the tuple radix
        np_states = pad_to_lane(states_num)
        return ((emit_num + 1) ** level) * np_states * np_states * 4

    @staticmethod
    def predicted_dense_decode_slowdown(states_num: int, level: int) -> float:
        """The byte ratio of a batched level-L decode here against a
        factored (structured) specializer at the same level: each lane's
        chunk step reads a dense ``[n, n]`` operator here and ``6·level +
        2`` component ``[n]`` vectors there, so the model is ``n / (6·level
        + 2)``. An unmeasured model (the port has no factored specializer
        to time it against); 1.0 at level 1."""
        if level <= 1:
            return 1.0
        return pad_to_lane(states_num) / (6 * level + 2)

    def spec_with(self, hmm: HMM) -> None:
        """(Re)build all specialized operators for ``hmm``; the previous
        ones are dropped first."""
        self._specialized = False
        self.start_ops = self.ops = self.tuple_ops = None
        self.states_num = hmm.states_num
        self.emit_num = hmm.emit_num

        slowdown = self.predicted_dense_decode_slowdown(hmm.states_num, self.level)
        if slowdown >= 10.0:
            warnings.warn(
                f"dense level-{self.level} specialization at {hmm.states_num} states: "
                "batched decode reads a dense [n, n] operator per lane and chunk, "
                f"~{slowdown:.0f}x the bytes of a factored specializer by an unmeasured "
                "byte-ratio model. For large models prefer SpecializedViterbi(level=1) "
                "or ViterbiDecoder, which decode structured models through the fused "
                "kernels, unless you need the dense path for cross-validation.",
                stacklevel=2,
            )

        np_states = pad_to_lane(hmm.states_num)
        self._delegate = None
        if self.level == 1:
            if self._use_kernels is False:
                dec = ViterbiDecoder(hmm, use_kernels=False, mode="structured", device=self.device)
            else:
                dec = ViterbiDecoder(hmm, mode="auto", device=self.device)
            if dec.mode == "structured":
                self._delegate = dec
                self._specialized = True
                return

        cached = None
        if self.cache is not None:
            cached = self.cache.load(hmm.fingerprint(), self.level, np_states, kind="dense")
        # entries without "ops_id" predate the identity padding symbol
        if cached is not None and "ops_id" in cached:
            start_ops = self._upload(cached["start_ops"])
            ops = self._upload(cached["ops_id"])
            # level 1's tuple_ops are the level-1 ops (not stored twice)
            tuple_ops = self._upload(cached["tuple_ops"]) if "tuple_ops" in cached else ops
        else:
            a_t = torch.as_tensor(hmm.transposed_transition_matrix(pad_to=np_states), device=self.device)
            pi = torch.as_tensor(hmm.start_vector(pad_to=np_states), device=self.device)
            em = torch.as_tensor(hmm.emission_matrix(pad_to=np_states), device=self.device)
            start_ops, ops = _build_level1(a_t, pi, em)
            tuple_ops = ops
            for _ in range(self.level - 1):
                tuple_ops = _add_level(ops, tuple_ops)
            if self.cache is not None:
                arrays = {"start_ops": start_ops.cpu().numpy(), "ops_id": ops.cpu().numpy()}
                if self.level > 1:
                    arrays["tuple_ops"] = tuple_ops.cpu().numpy()
                self.cache.store(hmm.fingerprint(), self.level, np_states, arrays, kind="dense")

        self.start_ops, self.ops, self.tuple_ops = start_ops, ops, tuple_ops
        self._decode = make_chunked_decode(
            self.level,
            self.emit_num + 1,  # the identity padding symbol joins the radix
            start_fn=lambda o, ops3: ops3[0][o],
            chunk_fn=lambda v, i, ops3: dispatch.step_mv(ops3[2][i], v),
            tail_fn=lambda v, o, ops3: dispatch.step_mv(ops3[1][o], v),
            operands=(start_ops, ops, tuple_ops),
        )
        self._specialized = True

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        # a cache load is a read-only memmap: copy it before torch sees it
        return torch.from_numpy(np.array(arr)).to(self.device)

    def _decode_batch_uniform(self, batch: np.ndarray) -> torch.Tensor:
        """The batched chunked decode of ``batch`` [B, T] (one length, padded
        with the identity symbol) → [B, n] on the device. The carry is
        lane-major, and each chunk step is one gathered product: lane ``b``
        applies ``tuple_ops[idx[b]]``, read in place through the kernel's
        index vector (no [B, n, n] gather)."""
        level, radix = self.level, self.emit_num + 1
        dev = self.start_ops.device
        v = self.start_ops[torch.as_tensor(batch[:, 0].astype(np.int64), device=dev)]  # [B, n]
        rest = batch[:, 1:].astype(np.int64)
        n_full = rest.shape[1] // level
        steps = []
        if n_full:
            chunks = rest[:, : n_full * level].reshape(len(batch), n_full, level)
            idxs = chunks @ radix ** np.arange(level, dtype=np.int64)  # [B, n_full]
            steps.append((self.tuple_ops, idxs))
        steps.append((self.ops, rest[:, n_full * level :]))
        for ops, idxs in steps:
            idxs_d = torch.as_tensor(np.ascontiguousarray(idxs.T), device=dev)  # [steps, B]
            for c in range(idxs_d.shape[0]):
                v = tropical.minplus(ops, v[:, :, None], a_idx=idxs_d[c])[:, :, 0]
        return v

    def run_spec(self, seq: np.ndarray) -> np.ndarray:
        """``run_Viterbi_spec`` parity: final score vector for one sequence."""
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec(seq)")
        if self._delegate is not None:
            return self._delegate.decode(seq)
        seq = validate_obs_seq(seq, self.emit_num)
        if len(seq) == 0:
            raise ValueError("cannot decode an empty sequence")
        return self._decode(seq)[: self.states_num].cpu().numpy()

    def run_spec_batch(self, seqs: list[np.ndarray]) -> list[np.ndarray]:
        """Batched specialized decode (the DP extension of ``run_spec``).

        Level 1 on a structured model rides the delegate's batched decode;
        otherwise the batched chunked decode runs once per group of
        sequences whose lengths quantize alike (``quantize_t``), each padded
        to the group's length with the identity symbol, as the JAX package
        does. At level 2 that is exact (a lane equals its ``run_spec``);
        from level 3 on, a tail of two or more symbols then goes through
        one tuple operator instead of one level-1 product each, which
        rounds differently (within ``almost_equal_vec``).
        """
        if not self._specialized:
            raise RuntimeError("call spec_with(hmm) before run_spec_batch")
        if self._delegate is not None:
            return self._delegate.decode_batch(seqs)
        if not seqs:
            return []
        seqs = [validate_obs_seq(s, self.emit_num) for s in seqs]
        if any(len(s) == 0 for s in seqs):
            raise ValueError("cannot decode an empty sequence")
        out: list[np.ndarray | None] = [None] * len(seqs)
        by_tq: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            by_tq.setdefault(quantize_t(len(s)), []).append(i)
        for t_q, idxs in sorted(by_tq.items()):
            batch = np.full((len(idxs), t_q), self.emit_num, np.int32)
            for j, i in enumerate(idxs):
                batch[j, : len(seqs[i])] = seqs[i]
            v = self._decode_batch_uniform(batch)[:, : self.states_num].cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = v[j]
        return out
