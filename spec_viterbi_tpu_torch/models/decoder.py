"""Non-specialized Viterbi decoding: dense and structured modes.

The port of ``spec_viterbi_tpu/models/decoder.py``. API parity target:
``run_Viterbi(hmm, seq) -> Mod_prob_vec_t``, the final per-state −log2
score vector; ``decode_path``/``decode_path_batch`` add the exact Viterbi
path and ``streaming()`` the stream engines.

Dense mode is a loop over steps with one launch each: the hand-written
kernel ``svt_minplus`` with the emission add and the length mask in its
epilogue (:func:`~spec_viterbi_tpu_torch.ops.tropical.dense_step` and
``dense_step_mv``) on ``cuda``, their plain versions on ``cpu``, between
two carries allocated once a call. Structured mode
decodes through the diagonal/row/col-decomposed operator: on a CUDA
device, fused-eligible operators decode batches through the hand-written
kernels of :mod:`spec_viterbi_tpu_torch.ops.fused`; otherwise (a CPU
device, ``use_kernels=False``, or an operator too irregular for the
kernels) the plain structured loop runs, the counterpart of the JAX
package's XLA structured path.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi_tpu_torch.models.streaming_xla import PlainStreamDecoder
from spec_viterbi_tpu_torch.ops import fused, tropical
from spec_viterbi_tpu_torch.ops.structured import (
    StructuredOperator,
    structured_path_batch,
    structured_scores_batch,
)
from spec_viterbi_tpu_torch.utils.batching import bucket_plan, pad_batch
from spec_viterbi_tpu_torch.utils.profiling import span

# lane multiple and bucket block of the plain paths, as in the JAX package
SUBLANE = 8


def resolve_device(device: torch.device | str) -> torch.device:
    """An explicit ``cpu`` or ``cuda`` device; a CUDA device needs a card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use 'cpu' or 'cuda'")
    return device


@dataclasses.dataclass(frozen=True)
class DeviceHMM:
    """An HMM as dense, lane-padded tensors on one device.

    ``a_t`` is the transposed transition operator the matvec recurrence
    multiplies by, ``a`` the untransposed matrix the batched step reads
    (through its transposed view; on an H100 that view's step is 1-4%
    faster than the same product on ``a_t`` at 56 and 512 lanes,
    ``probes/minplus.py``). Padding states carry +inf everywhere,
    so they stay at the semiring zero through any number of steps and are
    sliced off on extraction. ``dense=False`` leaves both out (structured
    mode reads only the emissions and π). ``finite`` counts the finite
    entries of the dense operator (0 without it); ``blocks`` is the block
    list of the batched step's view
    (:func:`~spec_viterbi_tpu_torch.ops.tropical.block_list`; None where
    no block is all +inf), which that step hands ``svt_minplus``.
    """

    a_t: torch.Tensor | None  # [n, n]
    a: torch.Tensor | None  # [n, n]
    pi: torch.Tensor  # [n]
    emissions: torch.Tensor  # [E, n]
    states_num: int
    padded: int
    finite: int = 0
    blocks: tropical.BlockList | None = None

    @classmethod
    def from_hmm(cls, hmm: HMM, dense: bool = True, *, device: torch.device | str) -> "DeviceHMM":
        device = resolve_device(device)
        n = pad_to_lane(hmm.states_num)
        a_t = a = None
        finite, blocks = 0, None
        if dense:
            mat = hmm.transition_matrix(pad_to=n)
            a_t = torch.as_tensor(mat.T.copy(), device=device)
            a = torch.as_tensor(mat, device=device)
            held = np.isfinite(mat)
            finite = int(np.count_nonzero(held))
            blocks = tropical.block_list(held.T, device)  # A[i, k] = mat[k, i]
        return cls(
            a_t=a_t,
            a=a,
            pi=torch.as_tensor(hmm.start_vector(pad_to=n), device=device),
            emissions=torch.as_tensor(hmm.emission_matrix(pad_to=n), device=device),
            states_num=hmm.states_num,
            padded=n,
            finite=finite,
            blocks=blocks,
        )


def _stream_of(device: torch.device):
    """The device context and the current stream's handle, taken once a
    call: ``(context, handle)``; the CPU has neither."""
    if device.type != "cuda":
        return contextlib.nullcontext(), None
    return torch.cuda.device(device), torch.cuda.current_stream(device).cuda_stream


def _decode_scores(a_t, pi, em, seq: np.ndarray) -> torch.Tensor:
    """Dense scores of one validated sequence: ``v ← em[o] + a_t ⊗ v``,
    one launch a step (the add in the kernel's epilogue) into a ping-pong
    pair of carries allocated once."""
    em_t = em.T
    ctx, stream = _stream_of(a_t.device)
    with ctx:
        bufs = [em[int(seq[0])] + pi, torch.empty_like(pi)]
        for t, o in enumerate(seq[1:].tolist()):
            tropical.dense_step_mv(a_t, bufs[t % 2], em_t, o, bufs[(t + 1) % 2], stream=stream)
    return bufs[(len(seq) - 1) % 2]


def _decode_scores_and_path(a_t, pi, em, seq: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense scores and the Viterbi path of one validated sequence: int32
    pointers ``[T-1, 1, n]`` on the device (the lowest source wins a tie),
    each step's written in place by its launch, walked back by
    ``backtrace_plain``."""
    em_t = em.T
    ctx, stream = _stream_of(a_t.device)
    with ctx:
        bufs = [em[int(seq[0])] + pi, torch.empty_like(pi)]
        src = torch.empty((len(seq) - 1, 1, a_t.shape[0]), dtype=torch.int32, device=pi.device)
        for t, o in enumerate(seq[1:].tolist()):
            tropical.dense_step_mv(a_t, bufs[t % 2], em_t, o, bufs[(t + 1) % 2], src[t, 0],
                                   stream=stream)
    v = bufs[(len(seq) - 1) % 2]
    last = torch.argmin(v).to(torch.int32)[None]
    rev = fused.backtrace_plain(src, last)  # [T-1, 1]
    return v, torch.cat([rev[:, 0], last])


def _decode_scores_batch(a, pi, em, seqs_t: torch.Tensor, lengths: torch.Tensor,
                         blocks: tropical.BlockList | None = None) -> torch.Tensor:
    """seqs_t: [T, B] int32 (padded), lengths: [B] int32. Returns [B, n].

    The carry is state-major ([n, B]), so each step is one TN product that
    reads the transition operator once for the whole batch; a lane freezes
    once ``t`` reaches its length. A step is one launch
    (:func:`~spec_viterbi_tpu_torch.ops.tropical.dense_step`: the emission
    add and the mask in the kernel's epilogue) from one carry of a
    ping-pong pair, allocated once, into the other. ``blocks``, the
    operator's block list (``DeviceHMM.blocks``), has each launch read
    only the blocks of ``a.T`` that hold a finite entry."""
    em_t = em.T  # [n, E]
    a_view = a.T  # A[i, k] = a[k, i]: the TN layout, i contiguous
    ctx, stream = _stream_of(a.device)
    with ctx:
        bufs = [em_t[:, seqs_t[0].long()] + pi[:, None], None]
        bufs[1] = torch.empty_like(bufs[0])
        for t in range(1, seqs_t.shape[0]):
            tropical.dense_step(a_view, bufs[(t - 1) % 2], em_t, seqs_t, lengths, t, bufs[t % 2],
                                blocks=blocks, stream=stream)
    return bufs[(seqs_t.shape[0] - 1) % 2].T


class ViterbiDecoder:
    """Non-specialized decoder.

    - ``"dense"``: the dense (min,+) recurrence, one product a step
      through ``svt_minplus`` (works for any model);
    - ``"structured"``: the diagonal/row/col-decomposed operator,
      O((D+R+C)·n) a step instead of O(n²); fused-eligible operators get
      the whole-sequence kernels on ``cuda``.

    ``mode="auto"`` picks structured when the decomposition is effective
    (cost ratio < 1/8 of dense), else dense, as the JAX package does.
    ``use_kernels=False`` (the JAX package's ``use_pallas=False``) pins the
    plain structured loop. ``device`` is required: ``"cpu"`` or
    ``"cuda[:i]"``. ``sop`` is the model's structured operator at its
    lane-padded width, where the caller has it; else it is built here.

    Dense mode's ``decode_batch`` opens the spans ``svt.stage``,
    ``svt.launch`` and ``svt.fetch`` (``utils/profiling.py::span``), and
    its staging counts ``tropical.dense_work``.
    """

    MODES = ("auto", "dense", "structured")

    def __init__(
        self,
        hmm: HMM,
        use_kernels: bool | None = None,
        mode: str = "auto",
        *,
        device: torch.device | str,
        sop: StructuredOperator | None = None,
    ):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.device = resolve_device(device)
        self.hmm = hmm
        self.states_num = hmm.states_num
        self._use_kernels = use_kernels
        self._stream_engine = None
        padded = pad_to_lane(hmm.states_num)
        self._sop = self._sop_arrs = None
        if mode in ("auto", "structured"):
            if sop is None:
                sop = StructuredOperator.from_hmm(hmm, pad_to=padded)
            elif (sop.n, sop.states_num) != (padded, hmm.states_num):
                raise ValueError(f"the operator is {sop.states_num} states padded to {sop.n}; "
                                 f"the model {hmm.states_num} padded to {padded}")
            if mode == "structured" or sop.cost_ratio() < 0.125:
                self._sop, self._sop_arrs = sop, sop.to(self.device)
                mode = "structured"
            else:
                mode = "dense"
        self.mode = mode
        # structured mode never reads the dense [n, n] operators
        self.dev = DeviceHMM.from_hmm(hmm, dense=mode == "dense", device=self.device)
        self._fused = None
        if (
            mode == "structured"
            and use_kernels is not False
            and self.device.type == "cuda"
            and fused.fused_eligible(self._sop)
        ):
            self._fused = fused.FusedStructuredDecoder(
                self._sop, hmm.emission_matrix(pad_to=padded), hmm.start_vector(pad_to=padded),
                device=self.device,
            )

    def decode(self, seq: np.ndarray) -> np.ndarray:
        """``run_Viterbi`` parity: final score vector for one sequence."""
        if self.mode == "dense":
            seq = self._validated(seq)
            v = _decode_scores(self.dev.a_t, self.dev.pi, self.dev.emissions, seq)
            return v[: self.states_num].cpu().numpy()
        return self.decode_batch([np.asarray(seq)], bucketed=False)[0]

    def _validated(self, seq) -> np.ndarray:
        seq = validate_obs_seq(seq, self.hmm.emit_num)
        if len(seq) == 0:
            raise ValueError("cannot decode an empty sequence")
        return seq

    def decode_path(self, seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(scores, path): the final score vector and the Viterbi path, with
        the oracle's tie rule. Dense mode runs the argmin product a step;
        structured mode the plain argmin scan on the decoder's device, as
        the JAX decoder runs this method on its XLA structured path and
        never on the fused kernel."""
        seq = self._validated(seq)
        if self.mode == "dense":
            v, path = _decode_scores_and_path(self.dev.a_t, self.dev.pi, self.dev.emissions, seq)
            return v[: self.states_num].cpu().numpy(), path.cpu().numpy()
        s = torch.as_tensor(seq, device=self.device)[:, None]  # [T, 1]
        em_t = self.dev.emissions.T
        v0 = em_t[:, s[0].long()] + self.dev.pi[:, None]
        v, src = structured_path_batch(
            self._sop, self._sop_arrs, em_t, v0, s[1:], None, torch.int32
        )
        last = torch.argmin(v, dim=0).to(torch.int32)  # [1]
        rev = fused.backtrace_plain(src, last)  # [T-1, 1]
        path = torch.cat([rev[:, 0], last])
        return v[: self.states_num, 0].cpu().numpy(), path.cpu().numpy()

    def decode_path_batch(
        self, seqs: list[np.ndarray]
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """(scores, path) per sequence, with the oracle's tie rule.

        With the kernels, the fused path decodes the batch (int16
        backpointers, bucketed by length, lane-chunked so every call fits
        the backpointer budget). Only when even one 128-lane block of the
        longest sequence exceeds that budget, or without the kernels, are
        sequences decoded one at a time (the JAX package's capacity rule).
        """
        if not seqs:
            return []
        if self._fused is not None and self._fused.path_supported(
            max(len(s) for s in seqs)
        ):
            return self._fused.decode_path_batch(seqs)
        return [self.decode_path(s) for s in seqs]

    def streaming(self):
        """The streaming engine for this model (cached): ``stream_begin`` /
        ``stream_feed`` / ``stream_scores`` for constant-memory scores over
        unbounded input, the ``stream_*_path`` family for exact paths by
        checkpoint and rematerialize, and ``stream_save``/``stream_load``.

        A fused-eligible operator of a structured-mode decoder gets the
        fused engine on the decoder's device (the kernels on ``cuda``,
        their plain versions on ``cpu``), unless ``use_kernels=False``;
        every other case, dense mode included, gets the plain stream
        engine, which takes any operator (a dense-mode decoder builds the
        decomposition here, on demand). The two engines' saved states are
        not interchangeable.
        """
        if self._stream_engine is None:
            sop = self._sop or StructuredOperator.from_hmm(self.hmm, pad_to=self.dev.padded)
            n = sop.n
            em, pi = self.hmm.emission_matrix(pad_to=n), self.hmm.start_vector(pad_to=n)
            if (self._sop is not None and self._use_kernels is not False
                    and fused.fused_eligible(sop)):
                self._stream_engine = self._fused or fused.FusedStructuredDecoder(
                    sop, em, pi, device=self.device
                )
            else:
                self._stream_engine = PlainStreamDecoder(sop, em, pi, device=self.device)
        return self._stream_engine

    def prepare_batch(self, seqs: list[np.ndarray], t_pad: int | None = None):
        """Validate, pad and upload a batch once; returns a device handle.

        ``t_pad`` forces a fixed (bucket-quantized) time length.
        """
        if self._fused is not None:
            return self._fused.prepare(seqs, t_pad=t_pad)
        seqs = [validate_obs_seq(s, self.hmm.emit_num) for s in seqs]
        batch, lengths = pad_batch(seqs, SUBLANE, t_pad=t_pad)
        if self.mode == "dense":
            lanes, t_total = batch.shape
            blocks = self.dev.blocks  # lanes pad to SUBLANE: the step reads its list
            read = blocks.listed * tropical.LIST_ROWS * tropical.STAGE_K if blocks else self.dev.padded ** 2
            tropical.dense_work["launched"] += self.dev.padded ** 2 * lanes * (t_total - 1)
            tropical.dense_work["read"] += read * lanes * (t_total - 1)
            live = int(np.maximum(lengths.astype(np.int64) - 1, 0).sum())
            tropical.dense_work["real"] += self.dev.finite * live
        return (
            torch.as_tensor(batch.T.copy(), device=self.device),
            torch.as_tensor(lengths, device=self.device),
        )

    def run_batch(self, handle) -> torch.Tensor:
        """Decode a prepared batch; returns [B, n] device scores."""
        if self._fused is not None:
            return self._fused.run_prepared(handle)
        seqs_t, lengths = handle
        if self.mode == "dense":
            return _decode_scores_batch(
                self.dev.a, self.dev.pi, self.dev.emissions, seqs_t, lengths, self.dev.blocks
            )
        em_t = self.dev.emissions.T
        v0 = em_t[:, seqs_t[0].long()] + self.dev.pi[:, None]
        return structured_scores_batch(
            self._sop, self._sop_arrs, em_t, v0, seqs_t[1:], lengths
        ).T

    def decode_batch(
        self, seqs: list[np.ndarray], bucketed: bool = True
    ) -> list[np.ndarray]:
        """Decode a set of sequences as one batched device program.

        Per-sequence masking freezes finished lanes, so results equal
        one-at-a-time decoding. Ragged batches are length-bucketed
        (``bucket_plan``): each bucket runs at its own quantized max
        length, and every bucket is enqueued before one host transfer.
        """
        if not seqs:
            return []
        if self._fused is not None:
            return self._fused.decode_batch(seqs, bucketed=bucketed)
        record = span if self.mode == "dense" else _unrecorded
        plan = None
        if bucketed:
            with record("svt.stage"):
                plan = bucket_plan([len(s) for s in seqs], lane_block=SUBLANE)
        if plan is None:
            with record("svt.stage"):
                handle = self.prepare_batch(seqs)
            with record("svt.launch"):
                out = self.run_batch(handle)
            with record("svt.fetch"):
                v = out.cpu().numpy()
                return [v[i, : self.states_num] for i in range(len(seqs))]
        outs = []
        for idx, t_q in plan:
            with record("svt.stage"):
                handle = self.prepare_batch([seqs[i] for i in idx], t_pad=t_q)
            with record("svt.launch"):
                outs.append(self.run_batch(handle)[: len(idx)])
        with record("svt.fetch"):
            v = torch.cat(outs, dim=0).cpu().numpy()
            result: list[np.ndarray | None] = [None] * len(seqs)
            row = 0
            for idx, _ in plan:
                for i in idx:
                    result[i] = v[row, : self.states_num]
                    row += 1
        return result


def _unrecorded(name: str):
    """A stand-in for :func:`span` that records nothing: the plain
    structured loop opens no stage spans."""
    return contextlib.nullcontext()
