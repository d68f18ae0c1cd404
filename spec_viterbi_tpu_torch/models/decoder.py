"""Non-specialized Viterbi decoding, structured mode.

The port of ``spec_viterbi_tpu/models/decoder.py``. API parity target:
``run_Viterbi(hmm, seq) -> Mod_prob_vec_t``, the final per-state −log2
score vector; ``decode_path``/``decode_path_batch`` add the exact Viterbi
path and ``streaming()`` the stream engines. On a CUDA device,
fused-eligible operators decode batches through the hand-written kernels
of :mod:`spec_viterbi_tpu_torch.ops.fused`; otherwise (a CPU device,
``use_kernels=False``, or an operator too irregular for the kernels) the
plain structured loop runs, the counterpart of the JAX package's XLA
structured path.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.hmm import HMM, pad_to_lane, validate_obs_seq
from spec_viterbi_tpu_torch.models.streaming_xla import PlainStreamDecoder
from spec_viterbi_tpu_torch.ops import fused
from spec_viterbi_tpu_torch.ops.structured import (
    StructuredOperator,
    structured_path_batch,
    structured_scores_batch,
)
from spec_viterbi_tpu_torch.utils.batching import bucket_plan, pad_batch

# lane multiple and bucket block of the plain path, as in the JAX package
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


class ViterbiDecoder:
    """Non-specialized decoder.

    ``mode="structured"`` decodes through the diagonal/row/col-decomposed
    operator; ``mode="auto"`` picks it when the decomposition is effective
    (cost ratio < 1/8 of dense). Dense mode is not ported yet, so ``auto``
    resolving to dense raises. ``use_kernels=False`` (the JAX package's
    ``use_pallas=False``) pins the plain structured loop. ``device`` is
    required: ``"cpu"`` or ``"cuda[:i]"``.
    """

    MODES = ("auto", "dense", "structured")

    def __init__(
        self,
        hmm: HMM,
        use_kernels: bool | None = None,
        mode: str = "auto",
        *,
        device: torch.device | str,
    ):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.device = resolve_device(device)
        self.hmm = hmm
        padded = pad_to_lane(hmm.states_num)
        sop = StructuredOperator.from_hmm(hmm, pad_to=padded)
        if mode == "dense" or (mode == "auto" and sop.cost_ratio() >= 0.125):
            raise NotImplementedError(
                "dense mode is not ported to PyTorch yet (ROADMAP A6)"
            )
        self.mode = "structured"
        self._use_kernels = use_kernels
        self._stream_engine = None
        self.states_num = hmm.states_num
        self._sop = sop
        self._sop_arrs = sop.to(self.device)
        em = hmm.emission_matrix(pad_to=padded)
        pi = hmm.start_vector(pad_to=padded)
        self.emissions = torch.as_tensor(em, device=self.device)  # [E, n]
        self.pi = torch.as_tensor(pi, device=self.device)  # [n]
        self._fused = None
        if (
            use_kernels is not False
            and self.device.type == "cuda"
            and fused.fused_eligible(sop)
        ):
            self._fused = fused.FusedStructuredDecoder(sop, em, pi, device=self.device)

    def decode(self, seq: np.ndarray) -> np.ndarray:
        """``run_Viterbi`` parity: final score vector for one sequence."""
        return self.decode_batch([np.asarray(seq)], bucketed=False)[0]

    def decode_path(self, seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(scores, path): the final score vector and the Viterbi path, with
        the oracle's tie rule. Runs the plain argmin scan on the decoder's
        device, as the JAX decoder runs this method on its XLA structured
        path and never on the fused kernel."""
        seq = validate_obs_seq(seq, self.hmm.emit_num)
        if len(seq) == 0:
            raise ValueError("cannot decode an empty sequence")
        s = torch.as_tensor(seq, device=self.device)[:, None]  # [T, 1]
        em_t = self.emissions.T
        v0 = em_t[:, s[0].long()] + self.pi[:, None]
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

        A fused-eligible operator gets the fused engine on the decoder's
        device (the kernels on ``cuda``, their plain versions on ``cpu``),
        unless ``use_kernels=False``; every other case gets the plain
        stream engine, which takes any operator. The two engines' saved
        states are not interchangeable.
        """
        if self._stream_engine is None:
            n = self._sop.n
            em, pi = self.hmm.emission_matrix(pad_to=n), self.hmm.start_vector(pad_to=n)
            if self._use_kernels is not False and fused.fused_eligible(self._sop):
                self._stream_engine = self._fused or fused.FusedStructuredDecoder(
                    self._sop, em, pi, device=self.device
                )
            else:
                self._stream_engine = PlainStreamDecoder(self._sop, em, pi, device=self.device)
        return self._stream_engine

    def prepare_batch(self, seqs: list[np.ndarray], t_pad: int | None = None):
        """Validate, pad and upload a batch once; returns a device handle.

        ``t_pad`` forces a fixed (bucket-quantized) time length.
        """
        if self._fused is not None:
            return self._fused.prepare(seqs, t_pad=t_pad)
        seqs = [validate_obs_seq(s, self.hmm.emit_num) for s in seqs]
        batch, lengths = pad_batch(seqs, SUBLANE, t_pad=t_pad)
        return (
            torch.as_tensor(batch.T.copy(), device=self.device),
            torch.as_tensor(lengths, device=self.device),
        )

    def run_batch(self, handle) -> torch.Tensor:
        """Decode a prepared batch; returns [B, n] device scores."""
        if self._fused is not None:
            return self._fused.run_prepared(handle)
        seqs_t, lengths = handle
        em_t = self.emissions.T
        v0 = em_t[:, seqs_t[0].long()] + self.pi[:, None]
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
        plan = (
            bucket_plan([len(s) for s in seqs], lane_block=SUBLANE)
            if bucketed
            else None
        )
        if plan is None:
            v = self.run_batch(self.prepare_batch(seqs)).cpu().numpy()
            return [v[i, : self.states_num] for i in range(len(seqs))]
        outs = []
        for idx, t_q in plan:
            out = self.run_batch(self.prepare_batch([seqs[i] for i in idx], t_pad=t_q))
            outs.append(out[: len(idx)])
        v = torch.cat(outs, dim=0).cpu().numpy()
        result: list[np.ndarray | None] = [None] * len(seqs)
        row = 0
        for idx, _ in plan:
            for i in idx:
                result[i] = v[row, : self.states_num]
                row += 1
        return result
