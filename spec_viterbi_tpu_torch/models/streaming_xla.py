"""The plain stream engine: the streaming protocol on the torch structured
scan, for any operator.

The port of ``spec_viterbi_tpu/models/streaming_xla.py``. The fused engine
(:class:`~spec_viterbi_tpu_torch.ops.fused.FusedStructuredDecoder`) needs a
fused-eligible operator (at most 8 residual entries, at most 24
components). This engine runs the same protocol
(:class:`~spec_viterbi_tpu_torch.ops.fused._StreamAPI`) on
:func:`~spec_viterbi_tpu_torch.ops.structured.structured_scores_batch` and
:func:`~spec_viterbi_tpu_torch.ops.structured.structured_path_batch`,
which take any decomposition, so ``ViterbiDecoder.streaming()`` works for
every model the decoder accepts. Its backpointers are int32 (no 32k-state
limit). Its stream states carry their own fingerprint prefix: they do not
load into the fused engine, nor the fused engine's into this one.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.ops.fused import _StreamAPI, backtrace_plain, path_budget_bytes
from spec_viterbi_tpu_torch.ops.structured import (
    StructuredOperator,
    structured_path_batch,
    structured_scores_batch,
)


class PlainStreamDecoder(_StreamAPI):
    """Streaming engine on the plain structured scan; any operator, any
    device (the counterpart of the JAX package's ``XLAStreamDecoder``).

    ``emissions`` [E, n] and ``pi`` [n] are numpy arrays or tensors; a
    float32 tensor already on ``device`` is not uploaded again. ``arrs``
    holds the operator's tensors, uploaded once here."""

    _KEY_PREFIX = "torch-plain"

    def __init__(
        self,
        sop: StructuredOperator,
        emissions: np.ndarray | torch.Tensor,
        pi: np.ndarray | torch.Tensor,
        *,
        device: torch.device | str,
    ):
        self.device = torch.device(device)
        self.sop = sop
        self.n = sop.n
        self.states_num = sop.states_num
        self.emit_num = int(emissions.shape[0])
        self.arrs = sop.to(self.device)
        em = torch.as_tensor(emissions, dtype=torch.float32, device=self.device)
        self.em_t = em.T.contiguous()  # [n, E]
        self.pi = torch.as_tensor(pi, dtype=torch.float32, device=self.device)
        # one [T_q, B, n] int32 backpointer block materializes per finalize
        # chunk, under the fused engine's budget
        self.MAX_PATH_BYTES = path_budget_bytes(self.device)

    def path_supported(self, t_max: int, batch: int = 1) -> bool:
        """Whether one finalize block of this shape fits the pointer budget."""
        return max(0, t_max - 1) * self.n * batch * 4 <= self.MAX_PATH_BYTES

    def _feed(self, carry, syms, lengths):
        return structured_scores_batch(self.sop, self.arrs, self.em_t, carry, syms, lengths)

    def _path_pointers(self, carry, syms, lengths):
        return structured_path_batch(
            self.sop, self.arrs, self.em_t, carry, syms, lengths, torch.int32
        )[1]

    def _backtrace(self, src, boundary):
        return backtrace_plain(src, boundary)


# the JAX package's name of this engine, so a reader finds the counterpart
XLAStreamDecoder = PlainStreamDecoder
