"""Named (min,+) ops of the dense decode and specialization paths.

The port of ``spec_viterbi_tpu/ops/dispatch.py``. The JAX module leaves
these to XLA's broadcast and reduce; here each goes through one launch of
the hand-written product :func:`~spec_viterbi_tpu_torch.ops.tropical.minplus`
on a CUDA tensor (its plain version on a CPU tensor), on strided views of
its operands: no transpose is made. The specializer and the tests use
them; the dense decoder's loops launch the same kernel with its epilogue
through :func:`~spec_viterbi_tpu_torch.ops.tropical.dense_step` and
``dense_step_mv`` instead, one launch a step.
"""

from __future__ import annotations

import torch

from spec_viterbi_tpu_torch.ops import tropical


def step_mv(a_t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One recurrence matvec: ``min_j a_t[i,j] + v[j]``; [n, K], [K] → [n]."""
    return tropical.minplus(a_t[None], v.contiguous()[None, :, None])[0, :, 0]


def step_mv_argmin(a_t: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`step_mv` and the lowest ``j`` of each minimum (int32)."""
    u, idx = tropical.minplus(a_t[None], v.contiguous()[None, :, None], argmin=True)
    return u[0, :, 0], idx[0, :, 0]


def batch_step_t(a: torch.Tensor, v_t: torch.Tensor) -> torch.Tensor:
    """Batched step on a state-major carry: ``U_T[i,b] = min_j a[j,i] +
    v_t[j,b]``. ``a`` is the untransposed transition matrix, read through
    its transposed view."""
    return tropical.minplus(a.T[None], v_t.contiguous()[None])[0]


def matmul_tn(AT: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """TN tropical matmul ``C[i,j] = min_k AT[k,i] + B[k,j]``."""
    return tropical.minplus(AT.T[None], B.contiguous()[None])[0]
