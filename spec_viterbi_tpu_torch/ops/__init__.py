"""(min,+) structured operators, their plain PyTorch step, and the fused
CUDA scores kernels; the five tropical-semiring functions of the JAX
package's ``ops`` (plain PyTorch, :mod:`.tropical`)."""

from spec_viterbi_tpu_torch.ops.tropical import (
    tropical_mm,
    tropical_mm_blocked,
    tropical_mm_tn_blocked,
    tropical_mv,
    tropical_mv_argmin,
)

__all__ = [
    "tropical_mv",
    "tropical_mm",
    "tropical_mv_argmin",
    "tropical_mm_blocked",
    "tropical_mm_tn_blocked",
]
