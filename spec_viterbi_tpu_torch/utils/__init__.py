"""Host-side utilities: batch padding and length bucketing, and the
operator cache."""

from spec_viterbi_tpu_torch.utils.cache import OperatorCache

__all__ = ["OperatorCache"]
