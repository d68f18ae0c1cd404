"""Host-side utilities: batch padding and length bucketing, the operator
cache, profiling helpers and large host slabs."""

from spec_viterbi_tpu_torch.utils.cache import OperatorCache
from spec_viterbi_tpu_torch.utils.profiling import StepTimer, span, trace

__all__ = ["OperatorCache", "trace", "StepTimer", "span"]
