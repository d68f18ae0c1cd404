"""spec_viterbi_tpu_torch — the PyTorch/CUDA port of spec_viterbi_tpu.

Viterbi decoding of HMMs as (min,+) semiring products, for one NVIDIA
H100. It imports torch and numpy and never jax: the numpy host layer of
the JAX package is copied here, and the tests hold the copies equal to
the originals. Every entry point takes an explicit ``device``.
"""

from spec_viterbi_tpu_torch.hmm import HMM, almost_equal_vec
from spec_viterbi_tpu_torch.io import read_emit_seq, read_hmm
from spec_viterbi_tpu_torch.models import (
    DeviceHMM,
    SpecializedViterbi,
    StructuredSpecializedViterbi,
    ViterbiDecoder,
    viterbi_path_oracle,
    viterbi_scores_oracle,
)
from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
from spec_viterbi_tpu_torch.utils import OperatorCache

__version__ = "0.1.0"

__all__ = [
    "HMM",
    "almost_equal_vec",
    "read_hmm",
    "read_emit_seq",
    "DeviceHMM",
    "ViterbiDecoder",
    "SpecializedViterbi",
    "StructuredSpecializedViterbi",
    "OperatorCache",
    "StructuredOperator",
    "viterbi_path_oracle",
    "viterbi_scores_oracle",
]
