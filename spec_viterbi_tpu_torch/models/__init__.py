"""Viterbi decoders: the NumPy oracles, the dense and structured decoder,
the dense specializer and the plain stream engine."""

from spec_viterbi_tpu_torch.models.decoder import DeviceHMM, ViterbiDecoder
from spec_viterbi_tpu_torch.models.oracle import viterbi_path_oracle, viterbi_scores_oracle
from spec_viterbi_tpu_torch.models.specializer import SpecializedViterbi

__all__ = [
    "DeviceHMM",
    "SpecializedViterbi",
    "ViterbiDecoder",
    "viterbi_path_oracle",
    "viterbi_scores_oracle",
]
