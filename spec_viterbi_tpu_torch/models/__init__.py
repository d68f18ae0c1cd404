"""Viterbi decoders: the NumPy oracles, the structured decoder and the
plain stream engine."""

from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder
from spec_viterbi_tpu_torch.models.oracle import viterbi_path_oracle, viterbi_scores_oracle

__all__ = ["ViterbiDecoder", "viterbi_path_oracle", "viterbi_scores_oracle"]
