"""I/O: .chmm / .ess parsers (with the native C++ parser) and writers,
FASTA and HMMER3 conversion (the MSV model, and the full Plan7 profile with
its delete chains folded), and seeded dataset generators."""

from spec_viterbi_tpu_torch.io.chmm import read_hmm, write_chmm
from spec_viterbi_tpu_torch.io.ess import read_emit_seq, write_ess
from spec_viterbi_tpu_torch.io.fasta import fasta_to_sequences
from spec_viterbi_tpu_torch.io.generators import (
    generate_banded_hmm,
    generate_plan7_hmm,
    generate_plan7_profile,
    generate_profile_hmm,
    generate_random_hmm,
    generate_random_sequences,
    generate_tie_heavy_banded_hmm,
    generate_tie_heavy_hmm,
)
from spec_viterbi_tpu_torch.io.hmmer import (
    Plan7Profile,
    hmmer_to_chmm,
    hmmer_to_hmm,
    plan7_to_hmm,
    read_hmmer_plan7,
)

__all__ = [
    "generate_banded_hmm",
    "generate_tie_heavy_banded_hmm",
    "generate_tie_heavy_hmm",
    "read_hmm",
    "write_chmm",
    "read_emit_seq",
    "write_ess",
    "fasta_to_sequences",
    "hmmer_to_chmm",
    "hmmer_to_hmm",
    "Plan7Profile",
    "read_hmmer_plan7",
    "plan7_to_hmm",
    "generate_plan7_profile",
    "generate_plan7_hmm",
    "generate_profile_hmm",
    "generate_random_hmm",
    "generate_random_sequences",
]
