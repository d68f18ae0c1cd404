"""FASTA → symbol-sequence conversion, copied from
``spec_viterbi_tpu/io/fasta.py``.

Amino-acid alphabet mapping A..Y → 0..19 with the ambiguity code X → 0,
as the reference converter maps it.
"""

from __future__ import annotations

import os

import numpy as np

AMINO2NUM = {
    "A": 0, "C": 1, "D": 2, "E": 3, "F": 4,
    "G": 5, "H": 6, "I": 7, "K": 8, "L": 9,
    "M": 10, "N": 11, "P": 12, "Q": 13, "R": 14,
    "S": 15, "T": 16, "V": 17, "W": 18, "Y": 19,
    # X can be transformed into any amino acid; the reference maps it to 0.
    "X": 0,
}


def fasta_to_sequences(path: str | os.PathLike) -> list[np.ndarray]:
    """Parse a FASTA file into int32 symbol arrays (one per record).

    Residues are upper-cased first (soft-masked FASTA is common); an
    unmapped code raises a clear error naming the residue and record
    instead of a bare KeyError.
    """
    seqs: list[np.ndarray] = []
    cur: list[int] = []
    with open(os.fspath(path), "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    seqs.append(np.asarray(cur, dtype=np.int32))
                cur = []
            else:
                for ch in line.upper():
                    sym = AMINO2NUM.get(ch)
                    if sym is None:
                        raise ValueError(
                            f"{path}: unsupported residue {ch!r} in record "
                            f"{len(seqs)} (alphabet is the 20 amino acids + X)"
                        )
                    cur.append(sym)
    if cur:
        seqs.append(np.asarray(cur, dtype=np.int32))
    return seqs


def fasta_to_ess(fasta_path: str | os.PathLike, ess_path: str | os.PathLike) -> None:
    """Convert a FASTA file to ``.ess``."""
    from spec_viterbi_tpu_torch.io.ess import write_ess

    write_ess(fasta_to_sequences(fasta_path), ess_path)
