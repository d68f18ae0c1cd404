"""HMMER3 profile → compacted HMM (.chmm) conversion, copied from
``spec_viterbi_tpu/io/hmmer.py``.

A re-implementation of the reference's offline converter
(``chmm_files/silent_hmm_to_chmm.py:18-145``): extracts the MSV-style model
from a HMMER3/b ``.hmm`` profile — match states only, with the N/J and C
special states merged into two background states — using HMMER fs-mode
loop/move probabilities.

Model layout (``silent_hmm_to_chmm.py:92-99``): states are
``[N, M1..ML, C]``; state 0 (N background) is the only start state with
probability 1; N and C emit the standard background amino-acid frequencies;
match states emit ``e^(−w)`` from the profile's neg-ln weights.

Two reference quirks are reproduced deliberately (the committed ``.chmm``
corpus embeds them, and byte-level corpus parity is the contract):

1. the match-chain transition list is **offset by one**: edge ``Mk→Mk+1``
   takes the value parsed for node ``k−1``'s transition line, with index 0
   being the ``B→M1`` entry (``silent_hmm_to_chmm.py:57,130-133``);
2. that first ``B→M1`` entry is written **without** the ``e^(−x)``
   conversion applied to every other transition
   (``silent_hmm_to_chmm.py:57`` appends the raw token).

Probabilities are rounded to 10 decimal places exactly like the reference's
``to_fixed`` writer (``silent_hmm_to_chmm.py:10-11``) so converted models
match the committed corpus bit-for-bit after parsing.
"""

from __future__ import annotations

import math
import os

import numpy as np

from spec_viterbi_tpu_torch.hmm import HMM, to_modified_prob_np

NUM_AMINO_ACIDS = 20

# Standard background amino-acid frequencies, A..Y order
# (silent_hmm_to_chmm.py:23-29).
BACKGROUND_FREQUENCIES = [
    0.0787945, 0.0151600, 0.0535222, 0.0668298,  # A C D E
    0.0397062, 0.0695071, 0.0229198, 0.0590092,  # F G H I
    0.0594422, 0.0963728, 0.0237718, 0.0414386,  # K L M N
    0.0482904, 0.0395639, 0.0540978, 0.0683364,  # P Q R S
    0.0540687, 0.0673417, 0.0114135, 0.0304133,  # T V W Y
]


def _fixed(x: float) -> float:
    """10-decimal rounding, matching the reference writer's text format."""
    return float(f"{float(x):.10f}")


def read_hmmer_msv(path: str | os.PathLike):
    """Parse a HMMER3/b profile: (model_length, match_emissions, match_trans).

    ``match_emissions`` is [L][20] in probability space (``e^(−w)``);
    ``match_trans`` is the raw transition list with the reference's
    off-by-one/unconverted-head semantics: index 0 is the raw ``B→M1``
    neg-ln token, indices 1.. are ``e^(−w)`` of each node's
    ``Mk→Mk+1`` entry.
    """
    model_length = 0
    match_emissions: list[list[float]] = []
    match_trans: list[float] = []
    with open(os.fspath(path)) as f:
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no COMPO line (not a HMMER3 profile?)")
            stripped = line.lstrip()
            if stripped.startswith("COMPO"):
                break
            if stripped.startswith("LENG"):
                model_length = int(stripped.split()[1])
        if model_length <= 0:
            raise ValueError(f"{path}: missing LENG")

        f.readline()  # node-0 insert emissions
        # B-state transition line; the raw first token (quirk #2)
        match_trans.append(float(f.readline().split()[0]))

        line = f.readline().strip()
        while line != "//":
            toks = line.split()[1 : NUM_AMINO_ACIDS + 1]
            match_emissions.append([math.exp(-float(t)) for t in toks])
            f.readline()  # insert emission line
            to_next = float(f.readline().split()[0])
            match_trans.append(math.exp(-to_next))
            line = f.readline().strip()

    if len(match_emissions) != model_length:
        raise ValueError(
            f"{path}: LENG {model_length} but parsed {len(match_emissions)} nodes"
        )
    return model_length, match_emissions, match_trans


def hmmer_to_hmm(path: str | os.PathLike) -> HMM:
    """Convert a HMMER3/b profile to the compacted in-memory HMM.

    Produces the same numbers as parsing a reference-converted ``.chmm``
    (values pass through the 10-decimal text rounding).
    """
    length, emissions, trans = read_hmmer_msv(path)
    n = length + 2  # N + M1..ML + C (silent_hmm_to_chmm.py:95)

    # special-state weights (silent_hmm_to_chmm.py:78-89)
    exp_num_of_hits = 2.0
    tr_mk_c = (exp_num_of_hits - 1.0) / exp_num_of_hits
    tr_mk_n = 1.0 / exp_num_of_hits
    tr_move = 3 / (length + 3)
    tr_loop = 1.0 - tr_move
    tr_n_mk = 2.0 / float(length * (length + 1))

    em = np.zeros((n, NUM_AMINO_ACIDS), dtype=np.float64)
    em[0] = [_fixed(x) for x in BACKGROUND_FREQUENCIES]
    for k, row in enumerate(emissions):
        em[k + 1] = [_fixed(x) for x in row]
    em[n - 1] = em[0]

    rows, cols, probs = [], [], []

    def add(r, c, p):
        rows.append(r)
        cols.append(c)
        probs.append(_fixed(p))

    # N transitions (silent_hmm_to_chmm.py:121-126)
    add(0, 0, tr_loop)
    for i in range(length):
        add(0, i + 1, tr_move * tr_n_mk)
    # match chain with the reference's off-by-one indexing (quirks #1, #2)
    for i in range(length - 1):
        add(i + 1, i + 2, trans[i])
    # M → N and M → C (silent_hmm_to_chmm.py:135-140)
    for i in range(length):
        add(i + 1, 0, tr_mk_n)
        add(i + 1, n - 1, tr_mk_c)
    # C self-loop (silent_hmm_to_chmm.py:142-144)
    add(n - 1, n - 1, tr_loop)

    hmm = HMM(
        states_num=n,
        emit_num=NUM_AMINO_ACIDS,
        trans_rows=np.asarray(rows, dtype=np.int64),
        trans_cols=np.asarray(cols, dtype=np.int64),
        trans_probs=to_modified_prob_np(np.asarray(probs)),
        emissions=to_modified_prob_np(em.T),  # [symbol, state]
        start_probabilities_cols=np.asarray([0], dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.asarray([1.0])),
    )
    hmm.validate()
    return hmm


def hmmer_to_chmm(path: str | os.PathLike, out_path: str | os.PathLike) -> None:
    """File-level converter (CLI parity with silent_hmm_to_chmm.py)."""
    from spec_viterbi_tpu_torch.io.chmm import write_chmm

    write_chmm(hmmer_to_hmm(path), out_path)
