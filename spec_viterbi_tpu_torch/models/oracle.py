"""NumPy reference oracles (scores and paths), copied from
``spec_viterbi_tpu/models/oracle.py`` so that a check on the card needs
no jax.

Recurrence, in −log2 space with +inf as the semiring zero::

    v₀[i] = emit[o₀][i] + π[i]
    vₜ[i] = emit[oₜ][i] + min_j (Aᵀ[i,j] + vₜ₋₁[j])
"""

from __future__ import annotations

import numpy as np

from spec_viterbi_tpu_torch.hmm import HMM, MOD_PROB_DTYPE


def viterbi_scores_oracle(hmm: HMM, seq: np.ndarray) -> np.ndarray:
    """Final −log2 score per state, float32."""
    seq = np.asarray(seq, dtype=np.int64)
    a_t = hmm.transposed_transition_matrix()
    pi = hmm.start_vector()
    em = np.asarray(hmm.emissions, dtype=MOD_PROB_DTYPE)

    v = (em[seq[0]] + pi).astype(MOD_PROB_DTYPE)
    for o in seq[1:]:
        u = np.min(a_t + v[None, :], axis=1)
        v = (em[o] + u).astype(MOD_PROB_DTYPE)
    return v


def viterbi_path_oracle(hmm: HMM, seq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(scores, path): final score vector plus the arg-min Viterbi path.

    Ties break to the lowest state index at every step (``np.argmin``),
    making paths deterministic.
    """
    seq = np.asarray(seq, dtype=np.int64)
    a_t = hmm.transposed_transition_matrix()
    pi = hmm.start_vector()
    em = np.asarray(hmm.emissions, dtype=MOD_PROB_DTYPE)
    T = len(seq)

    v = (em[seq[0]] + pi).astype(MOD_PROB_DTYPE)
    ptr = np.zeros((T - 1, hmm.states_num), dtype=np.int32)
    for t, o in enumerate(seq[1:]):
        s = a_t + v[None, :]
        ptr[t] = np.argmin(s, axis=1)
        v = (em[o] + np.min(s, axis=1)).astype(MOD_PROB_DTYPE)

    path = np.zeros(T, dtype=np.int32)
    path[-1] = int(np.argmin(v))
    for t in range(T - 2, -1, -1):
        path[t] = ptr[t, path[t + 1]]
    return v, path
