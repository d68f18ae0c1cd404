"""The MSV profile structure of the corpus's Pfam models, with seeded values.

A frozen copy of ``spec_viterbi_tpu_torch/io/generators.py``'s
``generate_profile_hmm`` (and of the −log2 conversion it uses), so that a
later change to the program cannot change the data the benchmark decodes.
It returns plain numpy arrays; the harness builds the program's ``HMM`` from
them and hands the same arrays to the reference.

``L`` match states plus a merged N background state (state 0) and a C state
(the last), as HMMER's MSV model is written out by the reference's
``silent_hmm_to_chmm.py``:

- state 0 loops on itself with ``1 − 3/(L+3)`` and enters every match state
  with the uniform ``2/(L(L+1))``;
- match state ``k`` moves to ``k+1`` with a seeded probability;
- every match state returns to state 0 and to the C state with 0.5, except
  one seeded return to C that deviates;
- the C state loops on itself; only state 0 starts;
- emission rows are seeded Dirichlet draws over the alphabet.

That is ``L + 2`` states and ``4L + 1`` transitions: 2,407 and 9,621 at
``L = 2405``.
"""

from __future__ import annotations

import numpy as np


def to_cost(p: np.ndarray) -> np.ndarray:
    """``−log2(p)`` as float32, ``+inf`` where ``p`` is 0."""
    p = np.asarray(p, dtype=np.float64)
    out = np.full(p.shape, np.inf, dtype=np.float32)
    pos = p > 0.0
    out[pos] = (-np.log2(p[pos])).astype(np.float32)
    return out


def build(config: dict, seed: int) -> dict:
    """The model's arrays: ``states``, ``symbols``, COO transitions
    ``src``/``dst``/``cost`` (−log2, float32), ``emissions`` [symbols,
    states] and the sparse start ``start_states``/``start_cost``."""
    big_l = int(config["match_states"])
    emit_num = int(config["symbols"])
    if big_l < 2:
        raise ValueError("a profile model needs at least 2 match states")
    rng = np.random.default_rng(seed)
    c_state = big_l + 1
    states = big_l + 2
    match = np.arange(1, big_l + 1, dtype=np.int64)
    loop = 1.0 - 3.0 / (big_l + 3)

    ret_c = np.full(big_l, 0.5)
    ret_c[rng.integers(0, big_l)] = rng.uniform(0.05, 0.45)
    src = np.concatenate([
        [0], np.zeros(big_l, np.int64),   # N loop, uniform entry
        match[:-1],                       # match chain k → k+1
        match, match,                     # returns to N and to C
        [c_state],                        # C loop
    ])
    dst = np.concatenate([
        [0], match,
        match[1:],
        np.zeros(big_l, np.int64), np.full(big_l, c_state),
        [c_state],
    ])
    probs = np.concatenate([
        [loop], np.full(big_l, 2.0 / (big_l * (big_l + 1))),
        rng.uniform(0.3, 0.95, size=big_l - 1),
        np.full(big_l, 0.5), ret_c,
        [loop],
    ])
    emissions_by_state = rng.dirichlet(np.ones(emit_num), size=states)  # [N, E]
    return {
        "states": states,
        "symbols": emit_num,
        "src": src.astype(np.int64),
        "dst": dst.astype(np.int64),
        "cost": to_cost(probs),
        "emissions": np.ascontiguousarray(to_cost(emissions_by_state.T)),
        "start_states": np.array([0], dtype=np.int64),
        "start_cost": to_cost(np.array([1.0])),
    }
