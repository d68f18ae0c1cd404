"""Seeded dataset generators.

``generate_random_hmm`` and ``generate_random_sequences`` are copied from
``spec_viterbi_tpu/io/generators.py``. ``generate_profile_hmm`` is new: it
stands in for the Pfam-derived ``.chmm`` corpus, which is not part of the
repository, in tests and in the smoke run. ``generate_tie_heavy_hmm`` and
``generate_tie_heavy_banded_hmm`` are new too: models whose costs are
small integers, to hold the path tie rule. ``generate_banded_hmm`` draws
what ``tests/test_fused_tp.py::banded_hmm`` draws, for the state-sharded
decode. ``generate_plan7_profile`` draws a full Plan7 profile (match,
insert and delete states), which ``generate_plan7_hmm`` folds. All are test data, not decoder features.
"""

from __future__ import annotations

import numpy as np

from spec_viterbi_tpu_torch.hmm import HMM, MOD_PROB_DTYPE, to_modified_prob_np
from spec_viterbi_tpu_torch.io.hmmer import Plan7Profile, plan7_to_hmm


def generate_random_hmm(
    states_num: int,
    trans_per_state: int = 3,
    emit_range: int = 20,
    num_non_zero_start_probs: int = 2,
    seed: int = 0,
) -> HMM:
    """Random HMM with normalized probability rows."""
    rng = np.random.default_rng(seed)

    def prob_row(length: int) -> np.ndarray:
        # integers in [0, 100), then normalized
        row = rng.integers(0, 100, size=length).astype(np.float64)
        s = row.sum()
        if s == 0:
            row[:] = 1.0
            s = float(length)
        return row / s

    start_cols = np.arange(num_non_zero_start_probs, dtype=np.int64)
    start_probs = to_modified_prob_np(prob_row(num_non_zero_start_probs))

    emissions_by_state = np.stack(
        [prob_row(emit_range) for _ in range(states_num)]
    )  # [N, E]
    emissions = to_modified_prob_np(emissions_by_state.T)  # [E, N]

    rows, cols, probs = [], [], []
    for src in range(states_num):
        dsts = rng.choice(states_num, size=trans_per_state, replace=False)
        p = prob_row(trans_per_state)
        rows.extend([src] * trans_per_state)
        cols.extend(int(d) for d in dsts)
        probs.extend(p)
    hmm = HMM(
        states_num=states_num,
        emit_num=emit_range,
        trans_rows=np.asarray(rows, dtype=np.int64),
        trans_cols=np.asarray(cols, dtype=np.int64),
        trans_probs=to_modified_prob_np(np.asarray(probs)),
        emissions=np.ascontiguousarray(emissions, dtype=MOD_PROB_DTYPE),
        start_probabilities_cols=start_cols,
        start_probabilities=start_probs,
    )
    hmm.validate()
    return hmm


def generate_random_sequences(
    count: int, length: int, emit_range: int = 20, seed: int = 0
) -> list[np.ndarray]:
    """Uniform random symbol sequences."""
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, emit_range, size=length).astype(np.int32)
        for _ in range(count)
    ]


def generate_profile_hmm(
    match_states: int, emit_num: int = 20, seed: int = 0
) -> HMM:
    """Seeded model with the shape of the corpus's MSV profile HMMs.

    Test and smoke data standing in for the corpus, not a decoder
    feature. ``SURVEY.md:134`` (section 2.7, the HMMER→chmm converter)
    describes the corpus models: ``L`` match states plus a merged N background state
    (state 0) and a C state (the last), 20 symbols. This builds that
    transition structure with seeded values:

    - state 0 loops on itself with ``1 − 3/(L+3)`` and enters every match
      state with the uniform ``2/(L(L+1))``;
    - match state ``k`` moves to ``k+1`` with a random probability;
    - every match state returns to state 0 and to the C state with 0.5,
      except one seeded return to C that deviates;
    - the C state loops on itself; only state 0 starts;
    - emission rows are seeded Dirichlet draws over ``emit_num`` symbols.

    The structured decomposition of such a model is one dense source row
    (state 0), two near-uniform dense destination columns (states 0 and
    ``L+1``), the +1 diagonal and no residual.
    """
    if match_states < 2:
        raise ValueError("a profile model needs at least 2 match states")
    rng = np.random.default_rng(seed)
    big_l = match_states
    c_state = big_l + 1
    states = big_l + 2
    match = np.arange(1, big_l + 1, dtype=np.int64)
    loop = 1.0 - 3.0 / (big_l + 3)

    ret_c = np.full(big_l, 0.5)
    ret_c[rng.integers(0, big_l)] = rng.uniform(0.05, 0.45)
    rows = np.concatenate([
        [0], np.zeros(big_l, np.int64),   # N loop, uniform entry
        match[:-1],                       # match chain k → k+1
        match, match,                     # returns to N and to C
        [c_state],                        # C loop
    ])
    cols = np.concatenate([
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
    hmm = HMM(
        states_num=states,
        emit_num=emit_num,
        trans_rows=rows.astype(np.int64),
        trans_cols=cols.astype(np.int64),
        trans_probs=to_modified_prob_np(probs),
        emissions=np.ascontiguousarray(
            to_modified_prob_np(emissions_by_state.T), dtype=MOD_PROB_DTYPE
        ),
        start_probabilities_cols=np.array([0], dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.array([1.0])),
    )
    hmm.validate()
    return hmm


def generate_plan7_profile(length: int, emit_num: int = 20, seed: int = 0) -> Plan7Profile:
    """Seeded local-mode Plan7 profile of ``length`` nodes.

    Test and benchmark data standing in for a Pfam family's model, not a
    decoder feature. Per node, MM/MI/MD are a Dirichlet(90, 5, 5) draw and
    IM/II and DM/DD Dirichlet(7, 3) draws; the special states are those of
    :func:`generate_profile_hmm` (N loops with ``1 − 3/(L+3)`` and enters
    every match state with ``2/(L(L+1))``, every match state exits to N and
    to C with 0.5 but one seeded exit to C, C loops like N); every emission
    row (match, insert, N, C) is a Dirichlet(1) draw over ``emit_num``
    symbols.
    """
    if length < 2:
        raise ValueError("a Plan7 profile needs at least 2 nodes")
    rng = np.random.default_rng(seed)
    big_l = length
    trans = np.concatenate([
        rng.dirichlet([90.0, 5.0, 5.0], size=big_l - 1),  # MM MI MD
        rng.dirichlet([7.0, 3.0], size=big_l - 1),        # IM II
        rng.dirichlet([7.0, 3.0], size=big_l - 1),        # DM DD
    ], axis=1)
    exit_c = np.full(big_l, 0.5)
    exit_c[rng.integers(0, big_l)] = rng.uniform(0.05, 0.45)
    match = rng.dirichlet(np.ones(emit_num), size=big_l)
    insert = rng.dirichlet(np.ones(emit_num), size=big_l - 1)
    n_em, c_em = rng.dirichlet(np.ones(emit_num), size=2)
    loop = 1.0 - 3.0 / (big_l + 3)
    return Plan7Profile(
        match_emissions=match,
        insert_emissions=insert,
        trans=trans,
        entry=np.full(big_l, 2.0 / (big_l * (big_l + 1))),
        exit_n=np.full(big_l, 0.5),
        exit_c=exit_c,
        n_loop=loop,
        c_loop=loop,
        n_emissions=n_em,
        c_emissions=c_em,
    )


def generate_plan7_hmm(length: int, emit_num: int = 20, seed: int = 0) -> HMM:
    """:func:`generate_plan7_profile` folded by
    :func:`~spec_viterbi_tpu_torch.io.hmmer.plan7_to_hmm`: ``2L + 1``
    states and ``(L-2)(L-1)/2 + 7L - 2`` transitions (1,001 and 127,749 at
    ``L = 500``)."""
    return plan7_to_hmm(generate_plan7_profile(length, emit_num, seed))


def generate_tie_heavy_hmm(states: int = 300, emit_num: int = 5, seed: int = 0) -> HMM:
    """Seeded fused-eligible model on which equal-cost paths are common.

    Test and smoke data for the path tie rule, not a decoder feature.
    Every probability is drawn from {1, 0.5, 0.25, 0}, so every cost is
    -0.0 (p = 1), 1, 2 or +inf and many candidates tie. Structure: state 0
    enters every state (a dense row), states 1..N-2 form a chain (the +1
    diagonal), every state enters the last one (a dense column), plus three
    residual entries. The last symbol is dead (no state emits it), so a
    sequence through it drives every score to +inf.
    """
    if states < 40:
        raise ValueError("the tie-heavy model needs at least 40 states")
    rng = np.random.default_rng(seed)
    levels = np.array([1.0, 0.5, 0.25, 0.0])

    def draw(size):
        return rng.choice(levels, size=size, p=[0.35, 0.3, 0.25, 0.1])

    last = states - 1
    pairs = {(0, j) for j in range(states)}
    pairs |= {(i, i + 1) for i in range(1, states - 1)}
    pairs |= {(i, last) for i in range(1, states)}
    residual = set()
    while len(residual) < 3:
        s, d = (int(x) for x in rng.integers(1, last, size=2))
        if d - s not in (0, 1) and all(d - s != d2 - s2 for s2, d2 in residual):
            residual.add((s, d))
    keys = sorted(pairs | residual)
    emissions = draw((emit_num, states))
    emissions[-1] = 0.0  # the dead symbol
    starts = np.array(sorted({0, 1, int(rng.integers(2, last))}), dtype=np.int64)
    hmm = HMM(
        states_num=states,
        emit_num=emit_num,
        trans_rows=np.array([k[0] for k in keys], np.int64),
        trans_cols=np.array([k[1] for k in keys], np.int64),
        trans_probs=to_modified_prob_np(draw(len(keys))),
        emissions=np.ascontiguousarray(to_modified_prob_np(emissions), dtype=MOD_PROB_DTYPE),
        start_probabilities_cols=starts,
        start_probabilities=to_modified_prob_np(rng.choice(levels[:3], size=len(starts))),
    )
    hmm.validate()
    return hmm


def generate_banded_hmm(
    n: int = 256, offsets: tuple[int, ...] = (1,), emit_num: int = 4, seed: int = 0
) -> HMM:
    """Seeded banded HMM: transitions only along the diagonals ``offsets``
    (state ``i`` → ``i + d``), the operator class of the state-sharded
    decode. Draws the same numbers in the same order as the JAX package's
    test model (``tests/test_fused_tp.py::banded_hmm``), so both packages
    decode the identical HMM."""
    rng = np.random.default_rng(seed)
    rows, cols, probs = [], [], []
    for d in offsets:
        src = np.arange(max(0, -d), n - max(0, d))
        rows.append(src)
        cols.append(src + d)
        probs.append(rng.uniform(0.05, 1.0, size=src.shape[0]))
    hmm = HMM(
        states_num=n,
        emit_num=emit_num,
        trans_rows=np.concatenate(rows).astype(np.int64),
        trans_cols=np.concatenate(cols).astype(np.int64),
        trans_probs=to_modified_prob_np(np.concatenate(probs)),
        emissions=to_modified_prob_np(rng.uniform(0.05, 1.0, size=(emit_num, n))),
        start_probabilities_cols=np.arange(8, dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.full(8, 1 / 8)),
    )
    hmm.validate()
    return hmm


def generate_tie_heavy_banded_hmm(
    n: int = 256, offsets: tuple[int, ...] = (-1, 1), emit_num: int = 4, seed: int = 0
) -> HMM:
    """Seeded banded HMM on which equal-cost paths are common.

    Test and smoke data for the path tie rule of the state-sharded decode.
    The diagonals of :func:`generate_banded_hmm`, with every probability
    drawn from {1, 0.5, 0.25}, so every transition costs -0.0, 1 or 2;
    emissions from {1, 0.5, 0.25, 0}, and the last symbol is dead (no
    state emits it), so a sequence through it drives every score to +inf.
    """
    rng = np.random.default_rng(seed)
    levels = np.array([1.0, 0.5, 0.25, 0.0])
    base = generate_banded_hmm(n, offsets, emit_num, seed)
    emissions = rng.choice(levels, size=(emit_num, n), p=[0.35, 0.3, 0.25, 0.1])
    emissions[-1] = 0.0  # the dead symbol
    base.trans_probs = to_modified_prob_np(rng.choice(levels[:3], size=base.trans_num))
    base.emissions = np.ascontiguousarray(to_modified_prob_np(emissions), dtype=MOD_PROB_DTYPE)
    base.validate()
    return base
