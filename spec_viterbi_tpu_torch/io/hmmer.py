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

import dataclasses
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


# ---- the full Plan7 profile ------------------------------------------------

# The seven transitions of a Plan7 node, in the order of a HMMER3 file's
# transition lines (``p7_hmm.h``: p7H_MM ... p7H_DD).
PLAN7_TRANSITIONS = ("mm", "mi", "md", "im", "ii", "dm", "dd")


@dataclasses.dataclass(frozen=True)
class Plan7Profile:
    """A Plan7 profile of ``L`` nodes in probability space, with the
    special states configured for local alignment.

    - ``match_emissions`` [L, K] and ``insert_emissions`` [L-1, K]: node
      ``k``'s row at index ``k - 1`` (node ``L`` has no insert state);
    - ``trans`` [L-1, 7]: node ``k``'s transitions out of Mk, Ik and Dk, in
      :data:`PLAN7_TRANSITIONS` order (node ``L``'s lead only to E);
    - ``entry`` [L]: N → Mk; ``exit_n``/``exit_c`` [L]: Mk → N and Mk → C,
      the E state folded away (J merged into N, as the MSV model has it);
    - ``n_loop``/``c_loop``: the N and C self-loops; ``n_emissions`` and
      ``c_emissions`` [K]: what N and C emit.
    """

    match_emissions: np.ndarray
    insert_emissions: np.ndarray
    trans: np.ndarray
    entry: np.ndarray
    exit_n: np.ndarray
    exit_c: np.ndarray
    n_loop: float
    c_loop: float
    n_emissions: np.ndarray
    c_emissions: np.ndarray

    @property
    def length(self) -> int:
        return int(self.match_emissions.shape[0])


def _neg_ln_probs(tokens: list[str]) -> list[float]:
    """``e^(−x)`` of HMMER's neg-ln tokens; ``*`` is probability 0."""
    return [0.0 if t == "*" else math.exp(-float(t)) for t in tokens]


def read_hmmer_plan7(path: str | os.PathLike) -> Plan7Profile:
    """Parse every node of a HMMER3 protein profile: match and insert
    emissions and the seven transitions.

    The special states take the MSV converter's local-mode values
    (:func:`hmmer_to_hmm`): N loops with ``1 − 3/(L+3)`` and enters each
    match state with ``3/(L+3) · 2/(L(L+1))``, every match state exits to
    N and to C with 0.5 each, C loops like N, and N and C emit the
    background frequencies. Node 0 (B → M1, B → I0, B → D1) is not read:
    local entries go straight to the match states.
    """
    with open(os.fspath(path)) as f:
        lines = [line.split() for line in f]
    length = next((int(t[1]) for t in lines if t and t[0] == "LENG"), 0)
    if length < 2:
        raise ValueError(f"{path}: missing LENG, or fewer than 2 nodes")
    try:
        at = next(i for i, t in enumerate(lines) if t and t[0] == "HMM")
    except StopIteration:
        raise ValueError(f"{path}: no HMM line (not a HMMER3 profile?)") from None
    alphabet = len(lines[at]) - 1
    if alphabet != NUM_AMINO_ACIDS:
        raise ValueError(f"{path}: {alphabet} symbols; only amino profiles are read")
    at += 2  # past the transition names
    if at < len(lines) and lines[at] and lines[at][0] == "COMPO":
        at += 1
    at += 2  # node 0: insert emissions, B transitions
    match, insert, trans = [], [], []
    while at + 2 < len(lines) and lines[at] != ["//"]:
        node, ins, tr = lines[at], lines[at + 1], lines[at + 2]
        if int(node[0]) != len(match) + 1:
            raise ValueError(f"{path}: node {node[0]} out of order")
        match.append(_neg_ln_probs(node[1 : alphabet + 1]))
        insert.append(_neg_ln_probs(ins[:alphabet]))
        trans.append(_neg_ln_probs(tr[:7]))
        at += 3
    if len(match) != length:
        raise ValueError(f"{path}: LENG {length} but parsed {len(match)} nodes")
    move = 3.0 / (length + 3)
    background = np.asarray(BACKGROUND_FREQUENCIES, dtype=np.float64)
    return Plan7Profile(
        match_emissions=np.asarray(match),
        insert_emissions=np.asarray(insert[:-1]),
        trans=np.asarray(trans[:-1]),
        entry=np.full(length, move * 2.0 / (length * (length + 1))),
        exit_n=np.full(length, 0.5),
        exit_c=np.full(length, 0.5),
        n_loop=1.0 - move,
        c_loop=1.0 - move,
        n_emissions=background,
        c_emissions=background.copy(),
    )


def _cost64(p) -> np.ndarray:
    """``−log2(p)`` in float64, ``+inf`` where ``p`` is 0."""
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return -np.log2(p)


def plan7_to_hmm(profile: Plan7Profile) -> HMM:
    """The emitting-state HMM of a local-mode Plan7 profile.

    States ``[N, M1..ML, I1..I(L-1), C]`` (``2L + 1``); only N starts.
    Transitions: the N loop and N → Mk; Mk → Mk+1, Mk → Ik, Ik → Mk+1,
    Ik → Ik; Mk → N and Mk → C (the E state folded, as the MSV model
    folds it); the C loop; and the delete states folded away: every chain
    Mk → Dk+1 → … → Dj-1 → Mj (``j ≥ k + 2``) becomes one transition
    Mk → Mj costing ``MD(k) + DD(k+1) + … + DD(j-2) + DM(j-1)``, summed in
    float64 from the −log2 values, in that order, and rounded to float32
    once. Every other cost is rounded once from its float64 −log2.

    Local mode: there is no B → D entry and no D → E exit (HMMER3's wing
    retraction routes them through match states), so D1 and DL carry no
    path and every path through deletes starts and ends at match states.
    A folded chain is the only way from Mk to Mj, so Viterbi over this
    model scores every sequence as the Plan7 recurrence does. Transitions
    of probability 0 are left out.
    """
    big_l = profile.length
    if big_l < 2:
        raise ValueError("a Plan7 profile needs at least 2 nodes")
    states = 2 * big_l + 1
    c_state = states - 1
    match = np.arange(1, big_l + 1, dtype=np.int64)
    node = match[:-1]  # nodes 1..L-1, the ones with an insert state
    insert = big_l + node
    cost = {name: _cost64(profile.trans[:, i]) for i, name in enumerate(PLAN7_TRANSITIONS)}

    # the folded chains: pair (k, j) at a = k - 1, m = j - k - 2 (a + m ≤
    # L - 3); chain[a, m] = MD(k) + DD(k+1) + … + DD(k+m), accumulated left
    # to right, and the pair's cost chain[a, m] + DM(j-1)
    width = big_l - 2
    a, m = np.nonzero(np.add.outer(np.arange(width), np.arange(width)) < width)
    chain = np.zeros((width, max(width, 1)))
    chain[:, 0] = cost["md"][:width]
    tail = m >= 1
    chain[a[tail], m[tail]] = cost["dd"][a[tail] + m[tail]]
    chain = np.cumsum(chain, axis=1)
    fold_k = a + 1
    fold_j = fold_k + m + 2
    fold_cost = chain[a, m] + cost["dm"][fold_j - 2]

    src = np.concatenate([
        [0], np.zeros(big_l, np.int64),  # N loop, entries
        node, node, insert, insert,      # MM, MI, IM, II
        match, match,                    # Mk → N, Mk → C
        [c_state],                       # C loop
        fold_k,                          # the delete chains
    ])
    dst = np.concatenate([
        [0], match,
        node + 1, insert, node + 1, insert,
        np.zeros(big_l, np.int64), np.full(big_l, c_state),
        [c_state],
        fold_j,
    ])
    cost64 = np.concatenate([
        _cost64([profile.n_loop]), _cost64(profile.entry),
        cost["mm"], cost["mi"], cost["im"], cost["ii"],
        _cost64(profile.exit_n), _cost64(profile.exit_c),
        _cost64([profile.c_loop]),
        fold_cost,
    ])
    finite = np.isfinite(cost64)
    emissions = np.concatenate([
        profile.n_emissions[None], profile.match_emissions, profile.insert_emissions,
        profile.c_emissions[None],
    ])  # [states, K]
    hmm = HMM(
        states_num=states,
        emit_num=emissions.shape[1],
        trans_rows=src[finite],
        trans_cols=dst[finite],
        trans_probs=cost64[finite].astype(np.float32),
        emissions=np.ascontiguousarray(to_modified_prob_np(emissions.T)),
        start_probabilities_cols=np.array([0], dtype=np.int64),
        start_probabilities=to_modified_prob_np(np.array([1.0])),
    )
    hmm.validate()
    return hmm
