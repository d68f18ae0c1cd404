"""The full Plan7 profile structure (match, insert and delete states) in
local mode, with seeded values, its delete chains folded into transitions.

A frozen copy of ``spec_viterbi_tpu_torch/io/generators.py``'s
``generate_plan7_profile`` and of ``io/hmmer.py``'s ``plan7_to_hmm``, so
that a later change to the program cannot change the data the benchmark
decodes. It returns plain numpy arrays with the keys of
``msv_profile.build``; :func:`profile` returns the unfolded parameters,
which ``plan7_reference.py`` decodes.

``L`` nodes, each with a match state Mk, an insert state Ik (but node L)
and a silent delete state Dk, the seven transitions MM, MI, MD, IM, II,
DM, DD a node (HMMER's ``p7_hmm.h``), and the special states of
``msv_profile.py``: N (state 0) loops with ``1 − 3/(L+3)`` and enters every
match state with ``2/(L(L+1))``; every match state exits to N and to C
with 0.5 (E folded, J merged into N), but one seeded exit to C; C loops
like N; only N starts. Local mode has no B → D entry and no D → E exit.

The emitting states are ``[N, M1..ML, I1..I(L-1), C]``; every chain
Mk → Dk+1 → … → Dj-1 → Mj (``j ≥ k + 2``) becomes the transition Mk → Mj
costing ``MD(k) + DD(k+1) + … + DD(j-2) + DM(j-1)``, summed in float64
from the −log2 values, left to right, and rounded to float32 once. That is
``2L + 1`` states and ``(L-2)(L-1)/2 + 7L - 2`` transitions: 1,001 and
127,749 at ``L = 500``.

Seeded values: MM/MI/MD a Dirichlet(90, 5, 5) draw a node, IM/II and
DM/DD Dirichlet(7, 3) draws; every emission row (match, insert, N, C) a
Dirichlet(1) draw over the alphabet.
"""

from __future__ import annotations

import numpy as np

TRANSITIONS = ("mm", "mi", "md", "im", "ii", "dm", "dd")


def to_cost(p: np.ndarray) -> np.ndarray:
    """``−log2(p)`` as float32, ``+inf`` where ``p`` is 0."""
    p = np.asarray(p, dtype=np.float64)
    out = np.full(p.shape, np.inf, dtype=np.float32)
    pos = p > 0.0
    out[pos] = (-np.log2(p[pos])).astype(np.float32)
    return out


def cost64(p) -> np.ndarray:
    """``−log2(p)`` in float64, ``+inf`` where ``p`` is 0."""
    p = np.asarray(p, dtype=np.float64)
    with np.errstate(divide="ignore"):
        return -np.log2(p)


def profile(config: dict, seed: int) -> dict:
    """The unfolded parameters, in probability space: ``match_emissions``
    [L, K], ``insert_emissions`` [L-1, K], ``trans`` [L-1, 7] (node k's
    row at k - 1, in ``TRANSITIONS`` order), ``entry``, ``exit_n``,
    ``exit_c`` [L], ``n_loop``, ``c_loop``, ``n_emissions``,
    ``c_emissions`` [K]."""
    big_l = int(config["match_states"])
    emit_num = int(config["symbols"])
    if big_l < 2:
        raise ValueError("a Plan7 profile needs at least 2 nodes")
    rng = np.random.default_rng(seed)
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
    return {
        "match_emissions": match,
        "insert_emissions": insert,
        "trans": trans,
        "entry": np.full(big_l, 2.0 / (big_l * (big_l + 1))),
        "exit_n": np.full(big_l, 0.5),
        "exit_c": exit_c,
        "n_loop": loop,
        "c_loop": loop,
        "n_emissions": n_em,
        "c_emissions": c_em,
    }


def fold(params: dict) -> dict:
    """The emitting-state model of :func:`profile`'s parameters, as
    ``msv_profile.build`` returns one."""
    big_l = params["match_emissions"].shape[0]
    states = 2 * big_l + 1
    c_state = states - 1
    match = np.arange(1, big_l + 1, dtype=np.int64)
    node = match[:-1]
    insert = big_l + node
    cost = {name: cost64(params["trans"][:, i]) for i, name in enumerate(TRANSITIONS)}

    # pair (k, j) at a = k - 1, m = j - k - 2; chain[a, m] = MD(k) + DD(k+1)
    # + … + DD(k+m), accumulated left to right
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
        [0], np.zeros(big_l, np.int64),
        node, node, insert, insert,
        match, match,
        [c_state],
        fold_k,
    ])
    dst = np.concatenate([
        [0], match,
        node + 1, insert, node + 1, insert,
        np.zeros(big_l, np.int64), np.full(big_l, c_state),
        [c_state],
        fold_j,
    ])
    all_cost = np.concatenate([
        cost64([params["n_loop"]]), cost64(params["entry"]),
        cost["mm"], cost["mi"], cost["im"], cost["ii"],
        cost64(params["exit_n"]), cost64(params["exit_c"]),
        cost64([params["c_loop"]]),
        fold_cost,
    ])
    finite = np.isfinite(all_cost)
    emissions = np.concatenate([
        params["n_emissions"][None], params["match_emissions"], params["insert_emissions"],
        params["c_emissions"][None],
    ])  # [states, K]
    return {
        "states": states,
        "symbols": int(emissions.shape[1]),
        "src": src[finite].astype(np.int64),
        "dst": dst[finite].astype(np.int64),
        "cost": all_cost[finite].astype(np.float32),
        "emissions": np.ascontiguousarray(to_cost(emissions.T)),
        "start_states": np.array([0], dtype=np.int64),
        "start_cost": to_cost(np.array([1.0])),
    }


def build(config: dict, seed: int) -> dict:
    """The model's arrays: ``states``, ``symbols``, COO transitions
    ``src``/``dst``/``cost`` (−log2, float32), ``emissions`` [symbols,
    states] and the sparse start ``start_states``/``start_cost``."""
    return fold(profile(config, seed))
