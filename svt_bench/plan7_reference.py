"""The plain Plan7 reference: the Viterbi recurrence of a local-mode Plan7
profile over explicit match, insert and delete states, in plain PyTorch and
float64, independent of the fold that turns the profile into the model the
program decodes.

It follows HMMER3's Viterbi recurrence (the HMMER User's Guide's profile
HMM; ``p7_GViterbi`` in ``generic_viterbi.c``) in −log2 space, with
``+inf`` for probability 0. For a symbol ``o`` at step ``t``::

    M[k]  = eM[k](o) + min(N' + entry[k], M'[k-1] + MM[k-1],
                           I'[k-1] + IM[k-1], D'[k-1] + DM[k-1])
    I[k]  = eI[k](o) + min(M'[k] + MI[k], I'[k] + II[k])
    N     = eN(o) + min(N' + n_loop, min_k M'[k] + exit_n[k])
    C     = eC(o) + min(C' + c_loop, min_k M'[k] + exit_c[k])
    D[k]  = min(M[k-1] + MD[k-1], D[k-1] + DD[k-1])    k = 2 .. L-1

where a prime marks the previous step. D is silent: it is filled within
the step from M of the same step, one state after another, and read by
the next step's M. At the first symbol only N is finite (N starts).

Departures from HMMER3, each as the benchmark's model has it: local mode
only, with the given entries N → Mk in place of B → Mk (no B → D entry, and
no D → E exit: wing retraction); E folded into each match state's own exits
to N and to C, J merged into N (the MSV converter's layout); N and C emit
their own rows and their loops carry their own costs; no null model, so a
score is the raw −log2 Viterbi cost and not a bit score. Node 0 and node
L's insert state are absent.

The parameters are the dict of ``structures/plan7_profile.py``'s
``profile`` (probabilities): ``match_emissions`` [L, K],
``insert_emissions`` [L-1, K], ``trans`` [L-1, 7] (MM MI MD IM II DM DD,
node k at k - 1), ``entry``, ``exit_n``, ``exit_c`` [L], ``n_loop``,
``c_loop``, ``n_emissions``, ``c_emissions`` [K]. Final scores come in the
order of the folded model's states: ``[N, M1..ML, I1..I(L-1), C]``. It
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

F32_UNIT = 2.0 ** -24  # float32's unit roundoff


def _cost(p, device) -> torch.Tensor:
    p = torch.as_tensor(np.asarray(p, dtype=np.float64), device=device)
    return torch.where(p > 0, -torch.log2(p), torch.full_like(p, float("inf")))


def decode(params: dict, seqs: list[np.ndarray], device="cpu") -> list[np.ndarray]:
    """The final scores [2L + 1] (float64) of every sequence, all lanes in
    one block."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    inf = float("inf")
    em_m = _cost(params["match_emissions"], dev)  # [L, K]
    em_i = _cost(params["insert_emissions"], dev)  # [L-1, K]
    em_n = _cost(params["n_emissions"], dev)
    em_c = _cost(params["c_emissions"], dev)
    mm, mi, md, im, ii, dm, dd = _cost(params["trans"], dev).T  # each [L-1]
    entry = _cost(params["entry"], dev)
    exit_n, exit_c = _cost(params["exit_n"], dev), _cost(params["exit_c"], dev)
    n_loop, c_loop = float(_cost([params["n_loop"]], dev)), float(_cost([params["c_loop"]], dev))
    big_l = em_m.shape[0]

    b = len(seqs)
    lengths = torch.as_tensor([len(s) for s in seqs], device=dev)
    t_max = int(lengths.max())
    sym = np.zeros((b, t_max), np.int64)
    for i, s in enumerate(seqs):
        sym[i, : len(s)] = s
    sym = torch.as_tensor(sym, device=dev)

    def full(width):
        return torch.full((b, width), inf, dtype=torch.float64, device=dev)

    n_s = em_n[sym[:, 0]]  # [B]
    c_s = torch.full((b,), inf, dtype=torch.float64, device=dev)
    m_s, i_s, d_s = full(big_l), full(big_l - 1), full(big_l)  # d_s[:, k-1] is Dk
    for t in range(1, t_max):
        o = sym[:, t]
        m_new = n_s[:, None] + entry[None, :]
        m_new[:, 1:] = torch.minimum(m_new[:, 1:], m_s[:, :-1] + mm)
        m_new[:, 1:] = torch.minimum(m_new[:, 1:], i_s + im)
        m_new[:, 1:] = torch.minimum(m_new[:, 1:], d_s[:, :-1] + dm)
        m_new = m_new + em_m[:, o].T
        i_new = torch.minimum(m_s[:, :-1] + mi, i_s + ii) + em_i[:, o].T
        n_new = torch.minimum(n_s + n_loop, (m_s + exit_n).amin(dim=1)) + em_n[o]
        c_new = torch.minimum(c_s + c_loop, (m_s + exit_c).amin(dim=1)) + em_c[o]
        d_new = full(big_l)
        for k in range(2, big_l):  # Dk from Mk-1 and Dk-1 of this step
            d_new[:, k - 1] = torch.minimum(m_new[:, k - 2] + md[k - 2],
                                            d_new[:, k - 2] + dd[k - 2])
        live = t < lengths
        m_s = torch.where(live[:, None], m_new, m_s)
        i_s = torch.where(live[:, None], i_new, i_s)
        d_s = torch.where(live[:, None], d_new, d_s)
        n_s = torch.where(live, n_new, n_s)
        c_s = torch.where(live, c_new, c_s)
    scores = torch.cat([n_s[:, None], m_s, i_s, c_s[:, None]], dim=1).cpu().numpy()
    return [scores[i] for i in range(b)]


def f32_bound(length: int, scores: np.ndarray) -> float:
    """How far a float32 decode of the folded model may lie from these
    float64 scores, for a sequence of ``length`` symbols: every cost and
    every candidate is non-negative, each step adds at most four float32
    roundings (the transition's and the emission's costs, the candidate's
    add, the emission's add), each within ``F32_UNIT`` of a value no larger
    than the step's largest score, and a min passes an error on unchanged;
    the largest score of any step is taken as twice the largest finite
    final score."""
    finite = np.asarray(scores)[np.isfinite(scores)]
    top = float(np.abs(finite).max()) if finite.size else 0.0
    return 4.0 * F32_UNIT * max(length, 1) * 2.0 * max(top, 1.0)
