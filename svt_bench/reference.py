"""The plain reference: the Viterbi recurrence over a sparse model, in plain
PyTorch, independent of the program.

In −log2 space with ``+inf`` as the semiring zero::

    v₀[j] = em[o₀][j] + π[j]
    vₜ[j] = em[oₜ][j] + min_i (vₜ₋₁[i] + A[i, j])

each candidate ``vₜ₋₁[i] + A[i, j]`` one add in the working precision, the
emission add another, as the numpy oracle forms them. A lane stops at its
own length. Paths keep, for every step and state, the lowest source that
reaches the minimum; a state whose minimum is ``+inf`` points to 0. The
last state is the lowest that holds the final minimum, and the walk goes
back through the pointers.

It reads only the model's arrays (``structures/``) and the symbols the
benchmark made, works on whatever device it is given, in blocks of lanes,
and imports nothing of the program. ``dtype`` is the working precision:
float32 is the configuration's; the control passes bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch


class Model:
    """The model's arrays on ``device`` in ``dtype``: duplicate transitions
    taken at their minimum, the edges sorted by (destination, source)."""

    def __init__(self, arrays: dict, device, dtype=torch.float32):
        n = int(arrays["states"])
        src = np.asarray(arrays["src"], np.int64)
        dst = np.asarray(arrays["dst"], np.int64)
        cost = np.asarray(arrays["cost"], np.float32)
        keep = np.isfinite(cost)
        key = dst[keep] * n + src[keep]
        uniq, inv = np.unique(key, return_inverse=True)
        best = np.full(uniq.shape, np.inf, np.float32)
        np.minimum.at(best, inv, cost[keep])
        pi = np.full(n, np.inf, np.float32)
        np.minimum.at(pi, np.asarray(arrays["start_states"], np.int64),
                      np.asarray(arrays["start_cost"], np.float32))
        self.n = n
        self.device = torch.device(device)
        self.dtype = dtype
        self.src = torch.as_tensor(uniq % n, device=self.device)
        self.dst = torch.as_tensor(uniq // n, device=self.device)
        self.cost = torch.as_tensor(best, device=self.device).to(dtype)
        self.em = torch.as_tensor(np.asarray(arrays["emissions"], np.float32),
                                  device=self.device).to(dtype)  # [E, n]
        self.pi = torch.as_tensor(pi, device=self.device).to(dtype)


def _block(model: Model, seqs: list[np.ndarray], paths: bool):
    """Scores [B, n] (float32) and, with ``paths``, the paths [B, T] int64
    (each lane's first ``len`` entries) of one block of lanes."""
    dev, n = model.device, model.n
    b = len(seqs)
    lengths = np.array([len(s) for s in seqs], np.int64)
    t_max = int(lengths.max())
    sym = np.zeros((b, t_max), np.int64)
    for i, s in enumerate(seqs):
        sym[i, : len(s)] = s
    sym = torch.as_tensor(sym, device=dev)
    len_t = torch.as_tensor(lengths, device=dev)
    m = model.src.numel()
    src_b = model.src.expand(b, m)
    dst_b = model.dst.expand(b, m)
    inf = torch.full((b, n), float("inf"), dtype=model.dtype, device=dev)
    v = model.em[sym[:, 0]] + model.pi  # [B, n]
    ptrs = (torch.zeros((max(t_max - 1, 1), b, n), dtype=torch.int16 if n <= 32767
                        else torch.int32, device=dev) if paths else None)
    for t in range(1, t_max):
        cand = v[:, model.src] + model.cost  # [B, M]
        u = inf.scatter_reduce(1, dst_b, cand, "amin", include_self=True)
        if paths:
            hit = (cand == u[:, model.dst]) & torch.isfinite(cand)
            who = torch.where(hit, src_b, n)
            arg = torch.full((b, n), n, dtype=torch.int64, device=dev)
            arg = arg.scatter_reduce(1, dst_b, who, "amin", include_self=True)
            ptrs[t - 1] = torch.where(arg == n, 0, arg).to(ptrs.dtype)
        live = (t < len_t)[:, None]
        v = torch.where(live, model.em[sym[:, t]] + u, v)
    scores = v.float()
    if not paths:
        return scores, None
    lanes = torch.arange(b, device=dev)
    state = torch.argmin(scores, dim=1)  # the lowest state on a tie
    out = torch.zeros((b, t_max), dtype=torch.int64, device=dev)
    out[lanes, len_t - 1] = state
    for t in range(t_max - 1, 0, -1):
        prev = ptrs[t - 1][lanes, state].long()
        live = t < len_t  # step t exists in this lane: state at t-1 from it
        state = torch.where(live, prev, state)
        out[:, t - 1] = torch.where(live, state, out[:, t - 1])
    return scores, out


def decode(model: Model, seqs: list[np.ndarray], paths: bool = False,
           block: int = 256) -> list:
    """``[scores]`` or ``[(scores, path)]`` per sequence, as numpy arrays
    (scores float32 [n], path int64 [len]), in blocks of ``block`` lanes."""
    out = []
    for i in range(0, len(seqs), block):
        part = seqs[i : i + block]
        with torch.no_grad():
            scores, walk = _block(model, part, paths)
        scores = scores.cpu().numpy()
        if not paths:
            out += [scores[j] for j in range(len(part))]
            continue
        walk = walk.cpu().numpy()
        out += [(scores[j], walk[j, : len(part[j])]) for j in range(len(part))]
    return out
