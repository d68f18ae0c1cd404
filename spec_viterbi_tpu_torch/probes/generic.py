"""Times of the generic arms of the masked scores and path kernels.

``svt_scores_masked`` and ``svt_path`` in their generic arm (the tables
``FusedStructuredDecoder._masked``) at the main path's shape, 512 lanes x
3,500 symbols (3,499 steps), uniform (unmasked, as a uniform
``decode_batch`` of a model outside the plans runs them) and over the
ragged set's buckets (masked, one launch a bucket), on three models:

- ``tie_heavy``: ``generate_tie_heavy_hmm`` at the corpus stand-in's 2,405
  match states (one diagonal, one dense row and column, three residual
  entries), whose decoder takes the generic arms;
- ``banded``: ``generate_banded_hmm(2432, offsets=(1, 3))``, the
  state-sharded decode's model, decoded whole (two diagonals);
- ``stand_in``: the corpus stand-in (``generate_profile_hmm``), whose
  decoder takes the planned arms; its generic arm forced, as the ``rank``
  line of ``chip_smoke.py`` times it.

It times the kernels of whichever ``spec_viterbi_tpu_torch`` comes first
on ``sys.path``, so two trees compare in one call: run this file by path
with ``PYTHONPATH`` set to each tree in turn (parent, change, change,
parent)::

    PYTHONPATH=<tree> python3 spec_viterbi_tpu_torch/probes/generic.py --tag NAME

One JSON line a model, naming the card: ms and µs a step of each arm
(median of 5 CUDA-event timings), each with its bound from the model's own
generic count (``bounds.operator_step(..., planned=False)``), the buckets'
sums and each bucket's times, fingerprints of the scores and pointers (to
hold two trees' outputs equal), and the shape each launch takes where the
tree reports it. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

STATES_MATCH, LANES, T_LEN = 2405, 512, 3500
BANDED_STATES, BANDED_OFFSETS, BANDED_SYMBOLS = 2432, (1, 3), 4


def _fingerprint(x: torch.Tensor, chunk: int = 1 << 26) -> list[int]:
    """Two int64 sums of a tensor's bits, plain and position-weighted,
    taken in chunks (a pointer tensor holds gigabytes)."""
    flat = x.contiguous().view(-1)
    plain = weighted = 0
    for s in range(0, flat.numel(), chunk):
        part = flat[s : s + chunk]
        bits = (part.view(torch.int32) if part.dtype == torch.float32 else part.to(torch.int32)).long()
        w = (torch.arange(s, s + part.numel(), device=x.device) % 9973)
        plain += int(bits.sum())
        weighted += int((bits * w).sum())
    return [plain, weighted]


def _models(seed: int):
    from spec_viterbi_tpu_torch.io import (
        generate_banded_hmm,
        generate_profile_hmm,
        generate_tie_heavy_hmm,
    )

    return {
        "tie_heavy": generate_tie_heavy_hmm(STATES_MATCH, seed=seed),
        "banded": generate_banded_hmm(BANDED_STATES, offsets=BANDED_OFFSETS, emit_num=BANDED_SYMBOLS,
                                      seed=seed),
        "stand_in": generate_profile_hmm(STATES_MATCH, seed=seed),
    }


def lengths_of(seed: int) -> np.ndarray:
    """The ragged set's lengths, as ``chip_smoke.py`` draws them."""
    rng = np.random.default_rng(seed)
    lengths = np.exp(rng.uniform(np.log(200), np.log(T_LEN), size=LANES)).astype(int)
    lengths[:2] = (200, T_LEN)
    return lengths


def run_model(name: str, hmm, seed: int, card: str, tag: str) -> dict:
    from spec_viterbi_tpu_torch import ViterbiDecoder
    from spec_viterbi_tpu_torch.ops import fused
    from spec_viterbi_tpu_torch.probes import bounds
    from spec_viterbi_tpu_torch.probes.common import median_ms
    from spec_viterbi_tpu_torch.utils.batching import bucket_plan

    dec = ViterbiDecoder(hmm, mode="structured", device="cuda")
    fd = dec._fused
    t = fd._masked
    sop = fd.sop
    live = hmm.emit_num - 1 if name == "tie_heavy" else hmm.emit_num  # the tie-heavy last symbol is dead
    op = bounds.operator_step(sop.n, len(sop.diag_offsets), len(sop.row_idx), len(sop.col_idx),
                              planned=False)
    rng = np.random.default_rng(seed + 7)
    shape = getattr(fused, "generic_shape", None)

    def one(seqs, t_pad, lengths):
        st, ln, masked = fd.prepare(seqs, t_pad=t_pad)
        v0 = (fd.em_t[:, st[0].long()] + fd.pi[:, None]).contiguous()
        obs = st[1:]
        lens = ln if lengths else None
        steps, lanes = obs.shape
        lane_steps = int((ln.long() - 1).clamp(0, steps).sum()) if lengths else lanes * steps
        s_ms = median_ms(lambda: fused.scores_masked(t, fd.em, v0, obs, lens))
        p_ms = median_ms(lambda: fused.path(t, fd.em, v0, obs, lens))
        scores = fused.scores_masked(t, fd.em, v0, obs, lens)
        out, src = fused.path(t, fd.em, v0, obs, lens)
        torch.cuda.synchronize()
        row = {
            "lanes": lanes, "steps": steps, "lane_steps": lane_steps,
            "scores_ms": s_ms, "scores_us_per_step": s_ms * 1e3 / steps,
            "scores_bound_ms": bounds.masked_scores(op, lanes, steps, lane_steps, hmm.emit_num,
                                                    lengths).bound()[0],
            "path_ms": p_ms, "path_us_per_step": p_ms * 1e3 / steps,
            "path_bound_ms": bounds.path(op, lanes, steps, lane_steps, hmm.emit_num, lengths).bound()[0],
            "path_carry_equals_scores": bool(torch.equal(out, scores)),
            "fingerprint": _fingerprint(scores) + _fingerprint(src),
        }
        if shape is not None:
            row["scores_shape"] = shape(t, lanes, fd.device)
            row["path_shape"] = shape(t, lanes, fd.device, path=True)
        del out, src
        torch.cuda.empty_cache()
        return row

    uniform = [rng.integers(0, live, size=T_LEN).astype(np.int32) for _ in range(LANES)]
    ragged = [rng.integers(0, live, size=int(x)).astype(np.int32) for x in lengths_of(seed)]
    u = one(uniform, T_LEN, False)
    plan = bucket_plan([len(s) for s in ragged], lane_block=fused.BB)
    buckets = [one([ragged[i] for i in idx], t_q, True) for idx, t_q in plan]
    line = {
        "tag": tag, "card": card, "model": name, "states": hmm.states_num, "n": sop.n,
        "diagonals": list(sop.diag_offsets), "dense_rows": len(sop.row_idx),
        "dense_cols": len(sop.col_idx), "residual": sop.residual_nnz,
        "generic_arm_on_main_path": fd._scores_arm is t,
        "uniform": u,
        "ragged_scores_ms": sum(b["scores_ms"] for b in buckets),
        "ragged_scores_bound_ms": sum(b["scores_bound_ms"] for b in buckets),
        "ragged_path_ms": sum(b["path_ms"] for b in buckets),
        "ragged_path_bound_ms": sum(b["path_bound_ms"] for b in buckets),
        "buckets": buckets,
    }
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--models", nargs="*", default=["tie_heavy", "banded", "stand_in"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("generic: no CUDA device", file=sys.stderr)
        return 1
    from spec_viterbi_tpu_torch.probes.common import card_line

    card = card_line()
    models = _models(args.seed)
    for name in args.models:
        run_model(name, models[name], args.seed, card, args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
