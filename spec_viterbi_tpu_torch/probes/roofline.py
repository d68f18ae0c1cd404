"""S1: the roofline probes of ``scripts/exp_roofline.py``, on the H100.

- stage 1: the marginal cost of one pass of each primitive class at the
  production shape ([2,432, 512] carry, 3,488 steps): P passes a step,
  the least-squares slope of µs/step over P (``svt_probe_pass``), and the
  empty floor (carry read-modify-write and one barrier a step);
- stage 2: the speed-of-light sum for the corpus operator's step (one
  diagonal, one dense row, two dense columns): ``empty + neighbour +
  bcast + 2·colred + emission``, against the measured ``svt_scores_fs``
  and ``svt_scores_masked`` on the corpus-shaped stand-in at 512 × 3,500;
- stage 3a: bf16 operands (``svt_scores_variant`` with ``bf16_ops``),
  timed, with its drift from ``viterbi_scores_oracle`` (on the card, in
  the dense form of :func:`dense_oracle_scores`) on
  ``generate_profile_hmm(500 | 1509 | 2405)`` and the ±1.0 verdict;
- stage 3b: the composed two-symbol step (the ``twosym`` class);
- stage 3c: staged emissions (``em_staged``), timed, bit-equal to
  ``svt_scores_masked``.

The TPU's numbers in ``bench_out/roofline.json`` do not carry over: the
TPU's passes are full-width vector passes over VMEM, a CUDA step is a
loop of 256 threads over the carry in shared memory.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.ops import fused, probes
from spec_viterbi_tpu_torch.probes.common import (
    LANES,
    N_STATES,
    STATES_MATCH,
    T_LEN,
    T_SUB,
    CorpusBatch,
    PassInputs,
    Record,
    fit_slope,
    median_ms,
)

STAGE1 = (
    ("stream", (1, 4, 8, 12)),
    ("neighbour", (1, 4, 8)),
    ("colred", (1, 4, 8)),
    ("bcast", (1, 4, 8)),
    ("emission", (1, 2, 4)),
)
DRIFT_MODELS = (500, 1509, 2405)
DRIFT_LANES = 4
CONTRACT = 1.0  # ±1.0 in −log2 space (almost_equal_vec)


def time_pass(inp: PassInputs, cls: str, p: int) -> float:
    """µs per step of ``probe_pass`` over all of ``inp``'s steps."""
    steps = inp.obs.shape[0]
    obs = inp.obs if cls in ("emission", "twosym") else None
    tab = inp.tabs if cls == "twosym" else inp.em
    return median_ms(lambda: probes.probe_pass(cls, inp.v0, steps, obs=obs, cols=inp.cols,
                                               bufs=inp.bufs, tab=tab, p=p)) * 1e3 / steps


def stage1(rec: Record, inp: PassInputs) -> dict:
    slopes = {}
    for cls, ps in STAGE1:
        ts = [time_pass(inp, cls, p) for p in ps]
        for p, us in zip(ps, ts):
            rec.emit(f"micro_{cls}_p{p}", us_per_step=us)
        slopes[cls] = fit_slope(ps, ts)
        rec.emit(f"slope_{cls}", us_per_pass=slopes[cls], passes=list(ps))
    slopes["empty"] = time_pass(inp, "empty", 0)
    rec.emit("micro_empty", us_per_step=slopes["empty"])
    return slopes


def stage2(rec: Record, slopes: dict, corpus: CorpusBatch) -> dict:
    """Predicted vs measured µs/step of the production scores kernels."""
    fd = corpus.fd
    steps = corpus.obs.shape[0]
    measured = {
        "scores_fs": median_ms(lambda: fused.scores_fs(fd._fs, fd.em, corpus.v0, corpus.obs)),
        "scores_masked": median_ms(
            lambda: fused.scores_masked(fd._masked, fd.em, corpus.v0, corpus.obs, None)),
    }
    measured = {k: ms * 1e3 / steps for k, ms in measured.items()}
    predicted = (slopes["empty"] + slopes["neighbour"] + slopes["bcast"] + 2 * slopes["colred"]
                 + slopes["emission"])
    rec.emit("speed_of_light", predicted_us_per_step=predicted,
             mix="empty + neighbour + bcast + 2*colred + emission",
             **{f"{k}_us_per_step": us for k, us in measured.items()},
             **{f"{k}_measured_over_predicted": us / predicted for k, us in measured.items()},
             lanes=corpus.v0.shape[1], steps=steps)
    return measured


def dense_oracle_scores(hmm, seqs: torch.Tensor) -> torch.Tensor:
    """``viterbi_scores_oracle`` of each row of ``seqs`` [B, T] (integer,
    on any device): the same dense f32 recurrence (one add rounded once,
    exact min, +inf as zero), batched over lanes, on ``seqs``' device;
    [B, states] scores, bit-equal to the numpy oracle."""
    device = seqs.device
    a_t = torch.as_tensor(hmm.transposed_transition_matrix(), device=device)
    pi = torch.as_tensor(hmm.start_vector(), device=device)
    em = torch.as_tensor(np.asarray(hmm.emissions, np.float32), device=device)
    seqs = seqs.long()
    v = em[seqs[:, 0]] + pi[None, :]
    for t in range(1, seqs.shape[1]):
        v = em[seqs[:, t]] + (a_t[None, :, :] + v[:, None, :]).amin(dim=2)
    return v


def _variant(corpus: CorpusBatch, name: str):
    fd = corpus.fd
    return probes.VariantTables.build(fd._masked, fd.em, probes.variant_flag(name))


def stage3a(rec: Record, corpus: CorpusBatch, f32_us: float, seed: int) -> dict:
    """bf16 operands: time at the stage-2 shape, drift on three models."""
    steps = corpus.obs.shape[0]
    t = _variant(corpus, "bf16_ops")
    us = median_ms(lambda: probes.scores_variant(t, corpus.v0, corpus.obs, None)) * 1e3 / steps
    worst = 0.0
    for states in DRIFT_MODELS:
        small = CorpusBatch.make(states, DRIFT_LANES, T_LEN, seed, corpus.v0.device)
        tb = _variant(small, "bf16_ops")
        got = probes.scores_variant(tb, small.v0, small.obs, None).T[:, : small.hmm.states_num]
        ref = dense_oracle_scores(small.hmm, small.seqs.T)
        fin = torch.isfinite(ref)
        if not torch.equal(fin, torch.isfinite(got)):
            worst = float("inf")
        elif bool(fin.any()):
            worst = max(worst, float((got[fin] - ref[fin]).abs().max()))
    return rec.emit("bf16_verdict", us_per_step=us, speedup_vs_f32=f32_us / us,
                    max_abs_drift=worst if np.isfinite(worst) else "inf-mismatch",
                    within_contract=bool(worst <= CONTRACT), models=list(DRIFT_MODELS),
                    drift_lanes=DRIFT_LANES, drift_symbols=T_LEN)


def stage3b(rec: Record, inp: PassInputs, f32_us: float) -> dict:
    """The composed two-symbol step: µs per symbol (two symbols a step)."""
    us_per_symbol = time_pass(inp, "twosym", 0)
    return rec.emit("twosym_composed", us_per_symbol=us_per_symbol,
                    msym_per_s=inp.v0.shape[1] / us_per_symbol,
                    speedup_vs_f32=f32_us / us_per_symbol)


def stage3c(rec: Record, corpus: CorpusBatch, f32_us: float) -> dict:
    """Staged emission rows: time, and bit-equality with the production
    masked kernel."""
    fd = corpus.fd
    steps = corpus.obs.shape[0]
    t = _variant(corpus, "em_staged")
    us = median_ms(lambda: probes.scores_variant(t, corpus.v0, corpus.obs, None)) * 1e3 / steps
    same = torch.equal(probes.scores_variant(t, corpus.v0, corpus.obs, None),
                       fused.scores_masked(fd._masked, fd.em, corpus.v0, corpus.obs, None))
    if not same:
        raise RuntimeError("em_staged differs from svt_scores_masked")
    return rec.emit("embatch_verdict", us_per_step=us, speedup_vs_f32=f32_us / us, exact_ok=same)


def run(rec: Record, device, seed: int = 0, corpus: CorpusBatch | None = None,
        inp: PassInputs | None = None) -> dict:
    """All stages; returns the stage-1 slopes and stage-2 times."""
    inp = inp or PassInputs.make(N_STATES, LANES, T_SUB, seed, device)
    slopes = stage1(rec, inp)
    corpus = corpus or CorpusBatch.make(STATES_MATCH, LANES, T_LEN, seed, device)
    measured = stage2(rec, slopes, corpus)
    f32_us = measured["scores_masked"]
    stage3a(rec, corpus, f32_us, seed)
    stage3b(rec, inp, f32_us)
    stage3c(rec, corpus, f32_us)
    return {"slopes": slopes, "measured": measured}
