"""Headline benchmark: decoded observation symbols/s on one card at 2,407
states, as one JSON line.

The counterpart of the JAX package's root ``bench.py`` (its keys, its
workload, its median of ``BENCH_RUNS`` after a warm-up):

- **structured** (the value): ``N_BATCHES`` pre-staged uniform batches of
  ``LANES`` lanes × ``T_LEN`` symbols, rolled copies of the workload
  sequences (every lane a real workload sequence, distinct data in every
  lane and batch), through ``ViterbiDecoder(mode="structured")``
  ``prepare_batch`` / ``run_batch``, every batch enqueued back to back
  and one synchronize at the end;
- **dense** (``vs_baseline``'s denominator): the workload sequences as
  one batch through ``ViterbiDecoder(mode="dense")``, at its own
  occupancy. ``vs_baseline`` is therefore a workload-level serving
  comparison, not a same-shape kernel ratio (``baseline_mode``);
- ``us_per_step``: wall µs a ``LANES``-lane step of the structured run,
  against ``floor_us_per_step``, the ``empty`` probe's µs a step at the
  same carries (``n`` states × ``LANES`` lanes, one CTA a lane), measured
  on the card in the same process; ``floor_utilization`` = floor /
  measured.

Before any timing, structured and dense final scores must be bit-equal
(both are exact f32), twice: for the workload sequences, and for the
first lanes of the first timed batch, run through the timed
``run_batch`` call itself (the ``LANES``-lane launch shape, which the
workload's own batch does not take). A number from a wrong decode is
refused. Any failure raises.

Inputs: a ``.chmm`` model and an ``.ess`` workload, or, without them,
``generate_profile_hmm(2405)`` (the corpus-shaped stand-in, 2,407 states)
and 50 seeded sequences of 3,500 symbols. Nothing is downloaded.
"""

from __future__ import annotations

import numpy as np
import torch

from spec_viterbi_tpu_torch.bench.harness import block_output, get_median, get_sorted_run_times
from spec_viterbi_tpu_torch.io import generate_profile_hmm, read_emit_seq, read_hmm
from spec_viterbi_tpu_torch.models.decoder import ViterbiDecoder, resolve_device

METRIC = "decoded_obs_symbols_per_s_per_chip_2405"
BENCH_RUNS = 5
T_LEN = 3500
LANES = 512
N_BATCHES = 16
STATES_MATCH = 2405  # + the N and C states: 2,407, the largest corpus model
WORK_SEQS = 50


def load_inputs(chmm: str | None, ess: str | None, seed: int):
    """(hmm, workload sequences, a name for each) from the paths, or the
    seeded stand-ins where a path is not given."""
    if chmm:
        hmm, model = read_hmm(chmm), chmm
    else:
        hmm = generate_profile_hmm(STATES_MATCH, seed=seed)
        model = f"generate_profile_hmm({STATES_MATCH}, seed={seed})"
    if ess:
        seqs, work = read_emit_seq(ess), ess
    else:
        rng = np.random.default_rng(seed)
        seqs = [rng.integers(0, hmm.emit_num, size=T_LEN).astype(np.int32) for _ in range(WORK_SEQS)]
        work = f"{WORK_SEQS} seeded sequences of {T_LEN} symbols (seed {seed})"
    return hmm, seqs, model, work


def packed_work(seqs, lanes: int, n_batches: int, t_len: int) -> list[list[np.ndarray]]:
    """``n_batches`` × ``lanes`` sequences of at most ``t_len`` symbols:
    rolled copies of the workload (``bench.py``'s ``_packed_work``)."""
    base = [np.asarray(s[:t_len], dtype=np.int32) for s in seqs]
    return [
        [np.roll(base[i % len(base)], (j * 131 + i * 7) % t_len) for i in range(lanes)]
        for j in range(n_batches)
    ]


def median_seconds(fn, runs: int) -> float:
    """Median wall seconds of ``runs`` calls after one warm-up; ``fn``
    ends in a synchronize of its device."""
    fn()
    return get_median(get_sorted_run_times(fn, runs)) / 1e3


def run(
    hmm,
    seqs: list[np.ndarray],
    *,
    device: torch.device | str,
    model: str,
    lanes: int = LANES,
    n_batches: int = N_BATCHES,
    t_len: int = T_LEN,
    runs: int = BENCH_RUNS,
    seed: int = 0,
) -> dict:
    """The headline's JSON object for ``hmm`` and the workload ``seqs``."""
    device = resolve_device(device)
    dec = ViterbiDecoder(hmm, mode="structured", device=device)
    dec_d = ViterbiDecoder(hmm, mode="dense", device=device)
    handle_d = dec_d.prepare_batch(seqs)

    n = hmm.states_num
    dense_scores = dec_d.run_batch(handle_d)[: len(seqs), :n].cpu().numpy()
    struct_scores = dec.decode_batch(seqs)
    if not all(np.array_equal(s, d) for s, d in zip(struct_scores, dense_scores)):
        raise RuntimeError("structured and dense scores differ: refusing to time a wrong decode")

    batches = packed_work(seqs, lanes, n_batches, t_len)
    handles = [dec.prepare_batch(b) for b in batches]
    # the timed call's own shape, held against dense on its first lanes
    k = min(len(seqs), lanes)
    timed = dec.run_batch(handles[0])[:k, :n].cpu().numpy()
    dense_timed = dec_d.run_batch(dec_d.prepare_batch(batches[0][:k]))[:k, :n].cpu().numpy()
    if not np.array_equal(timed, dense_timed):
        raise RuntimeError("the timed structured batch differs from dense: refusing to time it")

    def run_structured():
        outs = [dec.run_batch(h) for h in handles]
        block_output(outs[-1])

    sec = median_seconds(run_structured, runs)
    structured = n_batches * lanes * t_len / sec
    us_per_step = sec * 1e6 / (n_batches * t_len)
    dense = sum(len(s) for s in seqs) / median_seconds(
        lambda: block_output(dec_d.run_batch(handle_d)), runs
    )
    value = max(structured, dense)

    floor = card = None
    if device.type == "cuda":
        from spec_viterbi_tpu_torch.probes.common import card_line
        from spec_viterbi_tpu_torch.probes.laneblock import empty_us_per_step

        floor = empty_us_per_step(dec.dev.padded, lanes, t_len - 1, seed, device)
        card = card_line()
    return {
        "metric": METRIC,
        "value": value,
        "unit": "symbols/s",
        "vs_baseline": value / dense,
        "baseline_mode": f"dense {len(seqs)}-sequence batch at its own occupancy (a "
        "workload-level serving comparison, not a same-shape kernel ratio)",
        "us_per_step": us_per_step,
        "floor_us_per_step": floor,
        "floor_utilization": floor / us_per_step if floor is not None else None,
        "device": card or str(device),
        "model": model,
    }
