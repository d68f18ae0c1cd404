#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root::

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line; any failure raises and the script
exits non-zero:

1. require a CUDA device; print its name and power limit (nvidia-smi);
2. build the kernels from ``spec_viterbi_tpu_torch/csrc`` (build seconds);
3. make a corpus-shaped model (2,407 states × 20 symbols, seeded), write
   it as ``.chmm`` and read it back with the port's ``read_hmm``;
4. make a uniform set (512 × 3,500 symbols) and a ragged set (512
   lengths over 200-3,500), write them as ``.ess`` and read them back;
5. decode through ``ViterbiDecoder(mode="structured", device="cuda")``:
   ``prepare_batch``/``run_batch`` on the uniform set (the FS kernel),
   ``decode_batch`` on the ragged set (the planned arm of the masked
   kernel, bucketed) and ``decode`` on one sequence, with the kernel launch
   counts read around that run;
6. hold each scores kernel, both arms of the masked kernel, against its
   plain PyTorch version on the card at the same shapes: bit-equal
   (``torch.equal``, +inf at the same places);
7. hold the plain path and both scores kernels against the numpy oracle on
   4 lanes × 64 symbols: bit-equal;
8. ``path_main``: ``decode_path_batch`` on both sets (the planned arm of
   the path kernel and the backtrace kernel, the uniform set in calls of
   as many lanes as the pointer budget holds, a quarter of the card's
   memory, and one per ragged bucket; the expected counts come from the
   budget) and ``decode_path`` on one sequence (the
   plain argmin scan on the card), with the launch counts read around
   that run; paths of the right length and range, scores equal to the
   scores flow's; then the uniform set again under a budget lowered to
   half of it: two lane-chunked calls, equal to the main run;
9. ``path_kernel_vs_plain``: both arms of the path kernel against their
   plain versions and each other (carry and backpointers) and the
   backtrace kernel against its plain version, at one uniform call
   (unmasked; 512 lanes where the budget holds them) and at the largest ragged bucket (masked);
10. ``path_oracle``: paths and scores against ``viterbi_path_oracle`` on a
    prefix of both sets (planned arm) and on a seeded tie-heavy model
    (generic arm): bit-equal;
11. ``stream``: the uniform set through ``dec.streaming()`` in chunks of
    999, 1,500 and 1,000 symbols (scores equal to ``run_batch``'s), then
    the ragged set through the path stream with per-lane valid counts and
    a save/load round trip in the middle (paths and scores equal to
    ``decode_path_batch``'s), the feeds and finalize on the planned arms;
    then the uniform and ragged ``decode_path_batch`` and the stream's
    finalize again, every ``svt_backtrace`` launch held to
    ``backtrace_plain`` and to the staged walk's emulation
    (``probes/emulation.py``) on its own pointer tensor, and the same for
    a TP and a DP path call (steps 16 and 19): the ``backtrace_misses``
    line, the emulation's misses a lane of each call; then ``fs_shape``,
    the shape ``svt_scores_fs`` takes at 512, 256 and 128 lanes (threads a
    lane, lanes a CTA, registers, CTAs an SM);
12. ``generic_main`` and ``generic_kernel_vs_plain``: a model outside the
    uniform plans (the seeded tie-heavy model at 2,405 states) through
    ``decode_batch`` and ``decode_path_batch`` of a ragged set, with the
    launch counts read around that run (the generic arms); both generic
    kernels against their plain versions on 512 lanes × 511 steps, and
    the decodes against the oracle on a prefix;
13. ``dense_main``: ``ViterbiDecoder(mode="dense", device="cuda")`` at the
    dense baseline's shape, the first 50 lanes of the uniform set
    (``prepare_batch``/``run_batch``), ``decode_batch`` of the first 50
    ragged sequences, ``decode`` and ``decode_path`` of one, with the
    ``svt_minplus`` and fused launch counts read around that run (no fused
    kernel); dense scores bit-equal to step 5's (the FS kernel's and the
    masked kernel's) and the dense path to lane 0 of step 8's; ``auto``
    resolving to dense on a seeded dense-class model (1,024 states, 256
    transitions a state), held to the oracle on 4 x 64;
14. ``dense_kernel_vs_plain``: ``svt_minplus`` against ``minplus_plain``
    on one full dense batch step, a 64-step prefix of ``run_batch``, the
    J = 1 argmin arm and ragged-edge shapes (both layouts, gathered):
    bit-equal;
15. ``spec_main``: ``SpecializedViterbi(level=1)`` delegating to the fused
    decoder (``svt_scores_fs``), then level 2: the slowdown warning,
    ``spec_with`` (441 products, a 10.43 GB stack; peak device memory),
    ``run_spec_batch`` of the 50 uniform and 50 ragged sequences and
    ``run_spec`` of one, within ±1.0 of the dense scores (the largest
    difference printed), 4 of the products and a 16-chunk prefix of the
    gathered decode held to the plain version; then ``svt_minplus``'s
    ``time`` lines (the dense ``run_batch``, the J = 1 step with and
    without argmin, the level-2 build, the gathered level-2 decode of 50
    x 1,749 chunks), each beside its bound and held to it (neither its
    event time nor its device time may read below it: the J = 1 lines
    take 8 copies of the operator in turn, so each launch reads it from
    HBM as the bound counts it, and give the decode loop's one reused,
    L2-resident operator beside them as ``resident_*``); the stack is
    freed;
16. ``tp_main``: the state-sharded decode of a seeded banded model (2,432
    states, offsets (1, 3), 4 symbols) on a local group of 4 shards, chunk
    16: ``FusedTPDecoder.decode_batch`` and ``decode_path_batch`` on a
    uniform (512 × 3,500) and a ragged set (the lengths of step 4), with
    the launch counts read around each call (219 window launches a call,
    one backtrace a path call); scores, paths and the global pointer
    tensor bit-equal to the unsharded kernels';
17. ``tp_kernel_vs_plain``: both window kernels against their plain
    versions on the first 4 chunks, uniform and ragged, in the local form
    and in the rank form of every shard (one window, window-local
    pointers), and ``decode_batch_emulated(check_path_kernel=True)`` on
    128 lanes;
18. ``tp_oracle``: TP paths and scores against ``viterbi_path_oracle`` on
    a prefix and on a seeded tie-heavy banded model: bit-equal;
19. ``dp``: the fused DP entry points on a world-size-1 NCCL group,
    bit-equal to the single-device decode;
20. ``tp_dist``: with two or more cards, TP on that many NCCL ranks (at
    most 4), bit-equal to the local group; with one card it says so;
21. time kernel and plain version of the window kernels (the whole TP
    decode, and kernel vs plain on the first 4 chunks, beside the
    unsharded kernels on the same model and lanes); then both window
    kernels in both launch forms through the decoder's chunk loops
    (``spec_viterbi_tpu_torch/probes/windows.py``: the local group, and one
    rank's launches on a group with no peers), each with its bound, the
    host's µs a chunk and the device's idle share; the device time of one
    launch against its steps (0 to 1,024); and an ``occupancy_*_window``
    line for each kernel;
22. ``probes``: the H100 probes (``spec_viterbi_tpu_torch.probes``) on the
    uniform set, with the probe kernels' launch counts read around that
    run: S1 (per-pass slopes, the speed-of-light line, bf16 operands and
    their drift verdict, the two-symbol step, staged emissions), S2 (the
    emission-select ladder), S3 (the empty floor at 1, 2 and 4 lanes a
    CTA; the FS kernel and both arms of the masked kernel at 128 to 1,024
    lanes; registers and CTAs an SM of these and of both path arms), S4
    (the ablation table of the generic masked arm);
    the chain floor of each production kernel's shape (the empty step; for
    the backtrace the ``chase`` probe's hop in shared memory and through a
    4.36 GB table, ``chain_floor_chase_shared``/``_hbm``, and
    ``svt_backtrace`` through that table, every step a miss, and through
    identity pointers, none: ``backtrace_random``/``_identity``, each
    bit-equal to its plain version); then each
    probe kernel against its plain version on a 64-step slice, every
    class, scheme and flag, bit-equal;
23. time kernel and plain version of the scores kernels at the uniform
    shape and the path kernels at one uniform path call (median of 5; the
    plain path scans on fewer repeats, as their lines say), each arm of
    the masked and path kernels on its own line; both arms of the masked
    and path kernels and the backtrace kernel at each ragged bucket; then
    ``rank``: per kernel and arm, the sum over one call of its main path
    of (time - bound), the order in which the kernels lose most against
    their bounds (the generic arms on the same calls, marked as off the
    corpus model's main path). The FS kernel's and the backtrace's
    ``time``, ``rank`` and ``kernels`` entries carry their chain floors.
24. ``spec_struct``: ``StructuredSpecializedViterbi(level=2)`` on the
    corpus model: the factored form (the fused decoder) through
    ``run_spec_batch`` on both sets and ``run_spec`` on one sequence, with
    the launch counts read around that run (one FS launch a uniform call,
    one planned masked launch a ragged bucket), bit-equal to
    ``decode_batch``; then the composed form (``use_kernels=False``, plain
    PyTorch, no kernel) on 8 uniform and 4 ragged lanes: within ±1.0 of the
    dense scores and bit-equal to the same composed code on the CPU; the
    host seconds of each form on those lanes;
25. ``bench``: the headline line (``spec_viterbi_tpu_torch.bench.headline``,
    the entry point's default inputs: this model and the first 50 uniform
    sequences) at full size: 16 pre-staged batches of 512 x 3,500, the
    dense baseline, the ``empty`` floor at 2,432 x 512, the bit-equality
    gate;
26. ``bench_sweep``: both ``.dat`` sweeps (``bench/bench_viterbi.py``)
    over this model and a 502-state profile model on the 50 sequences,
    2 timed runs a cell, the spec sweep's prep once; NaN exactly where the
    8 GB memory policy says;
27. ``bench_ragged``: the ragged bench (``bench/bench_ragged.py``) on this
    model with the ragged set's lengths, both path columns with their
    peak allocated memory against the pointer budget (``path_peak``
    lines).

Every ``kernels`` entry carries its bound (``spec_viterbi_tpu_torch/
probes/bounds.py``: the larger of its f32 operations over 33.45 T/s and
its bytes over 3.35 TB/s, one count of an operator's work whichever arm
runs it) for the work it was timed on; the planned arms' launches come
from the corpus model's main path, the generic arms' from
``generic_main``, ``minplus``'s from ``dense_main`` and ``spec_main``. The
line before the card's line is that JSON object with one entry per kernel;
the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np

# the corpus-shaped stand-in (2,407 states), 512 lanes x 3,500 symbols,
# and the median's repeats: the shapes the probes use too
from spec_viterbi_tpu_torch.probes.common import LANES, REPEATS, STATES_MATCH, T_LEN

# the state-sharded decode's banded model and schedule
from spec_viterbi_tpu_torch.probes.windows import CHUNK as TP_CHUNK
from spec_viterbi_tpu_torch.probes.windows import OFFSETS as TP_OFFSETS
from spec_viterbi_tpu_torch.probes.windows import SHARDS as TP_SHARDS
from spec_viterbi_tpu_torch.probes.windows import STATES as TP_STATES
from spec_viterbi_tpu_torch.probes.windows import SYMBOLS as TP_SYMBOLS

PROBE_SLICE = 64  # steps of the probe kernels' kernel-vs-plain slice
PLAIN_PATH_REPEATS = 2  # the plain path scan takes seconds per call
STREAM_CHUNKS = (999, 1500, 1000)  # after the first symbol: 3,500 in all
NO_OTHER_LAUNCHES = {"path": 0, "path_planned": 0, "backtrace": 0, "scores_window": 0,
                     "path_window": 0}
ZERO_LAUNCHES = {"scores_masked": 0, "scores_masked_planned": 0, "scores_fs": 0, **NO_OTHER_LAUNCHES}
GENERIC_CHECK_STEPS = 511  # steps of the generic arms' kernel-vs-plain check outside the plans
DENSE_LANES = 50  # the JAX package's dense baseline: 50 lanes x 3,500 symbols (bench.py:162-174)
DENSE_PLAIN_STEPS = 64  # the plain version's prefix of the dense run_batch
DENSE_TIME_REPEATS = 2  # a dense run_batch takes about a second
AUTO_STATES, AUTO_TRANS = 1024, 256  # the seeded dense-class model on which auto resolves to dense
SPEC_PLAIN_PRODUCTS = ((0, 0), (7, 13), (19, 20), (20, 5))  # (new symbol, earlier) of the level-2 build
SPEC_PLAIN_CHUNKS = 16  # chunks of the gathered decode held to the plain version
J1_COLD_COPIES = 8  # operators the J = 1 time lines take in turn: 190 MB, well past the 50 MB L2
TP_PATH_LANES = 256  # the pointer comparison and the path timing
TP_PLAIN_CHUNKS = 4  # chunks of the kernel-vs-plain checks and timings
TP_EMULATED_LANES = 128
DP_PATH_LANES = 128
SPAWN_SECONDS = 600
STRUCT_LEVEL = 2  # the structured specializer's level in spec_struct
STRUCT_COMPOSED_UNIFORM, STRUCT_COMPOSED_RAGGED = 8, 4  # lanes of the composed form's prefix
SWEEP_SMALL_MATCH = 500  # the sweeps' second model: 502 states
SWEEP_TIMES = 2  # timed runs a sweep cell (the reference takes 10)
RAGGED_TIMES = 2


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def equal_with_err(a, b) -> tuple[bool, float]:
    """(bit-equal, max |a-b| over the entries finite in both)."""
    import torch

    same_inf = torch.equal(torch.isinf(a), torch.isinf(b))
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    return torch.equal(a, b) and same_inf, err


def checked_backtraces(label: str, fn, calls: list):
    """Run ``fn()`` with every ``svt_backtrace`` launch held, on the same
    tensors, against ``backtrace_plain`` and against the staged walk's
    emulation (``probes/emulation.py``), bit for bit; each call's misses a
    lane (the emulation's count) go to ``calls``. Returns ``fn()``."""
    import torch

    from spec_viterbi_tpu_torch.ops import fused
    from spec_viterbi_tpu_torch.probes import emulation

    kernel = fused.backtrace

    def checked(src, boundary):
        rev = kernel(src, boundary)
        emu, misses = emulation.backtrace_staged(src, boundary)
        check(torch.equal(rev, fused.backtrace_plain(src, boundary)), f"svt_backtrace == plain, {label}")
        check(torch.equal(rev, emu), f"staged walk emulation == svt_backtrace, {label}")
        calls.append({"call": label, "steps": src.shape[0], "lanes": src.shape[1], "n": src.shape[2],
                      "misses_a_lane_mean": float(misses.double().mean()),
                      "misses_a_lane_min": int(misses.min()), "misses_a_lane_max": int(misses.max())})
        return rev

    fused.backtrace = checked
    try:
        return fn()
    finally:
        fused.backtrace = kernel


def _tp_dist_rank(rank: int, world: int, init_file: str, data_file: str, out_file: str,
                  seed: int) -> None:
    """One NCCL rank of ``tp_dist``: the banded model's TP decode on a
    distributed group, card ``rank``; rank 0 writes what it decoded."""
    import torch

    from spec_viterbi_tpu_torch.io import generate_banded_hmm
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
    from spec_viterbi_tpu_torch.parallel import FusedTPDecoder, init_distributed, make_group

    dev = torch.device(f"cuda:{rank}")
    torch.cuda.set_device(dev)
    init_distributed(f"file://{init_file}", world, rank, device=dev)
    try:
        hmm = generate_banded_hmm(TP_STATES, TP_OFFSETS, TP_SYMBOLS, seed=seed)
        sop = StructuredOperator.from_hmm(hmm)
        tp = FusedTPDecoder(sop, hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n),
                            make_group(dev), chunk=TP_CHUNK)
        seqs = list(np.load(data_file))
        secs = []
        for _ in range(2):  # the second round is timed warm (NCCL set up)
            torch.distributed.barrier(device_ids=[rank])
            t0 = time.perf_counter()
            scores = np.stack(tp.decode_batch(seqs))
            secs.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            got = tp.decode_path_batch(seqs)
            secs.append(time.perf_counter() - t0)
        if rank == 0:
            np.savez(out_file, scores=scores, path_scores=np.stack([sc for sc, _ in got]),
                     paths=np.stack([p for _, p in got]), seconds=np.array(secs[2:]))
    finally:
        torch.distributed.destroy_process_group()


def tp_dist(seed: int, uniform: list, scores, paths, tmp: str) -> None:
    """``tp_dist``: TP scores and paths on min(4, cards) NCCL ranks, one
    card each, bit-equal to the local group's (``scores``, ``paths``)."""
    import multiprocessing as mp

    import torch

    count = torch.cuda.device_count()
    if count < 2:
        phase("tp_dist", ran=False, why=f"{count} card")
        return
    world = min(4, count)
    torch.cuda.empty_cache()
    np.save(f"{tmp}/uniform.npy", np.stack(uniform))
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_tp_dist_rank, args=(r, world, f"{tmp}/rendezvous", f"{tmp}/uniform.npy",
                                                f"{tmp}/tp_dist.npz", seed))
        for r in range(world)
    ]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_SECONDS
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    check(not hung, f"tp_dist ranks {hung} finished within {SPAWN_SECONDS} s")
    check([p.exitcode for p in procs] == [0] * world, "every tp_dist rank exited 0")
    with np.load(f"{tmp}/tp_dist.npz") as z:
        check(np.array_equal(z["scores"], np.stack(scores)), "distributed TP scores == local group")
        check(np.array_equal(z["path_scores"], np.stack([sc for sc, _ in paths])),
              "distributed TP path scores == local group")
        check(np.array_equal(z["paths"], np.stack([p for _, p in paths])),
              "distributed TP paths == local group")
        warm = z["seconds"].tolist()
    phase("tp_dist", ran=True, ranks=world, seconds=time.perf_counter() - t0, lanes=len(uniform),
          bit_equal=True, decode_batch_seconds=warm[0], decode_path_batch_seconds=warm[1])


def generic_main(seed: int, lengths) -> tuple[dict, dict]:
    """``generic_main`` and ``generic_kernel_vs_plain``: the generic arms
    of the masked and path kernels on a model outside the uniform plans
    (the seeded tie-heavy model at the corpus stand-in's 2,405 states: one
    diagonal, one dense row and column, three residual entries, no plans).
    ``decode_batch`` and ``decode_path_batch`` of a ragged set with the
    lengths ``lengths``, through ``ViterbiDecoder``, with the launch counts
    read around that run; then both generic kernels against their plain
    versions on 512 lanes x 511 steps, ragged and unmasked, and the
    decodes against the oracle on a prefix. Returns the launch counts and
    the kernels' max abs errors."""
    import torch

    from spec_viterbi_tpu_torch import ViterbiDecoder, viterbi_path_oracle
    from spec_viterbi_tpu_torch.io import generate_tie_heavy_hmm
    from spec_viterbi_tpu_torch.ops import fused
    from spec_viterbi_tpu_torch.utils.batching import bucket_plan

    hmm = generate_tie_heavy_hmm(STATES_MATCH, seed=seed)
    dec = ViterbiDecoder(hmm, mode="structured", device="cuda")
    fd = dec._fused
    check(fd is not None and not fd._fs_ok and fd._scores_arm is fd._masked
          and fd._path_arm is fd._masked, "the tie-heavy model takes the generic arms")
    rng = np.random.default_rng(seed + 4)
    # the last symbol is dead (no state emits it): left out here
    ragged = [rng.integers(0, hmm.emit_num - 1, size=int(t)).astype(np.int32) for t in lengths]
    plan = bucket_plan([len(s) for s in ragged], lane_block=fused.BB)
    calls = sum(-(-len(idx) // max(fused.BB, fd._path_lane_budget(t))) for idx, t in plan)
    fused.reset_launches()
    secs = {}
    t0 = time.perf_counter()
    scores = dec.decode_batch(ragged)
    secs["ragged_decode_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = dec.decode_path_batch(ragged)
    secs["ragged_decode_path_batch"] = time.perf_counter() - t0
    counts = dict(fused.launches)
    check(counts == {**ZERO_LAUNCHES, "scores_masked": len(plan), "path": calls, "backtrace": calls},
          f"the generic arms ran every bucket: {counts}")
    check(all(np.array_equal(sc, s) for (sc, _), s in zip(paths, scores)), "path scores == scores")
    check(all(bool(np.isfinite(s).any()) for s in scores), "generic scores reach a state")
    phase("generic_main", states=hmm.states_num, n=fd.n, seconds=secs, launches=counts,
          buckets=[[len(i), t] for i, t in plan])

    errs = {"scores_masked": 0.0, "path": 0.0}
    steps = GENERIC_CHECK_STEPS
    for name, seqs in (("ragged", [s[: steps + 1] for s in ragged]),
                       ("uniform", [np.resize(s, steps + 1) for s in ragged])):
        st, ln, m = fd.prepare(seqs, t_pad=steps + 1)
        check(m == (name == "ragged"), f"generic check masking, {name}")
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        ln = ln if m else None
        k = fused.scores_masked(fd._masked, fd.em, v0, st[1:], ln)
        same, err = equal_with_err(k, fused.scores_masked_plain(fd._masked, fd.em_t, v0, st[1:], ln))
        check(same, f"generic masked kernel == plain outside the plans, {name}")
        errs["scores_masked"] = max(errs["scores_masked"], err)
        k_out, k_src = fused.path(fd._masked, fd.em, v0, st[1:], ln)
        p_out, p_src = fused.path_plain(fd._masked, fd.em_t, v0, st[1:], ln)
        same, err = equal_with_err(k_out, p_out)
        check(same and torch.equal(k_src, p_src), f"generic path kernel == plain outside the plans, {name}")
        check(torch.equal(k_out, k), "generic path carry == generic scores")
        errs["path"] = max(errs["path"], err)
        del k_src, p_src
    prefix = [s[: 16 * (j + 1)] for j, s in enumerate(ragged[:4])]
    for s, sc, (psc, p) in zip(prefix, dec.decode_batch(prefix), dec.decode_path_batch(prefix)):
        want_sc, want_p = viterbi_path_oracle(hmm, s)
        check(np.array_equal(sc, want_sc) and np.array_equal(psc, want_sc) and np.array_equal(p, want_p),
              f"generic arms == oracle ({hmm.states_num} states, {len(s)} symbols)")
    phase("generic_kernel_vs_plain", steps=steps, lanes=len(ragged),
          **{f"{k}_max_abs_err": e for k, e in errs.items()})
    return counts, errs


def _spec_launches(lengths, level: int) -> int:
    """svt_minplus launches of ``run_spec_batch`` at ``level`` on
    sequences of ``lengths``: per group of one quantized length ``t_q``,
    one a chunk of the ``t_q - 1`` symbols after the first and one a tail
    symbol."""
    from spec_viterbi_tpu_torch.utils.batching import quantize_t

    return sum((t - 1) // level + (t - 1) % level for t in {quantize_t(int(x)) for x in lengths})


def minplus_timed(fn, launches: int, repeats: int = DENSE_TIME_REPEATS) -> dict:
    """The CUDA-event time of ``fn`` (median of ``repeats``) and, under
    ``torch.profiler``, the device time of its ``svt_minplus`` launches and
    the device's idle share (None where the profiler saw nothing)."""
    from spec_viterbi_tpu_torch.probes.common import median_ms, profiled

    ms = median_ms(fn, repeats=repeats)
    kernel_us, busy_us, span_us = profiled(fn, "minplus")
    return {"ms": ms, "launches": launches,
            "kernel_ms": kernel_us / 1e3 if span_us else None,
            "kernel_us_per_launch": kernel_us / launches if span_us else None,
            "idle_share": 1.0 - busy_us / span_us if span_us else None}


def dense_and_spec(seed: int, card: str, hmm, uniform, ragged, scores_u, scores_r, path_u0) -> dict:
    """The phases ``dense_main``, ``dense_kernel_vs_plain`` and
    ``spec_main`` on the corpus model ``hmm``, and the ``time`` lines of
    ``svt_minplus``. ``scores_u`` ([512, n] on the card), ``scores_r`` and
    ``path_u0`` are the structured main path's uniform and ragged scores and
    lane 0's path. Returns the ``minplus`` entry of the ``kernels`` line."""
    import warnings

    import torch

    from spec_viterbi_tpu_torch import (
        SpecializedViterbi,
        ViterbiDecoder,
        almost_equal_vec,
        viterbi_scores_oracle,
    )
    from spec_viterbi_tpu_torch.io import generate_random_hmm
    from spec_viterbi_tpu_torch.models import specializer
    from spec_viterbi_tpu_torch.models.decoder import SUBLANE
    from spec_viterbi_tpu_torch.ops import fused, tropical
    from spec_viterbi_tpu_torch.probes import bounds
    from spec_viterbi_tpu_torch.probes.common import median_ms
    from spec_viterbi_tpu_torch.utils.batching import bucket_plan

    dev = torch.device("cuda")
    n_real = hmm.states_num
    lanes_u, lanes_r = uniform[:DENSE_LANES], ragged[:DENSE_LANES]
    steps = T_LEN - 1

    # ---- dense_main: the dense baseline shape through the decoder --------
    dec = ViterbiDecoder(hmm, mode="dense", device=dev)
    check(dec.mode == "dense" and dec._fused is None and dec.dev.a is not None,
          "mode='dense' takes the dense path")
    n = dec.dev.padded
    plan = bucket_plan([len(s) for s in lanes_r], lane_block=SUBLANE)
    want = {"run_batch": steps,
            "decode_batch": sum(t - 1 for _, t in plan) if plan else max(map(len, lanes_r)) - 1,
            "decode": steps, "decode_path": steps}
    tropical.reset_launches()
    fused.reset_launches()
    secs = {}
    t0 = time.perf_counter()
    handle = dec.prepare_batch(lanes_u)
    torch.cuda.synchronize()
    secs["uniform_prepare_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_u = dec.run_batch(handle)
    torch.cuda.synchronize()
    secs["uniform_run_batch"] = time.perf_counter() - t0
    check(tropical.launches["minplus"] == want["run_batch"], "one svt_minplus launch a run_batch step")
    t0 = time.perf_counter()
    dense_r = dec.decode_batch(lanes_r)
    secs["ragged_decode_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_1 = dec.decode(lanes_u[0])
    secs["decode_one"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense_p = dec.decode_path(lanes_u[0])
    secs["decode_path_one"] = time.perf_counter() - t0
    dense_launches = tropical.launches["minplus"]
    check(dense_launches == sum(want.values()), f"svt_minplus launches {dense_launches} == {want}")
    check(not any(fused.launches.values()), f"no fused kernel in dense mode: {fused.launches}")
    check(tuple(dense_u.shape) == (-(-DENSE_LANES // SUBLANE) * SUBLANE, n), "dense run_batch shape")
    check(torch.equal(dense_u[:DENSE_LANES], scores_u[:DENSE_LANES]),
          f"dense scores == svt_scores_fs scores, {DENSE_LANES} x {T_LEN}, bit for bit")
    check(all(np.array_equal(d, s) for d, s in zip(dense_r, scores_r)),
          "dense decode_batch == the masked kernel's scores, ragged, bit for bit")
    u_np = dense_u[:DENSE_LANES, :n_real].cpu().numpy()
    check(np.array_equal(dense_1, u_np[0]), "dense decode == lane 0 of run_batch")
    check(np.array_equal(dense_p[0], path_u0[0]) and np.array_equal(dense_p[1], path_u0[1]),
          "dense decode_path == lane 0 of decode_path_batch")
    rnd = generate_random_hmm(AUTO_STATES, trans_per_state=AUTO_TRANS, seed=seed)
    auto = ViterbiDecoder(rnd, mode="auto", device=dev)
    check(auto.mode == "dense", "auto resolves to dense on the dense-class model")
    rng = np.random.default_rng(seed + 8)
    prefix = [rng.integers(0, rnd.emit_num, size=64).astype(np.int32) for _ in range(4)]
    check(all(np.array_equal(g, viterbi_scores_oracle(rnd, s)) for g, s in zip(auto.decode_batch(prefix), prefix)),
          f"auto (dense) == oracle, {AUTO_STATES} states, 4 x 64")
    phase("dense_main", states=n_real, n=n, lanes=DENSE_LANES, padded_lanes=int(dense_u.shape[0]),
          steps=steps, seconds=secs, launches={"minplus": dense_launches, **want},
          ragged_buckets=[[len(i), t] for i, t in plan] if plan else None,
          auto={"states": rnd.states_num, "mode": auto.mode, "oracle_lanes": len(prefix)}, bit_equal=True)

    # ---- dense_kernel_vs_plain ------------------------------------------
    errs = {}

    def held(name, got, want):
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        same, err = equal_with_err(got[0], want[0])
        check(same and all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
              f"svt_minplus == plain, {name}")
        errs[name] = err

    seqs_t, lengths = handle
    obs = seqs_t.long()
    em_t = dec.dev.emissions.T
    a_tn = dec.dev.a.T[None]  # the TN layout, stride_i = 1
    v0 = (em_t[:, obs[0]] + dec.dev.pi[:, None]).contiguous()
    held("one dense batch step", tropical.minplus(a_tn, v0[None]), tropical.minplus_plain(a_tn, v0[None]))

    def run_prefix(product):
        v = v0
        for t in range(1, DENSE_PLAIN_STEPS + 1):
            v = torch.where((t < lengths)[None, :], em_t[:, obs[t]] + product(a_tn, v[None])[0], v)
        return v

    held(f"{DENSE_PLAIN_STEPS}-step prefix of run_batch", run_prefix(tropical.minplus),
         run_prefix(tropical.minplus_plain))
    short = dec.run_batch(dec.prepare_batch([s[: DENSE_PLAIN_STEPS + 1] for s in lanes_u]))
    check(torch.equal(run_prefix(tropical.minplus).T, short), "the prefix loop == run_batch on the prefix")
    v1 = (dec.dev.emissions[int(lanes_u[0][0])] + dec.dev.pi)[None, :, None]
    a_rm = dec.dev.a_t[None]  # row-major, stride_k = 1
    held("J = 1 argmin arm (the decode_path step)", tropical.minplus(a_rm, v1, argmin=True),
         tropical.minplus_plain(a_rm, v1, argmin=True))
    rng = np.random.default_rng(seed + 9)

    def ties(*shape):
        x = torch.as_tensor(rng.integers(0, 4, size=shape).astype(np.float32), device=dev)
        return x.masked_fill_(x == 3, float("inf"))

    edge_rm, edge_tn = ties(5, 1001, 999), ties(1, 999, 1001).transpose(1, 2)
    idx = torch.tensor([4, 0, 4], device=dev)
    b37, b1 = ties(3, 999, 37), ties(3, 999, 1)
    for name, a, a_idx, b in (("ragged edge, gathered", edge_rm, idx, b37),
                              ("ragged edge, TN view", edge_tn, None, b37),
                              ("ragged edge, gathered J = 1", edge_rm, idx, b1)):
        for am in (False, True):
            held(f"{name}, argmin={am}", tropical.minplus(a, b, a_idx, argmin=am),
                 tropical.minplus_plain(a, b, a_idx, argmin=am))
    phase("dense_kernel_vs_plain", max_abs_err=errs, bit_equal=True)

    # ---- spec_main: level 1 through the fused decoder, level 2 dense ----
    ssecs = {}
    spec1 = SpecializedViterbi(level=1, device=dev)
    spec1.spec_with(hmm)
    check(spec1._delegate is not None and spec1._delegate._fused is not None,
          "level 1 delegates to the fused decoder")
    fused.reset_launches()
    tropical.reset_launches()
    t0 = time.perf_counter()
    got1 = spec1.run_spec_batch(lanes_u)
    ssecs["level1_run_spec_batch"] = time.perf_counter() - t0
    l1_counts = dict(fused.launches)
    check(l1_counts["scores_fs"] == 1 and tropical.launches["minplus"] == 0,
          f"level 1 ran svt_scores_fs: {l1_counts}")
    check(all(np.array_equal(g, w) for g, w in zip(got1, u_np)), "level 1 == the dense scores")
    del spec1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tropical.reset_launches()
    spec2 = SpecializedViterbi(level=2, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        spec2.spec_with(hmm)
        torch.cuda.synchronize()
        ssecs["level2_spec_with"] = time.perf_counter() - t0
    check(any("level=1" in str(w.message) for w in caught), "the level-2 slowdown warning fired")
    radix = hmm.emit_num + 1
    build_launches = tropical.launches["minplus"]
    check(build_launches == radix, "one svt_minplus launch a new symbol")
    stack_bytes = spec2.tuple_ops.numel() * 4
    check(tuple(spec2.tuple_ops.shape) == (radix**2, n, n)
          and stack_bytes == SpecializedViterbi.spec_memory_bytes(n_real, hmm.emit_num, 2),
          "level-2 stack shape")
    tropical.reset_launches()
    fused.reset_launches()
    t0 = time.perf_counter()
    spec_u = spec2.run_spec_batch(lanes_u)
    ssecs["level2_run_spec_batch_uniform"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec_r = spec2.run_spec_batch(lanes_r)
    ssecs["level2_run_spec_batch_ragged"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec_1 = spec2.run_spec(lanes_u[0])
    ssecs["level2_run_spec_one"] = time.perf_counter() - t0
    spec_launches = tropical.launches["minplus"]
    want_spec = (_spec_launches(map(len, lanes_u), 2) + _spec_launches(map(len, lanes_r), 2)
                 + steps // 2 + steps % 2)
    check(spec_launches == want_spec and not any(fused.launches.values()),
          f"svt_minplus launches {spec_launches} == {want_spec}, no fused kernel")
    peak = torch.cuda.max_memory_allocated()
    diffs = [float(np.abs(g.astype(np.float64) - w)[np.isfinite(g) & np.isfinite(w)].max(initial=0.0))
             for g, w in zip(spec_u + spec_r, list(u_np) + dense_r)]
    check(np.array_equal(spec_1, spec_u[0]), "run_spec == lane 0 of run_spec_batch")
    check(all(almost_equal_vec(g, w) for g, w in zip(spec_u + spec_r, list(u_np) + dense_r)),
          f"level-2 scores within 1.0 of the dense scores (largest difference {max(diffs)})")
    for i, p in SPEC_PLAIN_PRODUCTS:
        a, b = spec2.ops[i][None], spec2.ops[p][None]
        k = tropical.minplus(a, b)
        held(f"level-2 product {p} + {i} x {radix}", k, tropical.minplus_plain(a, b))
        check(torch.equal(k[0], spec2.tuple_ops[p + i * radix]), "the product == the stack's entry")
        del k
    batch_u = np.stack(lanes_u)  # [50, 3500]: 1,749 chunks and a tail symbol

    def gathered_prefix(product):
        v = spec2.start_ops[torch.as_tensor(batch_u[:, 0].astype(np.int64), device=dev)]
        pairs = batch_u[:, 1 : 1 + 2 * SPEC_PLAIN_CHUNKS].astype(np.int64).reshape(DENSE_LANES, -1, 2)
        idxs = torch.as_tensor((pairs[:, :, 0] + radix * pairs[:, :, 1]).T.copy(), device=dev)
        for c in range(SPEC_PLAIN_CHUNKS):
            v = product(spec2.tuple_ops, v[:, :, None], idxs[c])[:, :, 0]
        return v

    held(f"{SPEC_PLAIN_CHUNKS}-chunk prefix of the gathered decode", gathered_prefix(tropical.minplus),
         gathered_prefix(tropical.minplus_plain))
    phase("spec_main", states=n_real, n=n, level=2, products=radix**2, stack_bytes=stack_bytes,
          seconds=ssecs, level1_launches=l1_counts,
          launches={"build": build_launches, "decode": spec_launches},
          peak_allocated_bytes=peak, largest_difference_to_dense=max(diffs),
          within_almost_equal=True, max_abs_err=errs)

    # ---- time lines of svt_minplus, each held to its bound ---------------
    def time_line(**line):
        phase("time", kernel="minplus", card=card, **line)
        for key in ("ms", "kernel_ms"):
            check(line[key] is None or line[key] >= line["bound_ms"],
                  f"svt_minplus {line['what']}: {key} {line[key]} reads below its bound {line['bound_ms']}")

    j = int(dense_u.shape[0])
    step_work = bounds.minplus(1, n, n, j, 1)
    step_bound, step_by = step_work.bound()
    timed = minplus_timed(lambda: [tropical.minplus(a_tn, v0[None]) for _ in range(steps)], steps)
    run_ms = median_ms(lambda: dec.run_batch(handle), repeats=DENSE_TIME_REPEATS)
    plain_ms = median_ms(lambda: [tropical.minplus_plain(a_tn, v0[None]) for _ in range(DENSE_PLAIN_STEPS)],
                         repeats=DENSE_TIME_REPEATS)
    time_line(what="dense run_batch", lanes=DENSE_LANES, padded_lanes=j, steps=steps, **timed,
              us_per_step=timed["ms"] * 1e3 / steps, run_batch_ms=run_ms,
              run_batch_us_per_step=run_ms * 1e3 / steps, plain_steps=DENSE_PLAIN_STEPS,
              plain_ms=plain_ms, plain_us_per_step=plain_ms * 1e3 / DENSE_PLAIN_STEPS,
              bound_ms=steps * step_bound, bound_by=step_by, shape=tropical.minplus_shape(1, n, n, j, dev))
    # The bound counts the operator's bytes at the HBM rate. The decode
    # loop reuses one operator, which stays in the 50 MB L2 and is read
    # faster than that (no L2 rate on the data sheet, so no bound for it):
    # the line times copies taken in turn, each read from HBM, and gives
    # the reused operator's times beside them as resident_*.
    cold = [a_rm.clone() for _ in range(J1_COLD_COPIES)]
    for am in (False, True):
        work = bounds.minplus(1, n, n, 1, 1, argmin=am)
        t1 = minplus_timed(lambda: [tropical.minplus(cold[s % J1_COLD_COPIES], v1, argmin=am)
                                    for s in range(steps)], steps)
        warm = minplus_timed(lambda: [tropical.minplus(a_rm, v1, argmin=am) for _ in range(steps)], steps)
        p1 = median_ms(lambda: [tropical.minplus_plain(a_rm, v1, argmin=am) for _ in range(DENSE_PLAIN_STEPS)],
                       repeats=DENSE_TIME_REPEATS)
        whole = median_ms(lambda: (dec.decode_path if am else dec.decode)(lanes_u[0]), repeats=1)
        res_us = warm["kernel_us_per_launch"]
        time_line(what="J = 1 step" + (", argmin" if am else ""), steps=steps,
                  operator=f"{J1_COLD_COPIES} copies in turn, each read from HBM", **t1,
                  us_per_step=t1["ms"] * 1e3 / steps,
                  resident_ms=warm["ms"], resident_kernel_us_per_launch=res_us,
                  resident_idle_share=warm["idle_share"],
                  resident_read_tb_per_s=work.bytes / res_us / 1e6 if res_us else None,
                  **{("decode_path_ms" if am else "decode_ms"): whole}, plain_steps=DENSE_PLAIN_STEPS,
                  plain_ms=p1, plain_us_per_step=p1 * 1e3 / DENSE_PLAIN_STEPS,
                  bound_ms=steps * work.bound()[0], bound_by=work.bound()[1],
                  shape=tropical.minplus_shape(1, n, n, 1, dev))
    del cold
    build = minplus_timed(lambda: specializer._add_level(spec2.ops, spec2.ops), radix)
    b_plain = median_ms(lambda: tropical.minplus_plain(spec2.ops[7][None], spec2.ops[13][None]), repeats=1)
    build_work = bounds.minplus(radix, n, n, n, 1)
    time_line(what="level-2 build (_add_level)", products=radix**2, **build,
              us_per_product=build["ms"] * 1e3 / radix**2, plain_ms_one_product=b_plain,
              bound_ms=radix * build_work.bound()[0], bound_by=build_work.bound()[1],
              shape=tropical.minplus_shape(radix, n, n, n, dev))
    chunks = steps // 2
    pairs = batch_u[:, 1 : 1 + 2 * chunks].astype(np.int64).reshape(DENSE_LANES, chunks, 2)
    tuples = pairs[:, :, 0] + radix * pairs[:, :, 1]  # [50, 1749]
    # a launch reads the distinct operators its lanes index, once each
    distinct = [len(np.unique(tuples[:, c])) for c in range(chunks)] + [len(np.unique(batch_u[:, -1]))]
    launch_bounds = [bounds.minplus(DENSE_LANES, n, n, 1, d, gathered=True).bound() for d in distinct]
    dec_t = minplus_timed(lambda: spec2._decode_batch_uniform(batch_u), chunks + 1)
    g_plain = median_ms(lambda: gathered_prefix(tropical.minplus_plain), repeats=1)
    time_line(what="gathered level-2 decode", lanes=DENSE_LANES, chunks=chunks, tail_launches=1, **dec_t,
              us_per_chunk=dec_t["ms"] * 1e3 / (chunks + 1), plain_chunks=SPEC_PLAIN_CHUNKS, plain_ms=g_plain,
              plain_us_per_chunk=g_plain * 1e3 / SPEC_PLAIN_CHUNKS, bound_ms=sum(b for b, _ in launch_bounds),
              bound_by="bytes" if all(by == "bytes" for _, by in launch_bounds) else "operations",
              distinct_operators_a_launch_mean=float(np.mean(distinct)),
              shape=tropical.minplus_shape(DENSE_LANES, n, n, 1, dev))
    del spec2, dec, auto
    torch.cuda.empty_cache()
    return {
        "name": "minplus", "route": "cuda", "source": "spec_viterbi_tpu_torch/csrc/tropical.cu",
        "replaces": "spec_viterbi_tpu/ops/tropical.py:89", "also_replaces": "spec_viterbi_tpu/ops/tropical.py:31-43",
        "launches": dense_launches + build_launches + spec_launches, "dense_main_launches": dense_launches,
        "spec_main_launches": build_launches + spec_launches, "max_abs_err": max(errs.values()),
        "ms": timed["ms"] / steps, "plain_ms": plain_ms / DENSE_PLAIN_STEPS, "bound_ms": step_bound,
        "bound_by": step_by, "library_ms": None,
        "shape": f"one dense batch step: [{n}, {n}] (min,+) [{n}, {j}]",
    }


def tp_and_dp(seed: int, card: str, lengths, fd, ragged, scores_r, bt_calls: list) -> tuple[list, list]:
    """The phases ``tp_main``, ``tp_kernel_vs_plain``, ``tp_oracle``,
    ``dp``, ``tp_dist`` and the window kernels' ``time`` lines. ``fd``,
    ``ragged`` and ``scores_r`` are the corpus model's fused decoder, ragged
    set and ``decode_batch`` scores; the backtrace launches of a TP and a
    DP path call, each held to its plain version, add their misses to
    ``bt_calls``. Returns the window kernels' entries of the ``kernels``
    line, and the shapes of their launches as (name, window rows, CTAs)
    for the chain floor."""
    import torch

    from spec_viterbi_tpu_torch import viterbi_path_oracle
    from spec_viterbi_tpu_torch.io import generate_banded_hmm, generate_tie_heavy_banded_hmm
    from spec_viterbi_tpu_torch.ops import _build, fused
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
    from spec_viterbi_tpu_torch.parallel import (
        DATA_AXIS,
        FusedTPDecoder,
        decode_batch_dp_fused,
        decode_path_batch_dp_fused,
        fused_tp_supported,
        init_distributed,
        make_group,
    )
    from spec_viterbi_tpu_torch.parallel import fused_tp
    from spec_viterbi_tpu_torch.probes import bounds, windows
    from spec_viterbi_tpu_torch.probes.common import Record, median_ms

    dev = torch.device("cuda")

    def banded(model, shards):
        sop = StructuredOperator.from_hmm(model)
        em, pi = model.emission_matrix(pad_to=sop.n), model.start_vector(pad_to=sop.n)
        tp = FusedTPDecoder(sop, em, pi, make_group(dev, shards), chunk=TP_CHUNK)
        return sop, tp, fused.FusedStructuredDecoder(sop, em, pi, device=dev)

    # ---- tp_main: the TP decode, with the launch counts read around each call
    hmm = generate_banded_hmm(TP_STATES, TP_OFFSETS, TP_SYMBOLS, seed=seed)
    sop, tp, ref = banded(hmm, TP_SHARDS)
    check(sorted(sop.diag_offsets) == sorted(TP_OFFSETS) and not sop.row_idx and not sop.col_idx
          and sop.residual_nnz == 0 and fused_tp_supported(sop, TP_SHARDS, TP_CHUNK),
          "the banded model is in the chunked-halo TP class")
    check((tp.block, tp.h_lo, tp.h_hi, tp.n_win) == (608, 48, 0, 656), "window geometry")
    rng = np.random.default_rng(seed + 2)
    uniform = [rng.integers(0, hmm.emit_num, size=T_LEN).astype(np.int32) for _ in range(LANES)]
    tp_ragged = [rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32) for t in lengths]
    chunks = -(-(T_LEN - 1) // TP_CHUNK)
    secs, counts = {}, {}

    def driven(name, fn, seqs, want):
        fused.reset_launches()
        t0 = time.perf_counter()
        out = fn(seqs)
        secs[name] = time.perf_counter() - t0
        counts[name] = dict(fused.launches)
        check(counts[name] == {**ZERO_LAUNCHES, **want}, f"{name} launches {counts[name]}")
        return out

    scores_u = driven("uniform_decode_batch", tp.decode_batch, uniform, {"scores_window": chunks})
    scores_tr = driven("ragged_decode_batch", tp.decode_batch, tp_ragged, {"scores_window": chunks})
    path_want = {"path_window": chunks, "backtrace": 1}
    paths_u = driven("uniform_decode_path_batch", tp.decode_path_batch, uniform, path_want)
    paths_tr = driven("ragged_decode_path_batch", tp.decode_path_batch, tp_ragged, path_want)
    for seqs, got, got_p in ((uniform, scores_u, paths_u), (tp_ragged, scores_tr, paths_tr)):
        want = ref.decode_batch(seqs)
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              "TP scores == unsharded svt_scores_masked")
        want_p = ref.decode_path_batch(seqs)
        check(all(np.array_equal(sc, wsc) and np.array_equal(p, wp)
                  for (sc, p), (wsc, wp) in zip(got_p, want_p)),
              "TP paths and scores == unsharded decode_path_batch")
        check(all(np.array_equal(sc, g) for (sc, _), g in zip(got_p, got)), "TP path scores == TP scores")
    # the global pointer tensor of one TP path call against svt_path's on
    # the same lanes (each 4.36 GB; the 8.7 GB tensor of the 512-lane
    # calls above is freed)
    st, ln = tp._stage(uniform[:TP_PATH_LANES])
    carry, bp = tp._run_local(st, ln, path=True)
    v0 = ref.em_t[:, st[0].long()] + ref.pi[:, None]
    out, src = fused.path(ref._masked, ref.em, v0, st[1:], None)
    check(torch.equal(carry, out) and torch.equal(bp, src),
          f"TP global pointers == svt_path ({TP_PATH_LANES} x {T_LEN - 1} x {tp.n})")
    del carry, bp, out, src
    again = checked_backtraces("TP decode_path_batch, local group", lambda: tp.decode_path_batch(
        uniform[:TP_PATH_LANES]), bt_calls)
    check(all(np.array_equal(p, w) for (_, p), (_, w) in zip(again, paths_u)), "TP paths again")
    phase("tp_main", states=hmm.states_num, offsets=list(TP_OFFSETS), shards=TP_SHARDS,
          chunk=TP_CHUNK, n_win=tp.n_win, chunks=chunks, seconds=secs, launches=counts,
          pointer_bytes=(T_LEN - 1) * LANES * tp.n * 2,
          peak_allocated_bytes=torch.cuda.max_memory_allocated())

    # ---- tp_kernel_vs_plain: the first chunks, chained ------------------
    t = tp._local
    errs = {"scores_window": 0.0, "path_window": 0.0}
    span = TP_PLAIN_CHUNKS * TP_CHUNK
    short = [s[: 1 + len(s) % span] for s in tp_ragged]  # lanes stop inside the span

    def first_chunks(seqs):
        st, ln = tp._stage(seqs)
        v = tp._em_t[:, st[0].long()] + tp._pi[:, None]
        return v, [(st[1:][k0:k1], len_c) for k0, k1, len_c in tp._chunks(st.shape[0] - 1, ln)][
            :TP_PLAIN_CHUNKS]

    # the rank form of every shard: one window, window-local pointers
    ranks = [fused_tp.WindowTables.build(sop.diag_offsets, t.dv, t.em, tp.block, tp.h_lo, tp.h_hi,
                                         1, op_row0=r * tp.block, ptr_base=0)
             for r in range(TP_SHARDS)]
    check(t.staged and all(r.staged for r in ranks), "the banded model takes the staged window arm")
    for name, seqs in (("uniform", uniform), ("ragged", short)):
        v, cks = first_chunks(seqs[:LANES])
        for obs_c, len_c in cks:
            k = fused_tp.scores_window(t, v, obs_c, len_c)
            same, err = equal_with_err(k, fused_tp.scores_window_plain(t, v, obs_c, len_c))
            check(same, f"scores window kernel == plain, {name}")
            errs["scores_window"] = max(errs["scores_window"], err)
            for r, tr in enumerate(ranks):
                w = v[r * tp.block : r * tp.block + tp.n_win].contiguous()
                k_r = fused_tp.scores_window(tr, w, obs_c, len_c)
                same, err = equal_with_err(k_r, fused_tp.scores_window_plain(tr, w, obs_c, len_c))
                check(same, f"scores window kernel == plain, rank form of shard {r}, {name}")
                check(torch.equal(k_r[tp.h_lo : tp.h_lo + tp.block],
                                  k[r * tp.block + tp.h_lo : (r + 1) * tp.block + tp.h_lo]),
                      f"rank form == local form, shard {r}")
                errs["scores_window"] = max(errs["scores_window"], err)
            v = k
        v, cks = first_chunks(seqs[:TP_PATH_LANES])
        for obs_c, len_c in cks:
            k, k_bp = fused_tp.path_window(t, v, obs_c, len_c)
            p, p_bp = fused_tp.path_window_plain(t, v, obs_c, len_c)
            same, err = equal_with_err(k, p)
            check(same and torch.equal(k_bp, p_bp), f"path window kernel == plain, {name}")
            errs["path_window"] = max(errs["path_window"], err)
            for r, tr in enumerate(ranks):
                w = v[r * tp.block : r * tp.block + tp.n_win].contiguous()
                k_r, k_rbp = fused_tp.path_window(tr, w, obs_c, len_c)
                p_r, p_rbp = fused_tp.path_window_plain(tr, w, obs_c, len_c)
                same, err = equal_with_err(k_r, p_r)
                check(same and torch.equal(k_rbp, p_rbp),
                      f"path window kernel == plain, rank form of shard {r}, {name}")
                errs["path_window"] = max(errs["path_window"], err)
            v = k
    emulated = tp.decode_batch_emulated(uniform[:TP_EMULATED_LANES], check_path_kernel=True)
    check(all(np.array_equal(g, w) for g, w in zip(emulated, scores_u)),
          "decode_batch_emulated(check_path_kernel=True) == decode_batch")
    phase("tp_kernel_vs_plain", chunks=TP_PLAIN_CHUNKS, scores_lanes=LANES,
          path_lanes=TP_PATH_LANES, emulated_lanes=TP_EMULATED_LANES, rank_forms=TP_SHARDS,
          **{f"{k}_max_abs_err": e for k, e in errs.items()})

    # ---- tp_oracle: against viterbi_path_oracle ---------------------------
    prefix = [s[:64] for s in uniform[:4]]
    tie = generate_tie_heavy_banded_hmm(512, (-1, 1), TP_SYMBOLS, seed=seed)
    _, tie_tp, _ = banded(tie, TP_SHARDS)
    tie_rng = np.random.default_rng(seed + 3)
    tie_seqs = [tie_rng.integers(0, tie.emit_num - 1, size=n).astype(np.int32)
                for n in (1, 2, 16, 17, 18, 63, 64, 50)]
    tie_seqs[-1][20] = tie.emit_num - 1  # the dead symbol
    for model, dec, seqs in ((hmm, tp, prefix), (tie, tie_tp, tie_seqs)):
        for s, sc, (psc, p) in zip(seqs, dec.decode_batch(seqs), dec.decode_path_batch(seqs)):
            want_sc, want_p = viterbi_path_oracle(model, s)
            check(np.array_equal(sc, want_sc) and np.array_equal(psc, want_sc)
                  and np.array_equal(p, want_p),
                  f"TP == oracle ({model.states_num} states, {len(s)} symbols)")
    phase("tp_oracle", lanes=len(prefix) + len(tie_seqs), bit_equal=True)

    # ---- dp: the fused DP entry points on a world-size-1 NCCL group ------
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        init_distributed(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        try:
            group = make_group(dev, axis=DATA_AXIS)
            fused.reset_launches()
            t0 = time.perf_counter()
            dp_scores = decode_batch_dp_fused(fd, ragged, group)
            dp_paths = decode_path_batch_dp_fused(fd, ragged[:DP_PATH_LANES], group)
            dp_secs = time.perf_counter() - t0
            dp_counts = dict(fused.launches)
            backend = torch.distributed.get_backend()
        finally:
            torch.distributed.destroy_process_group()
    check(dp_counts == {**ZERO_LAUNCHES, "scores_masked_planned": 1, "path_planned": 1, "backtrace": 1},
          f"dp launches {dp_counts}")
    check(all(np.array_equal(g, w) for g, w in zip(dp_scores, scores_r)),
          "DP scores == single-device decode_batch")
    want_p = checked_backtraces("DP path decode (its single-device call)",
                                lambda: fd.decode_path_batch(ragged[:DP_PATH_LANES]), bt_calls)
    check(all(np.array_equal(sc, wsc) and np.array_equal(p, wp)
              for (sc, p), (wsc, wp) in zip(dp_paths, want_p)),
          "DP paths == single-device decode_path_batch")
    phase("dp", world=1, backend=backend, lanes=len(ragged), path_lanes=DP_PATH_LANES,
          seconds=dp_secs, launches=dp_counts)

    # ---- tp_dist: NCCL ranks, one card each ------------------------------
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        tp_dist(seed, uniform, scores_u, paths_u, tmp)

    # ---- times: the whole TP decode; kernel vs plain on the first chunks;
    # the unsharded kernels on the same model and lanes
    st, ln = tp._stage(uniform)
    st_p, ln_p = tp._stage(uniform[:TP_PATH_LANES])
    v0 = ref.em_t[:, st[0].long()] + ref.pi[:, None]
    v0_p = ref.em_t[:, st_p[0].long()] + ref.pi[:, None]
    v, cks = first_chunks(uniform)
    v_p, cks_p = first_chunks(uniform[:TP_PATH_LANES])

    def chained(step, v, cks):
        for obs_c, len_c in cks:
            v = step(t, v, obs_c, len_c)

    steps = T_LEN - 1
    span_steps = sum(o.shape[0] for o, _ in cks)
    rows = {
        "scores_window": (
            LANES,
            median_ms(lambda: tp._run_local(st, ln, path=False)),
            median_ms(lambda: chained(fused_tp.scores_window, v, cks)),
            median_ms(lambda: chained(fused_tp.scores_window_plain, v, cks)),
            "scores_masked",
            median_ms(lambda: fused.scores_masked(ref._masked, ref.em, v0, st[1:], None)),
        ),
        "path_window": (
            TP_PATH_LANES,
            median_ms(lambda: tp._path_core(st_p, ln_p)),
            median_ms(lambda: chained(lambda *a: fused_tp.path_window(*a)[0], v_p, cks_p)),
            median_ms(lambda: chained(lambda *a: fused_tp.path_window_plain(*a)[0], v_p, cks_p)),
            "path",
            median_ms(lambda: fused.path(ref._masked, ref.em, v0_p, st_p[1:], None)),
        ),
    }
    kernels, floors = [], []
    n_global = tp.h_lo + tp.n + tp.h_hi
    for name, (lanes, decode_ms, ms, plain_ms, unsharded, unsharded_ms) in rows.items():
        geometry = (len(TP_OFFSETS), tp.n_win, TP_SHARDS, n_global, lanes)

        def work(steps, launches):
            if name == "scores_window":
                return bounds.window_scores(*geometry, steps, launches, TP_SYMBOLS)
            return bounds.window_path(*geometry, steps, launches, TP_SYMBOLS, block=tp.block)

        bound_ms, bound_by = work(span_steps, len(cks)).bound()
        decode_bound_ms, decode_bound_by = work(steps, chunks).bound()
        floors.append((f"window_b{lanes}", tp.n_win, lanes * TP_SHARDS))
        floors.append((f"window_rank_b{lanes}", tp.n_win, lanes))
        phase("time", kernel=name, card=card, lanes=lanes, shards=TP_SHARDS, steps=steps,
              decode_ms=decode_ms, decode_us_per_step=decode_ms * 1e3 / steps,
              decode_bound_ms=decode_bound_ms, decode_bound_by=decode_bound_by,
              span_steps=span_steps, ms=ms, us_per_step=ms * 1e3 / span_steps,
              plain_ms=plain_ms, plain_us_per_step=plain_ms * 1e3 / span_steps,
              bound_ms=bound_ms, bound_by=bound_by,
              unsharded_kernel=unsharded, unsharded_ms=unsharded_ms,
              unsharded_us_per_step=unsharded_ms * 1e3 / steps)
        kernels.append({
            "name": name, "route": "cuda", "source": "spec_viterbi_tpu_torch/csrc/window.cu",
            "replaces": "spec_viterbi_tpu/parallel/fused_tp.py:" + ("198" if name == "scores_window" else "302"),
            "launches": sum(c[name] for c in counts.values()), "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": f"{lanes} lanes x {span_steps} steps, {len(cks)} launches",
            "decode_launches": chunks, "decode_ms": decode_ms, "decode_bound_ms": decode_bound_ms,
        })

    # both forms through the decoder's chunk loops: the local group's and
    # one rank's launches (S = 1, no peers), with the host's us a chunk and
    # the device's idle share; registers and CTAs an SM of both kernels
    rec = Record(card, tag="time")
    forms = windows.run(rec, dev, seed)
    windows.launch_costs(rec, dev, seed)
    windows.occupancy(Record(card, tag="occupancy"), dev, seed)
    for e in kernels:
        e["rank_form_ms"] = forms[f"rank_{e['name']}"]["ms"]
        e["host_us_per_chunk"] = forms[f"local_{e['name']}"]["host_us_per_chunk"]
    return kernels, floors


def probes_phase(seed: int, card: str, hmm, fd, seqs_t, window_floors) -> tuple[list, dict]:
    """``probes``: the H100 probes on the uniform set ``seqs_t`` [T, B] of
    the corpus model (``hmm``, its fused decoder ``fd``), the launch counts
    of the probe kernels read around that run, the chain floors (the
    window kernels' launch shapes ``window_floors`` from :func:`tp_and_dp`;
    the backtrace's hop in shared memory and through a 4.36 GB table),
    then each probe kernel against its plain version on a 64-step slice.
    Returns the probe kernels' entries of the ``kernels`` line and the
    chain floors in ms by name."""
    import torch

    from spec_viterbi_tpu_torch.ops import fused, probes
    from spec_viterbi_tpu_torch.probes import bounds, laneblock, run_all
    from spec_viterbi_tpu_torch.probes.common import (
        N_STATES,
        CorpusBatch,
        PassInputs,
        Record,
        median_ms,
    )

    dev = torch.device("cuda")
    rec = Record(card, tag="probes")
    corpus = CorpusBatch.of(hmm, fd, seqs_t)
    probes.reset_launches()
    t0 = time.perf_counter()
    run_all(rec, dev, seed, corpus=corpus)
    seconds = time.perf_counter() - t0
    counts = dict(probes.launches)
    check(all(c > 0 for c in counts.values()), f"every probe kernel launched: {counts}")

    # the chain floor: the empty step at each production kernel's carry
    # length and CTA count (window kernels: n_win rows, lanes x shards CTAs)
    steps = T_LEN - 1
    empty = laneblock.empty_floor(rec, [
        ("scores_b512", N_STATES, LANES), ("path_b256", N_STATES, TP_PATH_LANES), *window_floors,
    ], steps, seed, dev)
    chase = laneblock.chase_floor(rec, TP_PATH_LANES, N_STATES, steps, seed, dev)
    check(chase["backtrace_random"]["bit_equal"] and chase["backtrace_identity"]["bit_equal"],
          "svt_backtrace == plain on random and identity pointers")
    floors = {"scores_fs": empty["scores_b512"]["floor_ms"],
              "backtrace": chase["chase"]["floor_ms"], "backtrace_hbm": chase["chase_hbm"]["floor_ms"]}

    # each probe kernel against its plain version on a 64-step slice
    inp = PassInputs.make(N_STATES, LANES, PROBE_SLICE, seed + 5, dev)
    errs = {"probe_pass": 0.0, "probe_emsel": 0.0, "scores_variant": 0.0}
    timed = {}

    def held(name, what, kernel, plain, time_it=False):
        k, p = kernel(), plain()
        same, err = equal_with_err(k, p)
        check(same, f"{name} == plain, {what}")
        errs[name] = max(errs[name], err)
        if time_it:
            timed[name] = (what, median_ms(kernel), median_ms(plain))

    cases = [("empty", 0, lpc, sym) for lpc in (1, 2, 4) for sym in (False, True)]
    cases += [("stream", 4, 1, False), ("neighbour", 4, 1, False), ("colred", 4, 1, False),
              ("bcast", 4, 1, False), ("emission", 2, 1, False), ("twosym", 0, 1, False),
              ("chase", 3, 1, False), ("chase_hbm", 2, 1, False)]
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    chase_tabs = {
        "chase": torch.randperm(N_STATES, generator=g, device=dev).to(torch.int16),
        "chase_hbm": torch.randint(0, N_STATES, (2 * PROBE_SLICE, LANES, N_STATES), generator=g, device=dev,
                                   dtype=torch.int16),
    }
    for cls, p, lpc, sym in cases:
        obs = inp.obs if (sym or cls in ("emission", "twosym")) else None
        tab = chase_tabs.get(cls, inp.tabs if cls == "twosym" else inp.em)
        args = dict(obs=obs, cols=inp.cols, bufs=inp.bufs, tab=tab, p=p)
        held("probe_pass", f"{cls} p={p} lanes/CTA={lpc}",
             lambda: probes.probe_pass(cls, inp.v0, PROBE_SLICE, lanes_per_cta=lpc, **args),
             lambda: probes.probe_pass_plain(cls, inp.v0, PROBE_SLICE, **args),
             time_it=cls == "twosym")
    for scheme in probes.EMSEL_SCHEMES:
        tabs = probes.emsel_tables(inp.em, scheme)
        held("probe_emsel", f"{scheme} p=2",
             lambda: probes.probe_emsel(scheme, tabs, inp.v0, inp.obs, PROBE_SLICE, 2),
             lambda: probes.probe_emsel_plain(tabs, inp.v0, inp.obs, PROBE_SLICE, 2),
             time_it=scheme == "bf16")
    obs = corpus.obs[:PROBE_SLICE].contiguous()
    lens = torch.as_tensor(np.random.default_rng(seed + 6).integers(1, PROBE_SLICE + 2, size=LANES)
                           .astype(np.int32), device=dev)
    for name in ("baseline", *probes.VARIANT_FLAGS):
        t = probes.VariantTables.build(fd._masked, fd.em, probes.variant_flag(name))
        held("scores_variant", f"{name}, ragged", lambda: probes.scores_variant(t, corpus.v0, obs, lens),
             lambda: probes.scores_variant_plain(t, corpus.v0, obs, lens), time_it=name == "baseline")
    check(torch.equal(probes.scores_variant(probes.VariantTables.build(fd._masked, fd.em, 0),
                                            corpus.v0, corpus.obs, None),
                      fused.scores_masked(fd._masked, fd.em, corpus.v0, corpus.obs, None)),
          f"the all-off variant == svt_scores_masked at {LANES} x {steps}")
    phase("probes", seconds=seconds, launches=counts, slice_steps=PROBE_SLICE,
          **{f"{k}_max_abs_err": e for k, e in errs.items()})

    sop = fd.sop
    lane_steps = int((lens - 1).clamp(0, PROBE_SLICE).sum())
    work = {
        "probe_pass": bounds.probe_pass("twosym", N_STATES, LANES, PROBE_SLICE, 0),
        "probe_emsel": bounds.probe_emsel("bf16", N_STATES, LANES, PROBE_SLICE, 2),
        # the operator's one count, whichever kernel runs it
        "scores_variant": bounds.masked_scores(
            bounds.operator_step(sop.n, len(sop.diag_offsets), len(sop.row_idx), len(sop.col_idx),
                                 planned=fd._fs is not None),
            LANES, PROBE_SLICE, lane_steps, hmm.emit_num, True),
    }
    replaces = {"probe_pass": "scripts/exp_roofline.py:130",
                "probe_emsel": "scripts/exp_mxu_precision.py:127",
                "scores_variant": "scripts/exp_kernel_variants.py:34"}
    # the tensor-core time of the timed select's one-hot products, beside
    # (not in) its bound
    extra = {"probe_emsel": {"mma_ms": bounds.emsel_mma_ms("bf16", N_STATES, LANES, PROBE_SLICE, 2)}}
    source = {"probe_pass": "probes.cu", "probe_emsel": "probes.cu", "scores_variant": "scores.cu"}
    kernels = []
    for name, (what, ms, plain_ms) in timed.items():
        bound_ms, bound_by = work[name].bound()
        phase("time", kernel=name, card=card, shape=f"{what}, {LANES} lanes x {PROBE_SLICE} steps",
              ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, **extra.get(name, {}))
        kernels.append({
            "name": name, "route": "cuda", "source": f"spec_viterbi_tpu_torch/csrc/{source[name]}",
            "replaces": replaces[name], "launches": counts[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": f"{what}, {LANES} lanes x {PROBE_SLICE} steps",
        })
    return kernels, floors


def struct_and_bench(seed: int, card: str, hmm, uniform, ragged, scores_u, scores_r, plan) -> None:
    """The phases ``spec_struct``, ``bench``, ``bench_sweep`` and
    ``bench_ragged`` on the corpus model ``hmm``. ``scores_u`` ([512, n] on
    the card) and ``scores_r`` are the structured main path's uniform and
    ragged scores (bit-equal to the dense scores, ``dense_main``), ``plan``
    the ragged set's bucket plan."""
    import torch

    from spec_viterbi_tpu_torch import SpecializedViterbi, StructuredSpecializedViterbi, almost_equal_vec
    from spec_viterbi_tpu_torch.bench import bench_ragged, bench_viterbi, harness, headline
    from spec_viterbi_tpu_torch.io import generate_profile_hmm, write_chmm, write_ess
    from spec_viterbi_tpu_torch.ops import _build, fused

    dev = torch.device("cuda")
    n_real = hmm.states_num
    u_np = scores_u.cpu().numpy()[:, :n_real]

    # ---- spec_struct: the factored form on the kernels, then the composed
    # form on the card and on the CPU ----------------------------------------
    t0 = time.perf_counter()
    spec = StructuredSpecializedViterbi(level=STRUCT_LEVEL, device=dev)
    spec.spec_with(hmm)
    secs = {"spec_with": time.perf_counter() - t0}
    check(spec._fused is not None and spec._fused._fs_ok, "the factored form takes the fused kernels, FS class")
    fused.reset_launches()
    t0 = time.perf_counter()
    got_u = spec.run_spec_batch(uniform)
    secs["uniform_run_spec_batch"] = time.perf_counter() - t0
    check(fused.launches == {**ZERO_LAUNCHES, "scores_fs": 1}, "the uniform set ran the FS kernel")
    t0 = time.perf_counter()
    got_r = spec.run_spec_batch(ragged)
    secs["ragged_run_spec_batch"] = time.perf_counter() - t0
    check(fused.launches == {**ZERO_LAUNCHES, "scores_fs": 1, "scores_masked_planned": len(plan)},
          "every ragged bucket ran the planned arm of the masked kernel")
    got_1 = spec.run_spec(uniform[0])
    counts = dict(fused.launches)
    check(counts == {**ZERO_LAUNCHES, "scores_fs": 2, "scores_masked_planned": len(plan)},
          "run_spec of one sequence ran the FS kernel")
    check(all(np.array_equal(g, u_np[i]) for i, g in enumerate(got_u)), "factored uniform == decode_batch")
    check(all(np.array_equal(g, w) for g, w in zip(got_r, scores_r)), "factored ragged == decode_batch")
    check(np.array_equal(got_1, u_np[0]), "factored run_spec == lane 0")

    comp = StructuredSpecializedViterbi(level=STRUCT_LEVEL, use_kernels=False, device=dev)
    t0 = time.perf_counter()
    comp.spec_with(hmm)
    secs["composed_spec_with"] = time.perf_counter() - t0
    check(comp._fused is None, "use_kernels=False pins the composed form")
    prefix = uniform[:STRUCT_COMPOSED_UNIFORM] + ragged[:STRUCT_COMPOSED_RAGGED]
    want = list(u_np[:STRUCT_COMPOSED_UNIFORM]) + scores_r[:STRUCT_COMPOSED_RAGGED]
    fused.reset_launches()
    t0 = time.perf_counter()
    got_c = comp.run_spec_batch(prefix)
    secs["composed_run_spec_batch"] = time.perf_counter() - t0
    check(not any(fused.launches.values()), "the composed form launches no fused kernel")
    t0 = time.perf_counter()
    spec.run_spec_batch(prefix)
    secs["factored_run_spec_batch_same_lanes"] = time.perf_counter() - t0
    diffs = [float(np.abs(g.astype(np.float64) - w)[np.isfinite(g) & np.isfinite(w)].max(initial=0.0))
             for g, w in zip(got_c, want)]
    check(all(almost_equal_vec(g, w) for g, w in zip(got_c, want)),
          f"composed level-{STRUCT_LEVEL} within 1.0 of the dense scores (largest difference {max(diffs)})")
    cpu = StructuredSpecializedViterbi(level=STRUCT_LEVEL, use_kernels=False, device="cpu")
    cpu.spec_with(hmm)
    t0 = time.perf_counter()
    got_cpu = cpu.run_spec_batch(prefix)
    secs["composed_cpu_run_spec_batch"] = time.perf_counter() - t0
    check(all(np.array_equal(g, c) for g, c in zip(got_c, got_cpu)), "composed on the card == on the CPU")
    phase("spec_struct", states=n_real, level=STRUCT_LEVEL, seconds=secs, launches=counts,
          tuple_components=comp.num_components, tuple_offsets=list(comp.tuple_offsets),
          composed_lanes=[len(s) for s in prefix], composed_stack_bytes=sum(
              int(a.numel()) * 4 for a in comp.arrays),
          largest_difference_to_dense=max(diffs), composed_card_equals_cpu=True)
    del spec, comp, cpu
    torch.cuda.empty_cache()

    # ---- bench: the headline line, the entry point's default inputs (the
    # same model and the first 50 uniform sequences) -------------------------
    t0 = time.perf_counter()
    b_hmm, b_seqs, model, work = headline.load_inputs(None, None, seed)
    check(b_hmm.fingerprint() == hmm.fingerprint()
          and all(np.array_equal(a, b) for a, b in zip(b_seqs, uniform)),
          "the headline's default inputs are this run's model and uniform prefix")
    line = headline.run(b_hmm, b_seqs, device=dev, model=f"{model}; {work}", seed=seed)
    phase("bench", seconds=time.perf_counter() - t0, **line)

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        write_chmm(hmm, f"{tmp}/{n_real}.chmm")
        small = generate_profile_hmm(SWEEP_SMALL_MATCH, seed=seed)
        write_chmm(small, f"{tmp}/{small.states_num}.chmm")
        write_ess(b_seqs, f"{tmp}/work.ess")
        write_ess(ragged, f"{tmp}/ragged.ess")

        # ---- bench_sweep: both .dat sweeps over the two models -------------
        t0 = time.perf_counter()
        nonspec = bench_viterbi.benchmark_viterbi_impls_to_dat_file(
            tmp, f"{tmp}/work.ess", f"{tmp}/nonspec.dat", times_to_run=SWEEP_TIMES, device=dev)
        nonspec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        spec_rows = bench_viterbi.benchmark_viterbi_spec_impls_to_dat_file(
            tmp, f"{tmp}/work.ess", f"{tmp}/spec.dat", times_to_run=SWEEP_TIMES, prep_times_to_run=1,
            struct_levels=bench_viterbi.ARTIFACT_STRUCT_LEVELS, device=dev)
        spec_s = time.perf_counter() - t0
        with open(f"{tmp}/nonspec.dat") as f:
            check(f.readline().rstrip("\n").split("\t") == bench_viterbi.nonspec_headers(), "nonspec headers")
        with open(f"{tmp}/spec.dat") as f:
            spec_cols = f.readline().rstrip("\n").split("\t")
        check(spec_cols == bench_viterbi.spec_headers(), "spec headers")
        check(sorted(nonspec) == sorted(spec_rows) == sorted([n_real, small.states_num]), "one row a model")
        for states, row in spec_rows.items():
            for col, t in zip(spec_cols[1:], row):
                name, level = col.removesuffix("_prep").rsplit("_", 1)
                cls = StructuredSpecializedViterbi if name == "spec_struct" else SpecializedViterbi
                over = cls.spec_memory_bytes(states, hmm.emit_num, int(level)) > (8 << 30)
                check(np.isnan(t) == over, f"{states} states {col}: NaN only over the memory budget")
        phase("bench_sweep", card=card, seconds={"nonspec": nonspec_s, "spec": spec_s},
              times_to_run=SWEEP_TIMES, prep_times_to_run=1, lanes=len(b_seqs),
              nonspec={"headers": bench_viterbi.nonspec_headers(), "rows_ms": nonspec},
              spec={"headers": spec_cols, "rows_ms": {k: [None if np.isnan(t) else t for t in v]
                                                      for k, v in spec_rows.items()}},
              sums={k: None if np.isnan(v) else v
                    for k, v in harness.sum_dat_columns(f"{tmp}/spec.dat").items()})

        # ---- bench_ragged: the corpus model on the ragged set's lengths ----
        t0 = time.perf_counter()
        states, row = bench_ragged.benchmark_ragged(f"{tmp}/{n_real}.chmm", f"{tmp}/ragged.ess", copies=1,
                                                    times_to_run=RAGGED_TIMES, device=dev)
        check(all(np.isfinite(row)), "every ragged column ran (both path columns within the budget)")
        phase("bench_ragged", card=card, seconds=time.perf_counter() - t0, states=states, lanes=len(ragged),
              times_to_run=RAGGED_TIMES, headers=list(bench_ragged.HEADERS), row_ms=row,
              path_budget_bytes=fused.path_budget_bytes(dev))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the model and the sequences")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from spec_viterbi_tpu_torch import (
        ViterbiDecoder,
        read_emit_seq,
        read_hmm,
        viterbi_path_oracle,
        viterbi_scores_oracle,
    )
    from spec_viterbi_tpu_torch.io import (
        generate_profile_hmm,
        generate_tie_heavy_hmm,
        write_chmm,
        write_ess,
    )
    from spec_viterbi_tpu_torch.ops import _build, fused
    from spec_viterbi_tpu_torch.probes import bounds
    from spec_viterbi_tpu_torch.probes.common import card_line, median_ms
    from spec_viterbi_tpu_torch.utils.batching import bucket_plan

    card = card_line()
    phase("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _build.library()
    phase("build", seconds=time.perf_counter() - t0)

    rng = np.random.default_rng(args.seed)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        write_chmm(generate_profile_hmm(STATES_MATCH, seed=args.seed), f"{tmp}/model.chmm")
        hmm = read_hmm(f"{tmp}/model.chmm")
        phase("model", states=hmm.states_num, symbols=hmm.emit_num, transitions=hmm.trans_num)

        uniform = [rng.integers(0, hmm.emit_num, size=T_LEN).astype(np.int32) for _ in range(LANES)]
        lengths = np.exp(rng.uniform(np.log(200), np.log(T_LEN), size=LANES)).astype(int)
        lengths[:2] = (200, T_LEN)
        ragged = [rng.integers(0, hmm.emit_num, size=int(t)).astype(np.int32) for t in lengths]
        write_ess(uniform, f"{tmp}/uniform.ess")
        write_ess(ragged, f"{tmp}/ragged.ess")
        uniform = read_emit_seq(f"{tmp}/uniform.ess")
        ragged = read_emit_seq(f"{tmp}/ragged.ess")
    plan = bucket_plan([len(s) for s in ragged], lane_block=fused.BB)
    check(plan is not None and len(plan) >= 2, "the ragged set is bucketed")
    phase("sequences", uniform=[LANES, T_LEN], ragged_lanes=len(ragged),
          ragged_symbols=int(sum(len(s) for s in ragged)), buckets=[[len(i), t] for i, t in plan])

    # ---- the main path, with the launch counts read around it ----------
    dec = ViterbiDecoder(hmm, mode="structured", device=dev)
    fd = dec._fused
    check(fd is not None and fd._fs_ok, "the decoder takes the fused kernels, FS class")
    check(fd._scores_arm is fd._fs and fd._path_arm is fd._fs, "the decoder takes the planned arms")
    fused.reset_launches()
    secs = {}
    t0 = time.perf_counter()
    handle = dec.prepare_batch(uniform)
    torch.cuda.synchronize()
    secs["uniform_prepare_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores_u = dec.run_batch(handle)
    torch.cuda.synchronize()
    secs["uniform_run_batch"] = time.perf_counter() - t0
    check(fused.launches == {**ZERO_LAUNCHES, "scores_fs": 1}, "uniform batch ran the FS kernel")
    t0 = time.perf_counter()
    scores_r = dec.decode_batch(ragged)
    secs["ragged_decode_batch"] = time.perf_counter() - t0
    check(fused.launches == {**ZERO_LAUNCHES, "scores_fs": 1, "scores_masked_planned": len(plan)},
          "every ragged bucket ran the planned arm of the masked kernel")
    t0 = time.perf_counter()
    scores_1 = dec.decode(uniform[0])
    secs["decode_one"] = time.perf_counter() - t0
    counts = dict(fused.launches)
    check(counts["scores_fs"] > 0 and counts["scores_masked_planned"] > 0, "both kernels launched")
    n_real = hmm.states_num
    u_np = scores_u.cpu().numpy()
    check(u_np.shape == (LANES, fd.n), "uniform scores shape")
    check(bool(np.isinf(u_np[:, n_real:]).all()), "padding states stay +inf")
    check(bool(np.isfinite(u_np[:, :n_real]).all()), "uniform scores finite")
    check(len(scores_r) == LANES and all(s.shape == (n_real,) for s in scores_r), "ragged shapes")
    check(all(bool(np.isfinite(s).all()) for s in scores_r), "ragged scores finite")
    check(np.array_equal(scores_1, u_np[0, :n_real]), "decode() equals lane 0 of run_batch()")
    phase("main_path", seconds=secs, launches=counts)

    # ---- each kernel against its plain version at the main path's shapes
    seqs_t, lens_t, masked = handle
    check(not masked, "uniform batch is unmasked")
    v0 = fd.em_t[:, seqs_t[0].long()] + fd.pi[:, None]
    obs = seqs_t[1:]
    k_fs = fused.scores_fs(fd._fs, fd.em, v0, obs)
    p_fs = fused.scores_fs_plain(fd._fs, fd.em_t, v0, obs)
    same, err_fs = equal_with_err(k_fs, p_fs)
    check(same, "FS kernel == plain at 512 x 3500")
    check(torch.equal(k_fs.T, scores_u), "FS kernel == run_batch output")
    # both arms of the masked kernel at each ragged bucket: the planned arm
    # (fd._fs) is what decode_batch ran, the generic arm (fd._masked) must
    # give the same scores
    err_masked = {"scores_masked_planned": 0.0, "scores_masked": 0.0}
    for idx, t_q in plan:
        st, ln, m = fd.prepare([ragged[i] for i in idx], t_pad=t_q)
        check(m, "ragged bucket is masked")
        bv0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        for name, t in (("scores_masked_planned", fd._fs), ("scores_masked", fd._masked)):
            k = fused.scores_masked(t, fd.em, bv0, st[1:], ln)
            p = fused.scores_masked_plain(t, fd.em_t, bv0, st[1:], ln)
            same, err = equal_with_err(k, p)
            check(same, f"{name} kernel == plain, bucket of {len(idx)} lanes x {t_q}")
            err_masked[name] = max(err_masked[name], err)
            k_np = k.T.cpu().numpy()
            check(all(np.array_equal(scores_r[i], k_np[j, :n_real]) for j, i in enumerate(idx)),
                  f"decode_batch output == {name} kernel")
    phase("kernel_vs_plain", fs_max_abs_err=err_fs,
          **{f"{k}_max_abs_err": e for k, e in err_masked.items()})

    # ---- plain path and kernels against the numpy oracle on a prefix ---
    small = [s[:64] for s in uniform[:4]]
    small_ragged = [s[: 16 * (j + 1)] for j, s in enumerate(uniform[4:8])]
    want = [viterbi_scores_oracle(hmm, s) for s in small + small_ragged]
    plain_dec = ViterbiDecoder(hmm, use_kernels=False, mode="structured", device=dev)
    check(plain_dec._fused is None, "use_kernels=False pins the plain path")
    plain_got = plain_dec.decode_batch(small + small_ragged, bucketed=False)
    check(all(np.array_equal(g, w) for g, w in zip(plain_got, want)), "plain path == oracle")
    fused.reset_launches()
    kern_got = dec.decode_batch(small) + dec.decode_batch(small_ragged)
    check(fused.launches == {**ZERO_LAUNCHES, "scores_masked_planned": 1, "scores_fs": 1},
          "prefix check ran both kernels")
    check(all(np.array_equal(g, w) for g, w in zip(kern_got, want)), "kernels == oracle")
    phase("oracle", lanes=len(want), bit_equal=True)

    # ---- the path main path, with the launch counts read around it -----
    budget = fd._path_lane_budget
    want_calls = -(-LANES // max(fused.BB, budget(T_LEN)))
    want_calls += sum(-(-len(idx) // max(fused.BB, budget(t))) for idx, t in plan)
    fused.reset_launches()
    psecs = {}
    t0 = time.perf_counter()
    paths_u = dec.decode_path_batch(uniform)
    psecs["uniform_decode_path_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths_r = dec.decode_path_batch(ragged)
    psecs["ragged_decode_path_batch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    path_1 = dec.decode_path(uniform[0])
    psecs["decode_path_one"] = time.perf_counter() - t0
    path_counts = dict(fused.launches)
    check(path_counts == {**ZERO_LAUNCHES, "path_planned": want_calls, "backtrace": want_calls},
          f"every decode_path_batch call ran the planned path arm and the backtrace kernel "
          f"({want_calls} calls)")
    for seqs, got in ((uniform, paths_u), (ragged, paths_r)):
        check(len(got) == len(seqs), "one path per sequence")
        for s, (_, p) in zip(seqs, got):
            check(p.shape == (len(s),) and p.dtype == np.int32, "path length")
            check(bool((p >= 0).all() and (p < n_real).all()), "path states in range")
    check(all(np.array_equal(sc, u_np[i, :n_real]) for i, (sc, _) in enumerate(paths_u)),
          "uniform path scores == run_batch scores")
    check(all(np.array_equal(sc, w) for (sc, _), w in zip(paths_r, scores_r)),
          "ragged path scores == decode_batch scores")
    check(np.array_equal(path_1[0], paths_u[0][0]) and np.array_equal(path_1[1], paths_u[0][1]),
          "decode_path (plain scan) == lane 0 of decode_path_batch")
    # the lane-chunk loop: with the budget lowered to half the uniform set,
    # it takes two calls, stitched back by lane, equal to the run above
    budget_bytes = fd.MAX_PATH_BYTES
    fd.MAX_PATH_BYTES = (T_LEN - 1) * fd.n * 2 * (LANES // 2)
    chunk_calls = -(-LANES // budget(T_LEN))
    fused.reset_launches()
    paths_c = dec.decode_path_batch(uniform)
    chunk_counts = dict(fused.launches)
    fd.MAX_PATH_BYTES = budget_bytes
    check(chunk_calls == 2 and chunk_counts == {**ZERO_LAUNCHES, "path_planned": 2, "backtrace": 2},
          "the lowered budget split the uniform set into two path calls")
    check(all(np.array_equal(c[0], u[0]) and np.array_equal(c[1], u[1]) for c, u in zip(paths_c, paths_u)),
          "two lane-chunked path calls == the main path's uniform paths and scores")
    phase("path_main", seconds=psecs, launches=path_counts, calls=want_calls, chunked_calls=chunk_calls)

    # ---- the path kernels against their plain versions -----------------
    half = min(LANES, budget(T_LEN))  # the lanes of a uniform path call under the budget
    big_idx, big_t = max(plan, key=lambda e: e[1])
    err_path = {"path_planned": 0.0, "path": 0.0}
    err_bt = 0.0
    plain_path_s = {}
    for name, seqs, t_pad in (
        ("uniform", uniform[:half], T_LEN),
        ("ragged_bucket", [ragged[i] for i in big_idx], big_t),
    ):
        st, ln, m = fd.prepare(seqs, t_pad=t_pad)
        check(m == (name == "ragged_bucket"), f"{name} call masking")
        pv0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        lens = ln if m else None
        # the planned arm first (what decode_path_batch ran), then the
        # generic arm on the same inputs: both equal their plain versions
        # and each other
        srcs = []
        for arm, t in (("path_planned", fd._fs), ("path", fd._masked)):
            k_out, k_src = fused.path(t, fd.em, pv0, st[1:], lens)
            t0 = time.perf_counter()
            p_out, p_src = fused.path_plain(t, fd.em_t, pv0, st[1:], lens)
            torch.cuda.synchronize()
            plain_path_s[f"{arm}_{name}"] = time.perf_counter() - t0
            same, err = equal_with_err(k_out, p_out)
            check(same, f"{arm} kernel carry == plain, {name} ({len(seqs)} x {st.shape[0] - 1})")
            check(torch.equal(k_src, p_src), f"{arm} kernel backpointers == plain, {name}")
            err_path[arm] = max(err_path[arm], err)
            del p_src
            srcs.append((k_out, k_src))
        check(torch.equal(srcs[0][0], srcs[1][0]) and torch.equal(srcs[0][1], srcs[1][1]),
              f"planned path arm == generic path arm, {name}")
        k_out, k_src = srcs[0]
        del srcs
        last = torch.argmin(k_out, dim=0).to(torch.int32)
        k_rev = fused.backtrace(k_src, last)
        p_rev = fused.backtrace_plain(k_src, last)
        check(torch.equal(k_rev, p_rev), f"backtrace kernel == plain, {name}")
        err_bt = max(err_bt, float((k_rev - p_rev).abs().max()))
        if name == "uniform":
            check(torch.equal(k_out.T, scores_u[:half]), "path kernel carry == FS kernel scores")
            bt_args = (k_src, last)
            path_args = (pv0, st[1:])
        del k_src, k_rev, p_rev
    phase("path_kernel_vs_plain", backtrace_max_abs_err=err_bt, plain_path_seconds=plain_path_s,
          **{f"{k}_max_abs_err": e for k, e in err_path.items()})

    # ---- paths against the numpy path oracle ---------------------------
    tie_hmm = generate_tie_heavy_hmm(300, seed=args.seed)
    tie_dec = ViterbiDecoder(tie_hmm, mode="structured", device=dev)
    check(tie_dec._fused is not None, "the tie-heavy model takes the kernels")
    tie_rng = np.random.default_rng(args.seed + 1)
    tie_seqs = [tie_rng.integers(0, tie_hmm.emit_num - 1, size=int(t)).astype(np.int32)
                for t in [64] * 4 + [1, 2, 40, 63]]
    tie_seqs[3][30] = tie_hmm.emit_num - 1  # the dead symbol
    cases = (
        (hmm, dec, [s[:64] for s in uniform[:3]]),
        (hmm, dec, [s[: 16 * (j + 1)] for j, s in enumerate(ragged[3:6])]),
        (tie_hmm, tie_dec, tie_seqs[:4]),
        (tie_hmm, tie_dec, tie_seqs[4:]),
    )
    fused.reset_launches()
    for model, d, seqs in cases:
        for (sc, p), s in zip(d.decode_path_batch(seqs), seqs):
            want_sc, want_p = viterbi_path_oracle(model, s)
            check(np.array_equal(sc, want_sc) and np.array_equal(p, want_p),
                  f"path decode == oracle ({model.states_num} states, {len(s)} symbols)")
    check(fused.launches["path_planned"] == 2 and fused.launches["path"] == 2,
          "the oracle checks ran both arms of the path kernel")
    phase("path_oracle", lanes=sum(len(c[2]) for c in cases), bit_equal=True)

    # ---- streaming on the kernels ----------------------------------------
    eng = dec.streaming()
    check(eng is fd, "streaming() hands out the fused engine")
    block = np.stack(uniform, axis=1)  # [T, B]
    fused.reset_launches()
    ssecs = {}
    t0 = time.perf_counter()
    st = eng.stream_begin(block[0])
    pos = 1
    for w in STREAM_CHUNKS:
        st = eng.stream_feed(st, block[pos : pos + w])
        pos += w
    got = eng.stream_scores(st)
    ssecs["scores_stream"] = time.perf_counter() - t0
    check(fused.launches == {**ZERO_LAUNCHES, "scores_masked_planned": len(STREAM_CHUNKS)},
          "one launch of the planned masked arm per feed")
    check(np.array_equal(got, u_np[:, :n_real]), "stream scores == run_batch scores (masked == FS)")
    stream_counts = {"scores": dict(fused.launches)}

    lens_r = np.array([len(s) for s in ragged])
    block_r = np.zeros((T_LEN, LANES), np.int32)
    for i, s in enumerate(ragged):
        block_r[: len(s), i] = s
    fused.reset_launches()
    t0 = time.perf_counter()
    st = eng.stream_begin_path(block_r[0])
    pos = 1
    for k, w in enumerate(STREAM_CHUNKS):
        st = eng.stream_feed_path(st, block_r[pos : pos + w], valid=np.clip(lens_r - pos, 0, w))
        pos += w
        if k == 1:  # persist and resume mid-stream
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
                eng.stream_save(st, f"{tmp}/stream.npz")
                loaded = eng.stream_load(f"{tmp}/stream.npz")
            check(torch.equal(loaded.carry, st.carry) and len(loaded.chunks) == 2,
                  "stream_load restores the saved state")
            st = loaded
    check(fused.launches == {**ZERO_LAUNCHES, "scores_masked_planned": len(STREAM_CHUNKS)},
          "one launch of the planned masked arm per path feed")
    scores_s, paths_s = eng.stream_path_finalize(st)
    torch.cuda.synchronize()
    ssecs["path_stream"] = time.perf_counter() - t0
    check(fused.launches == {**ZERO_LAUNCHES, "scores_masked_planned": len(STREAM_CHUNKS),
                             "path_planned": len(STREAM_CHUNKS), "backtrace": len(STREAM_CHUNKS)},
          "finalize ran one planned path and one backtrace launch per chunk")
    check(paths_s.shape == (LANES, T_LEN), "path stream shape")
    for i, (sc, p) in enumerate(paths_r):
        check(np.array_equal(scores_s[i], sc) and np.array_equal(paths_s[i, : lens_r[i]], p),
              "path stream == decode_path_batch")
    stream_counts["path"] = dict(fused.launches)
    phase("stream", seconds=ssecs, launches=stream_counts, chunks=list(STREAM_CHUNKS))

    # ---- every backtrace call of the main path again, each held to its
    # plain version and to the staged walk's emulation, which counts its
    # misses
    bt_calls = []
    for label, fn, want in (
        ("uniform decode_path_batch", lambda: dec.decode_path_batch(uniform), paths_u),
        ("ragged decode_path_batch (buckets)", lambda: dec.decode_path_batch(ragged), paths_r),
    ):
        got = checked_backtraces(label, fn, bt_calls)
        check(all(np.array_equal(p, w) for (_, p), (_, w) in zip(got, want)), f"{label} again")
    again = checked_backtraces("path stream finalize (chunks)", lambda: eng.stream_path_finalize(st), bt_calls)
    check(np.array_equal(again[1], paths_s), "path stream finalize again")

    generic_counts, generic_errs = generic_main(args.seed, lengths)
    minplus_entry = dense_and_spec(args.seed, card, hmm, uniform, ragged, scores_u, scores_r, paths_u[0])
    window_kernels, window_floors = tp_and_dp(args.seed, card, lengths, fd, ragged, scores_r, bt_calls)
    main_calls = [c for c in bt_calls if not c["call"].startswith(("TP", "DP"))]
    lane_calls = sum(c["lanes"] for c in main_calls)
    phase("backtrace_misses", card=card, band=_build.BT_BAND, tile=_build.BT_TILE, ahead=_build.BT_AHEAD,
          calls=bt_calls, main_path_misses_a_lane=sum(c["misses_a_lane_mean"] * c["lanes"]
                                                       for c in main_calls) / lane_calls,
          bit_equal=True)
    phase("fs_shape", card=card, **{f"lanes_{b}": fused.scores_fs_shape(fd.n, b, dev)
                                    for b in (LANES, TP_PATH_LANES, 128)})
    probe_kernels, floors = probes_phase(args.seed, card, hmm, fd, seqs_t, window_floors)

    # ---- times at the uniform shape: each arm of the masked and path
    # kernels on the corpus model's inputs (the planned arms are what its
    # main path runs; the generic arms would run the same calls without
    # the plans) ------------------------------------------------------------
    steps = obs.shape[0]
    sop = fd.sop
    # one count of the operator's work, whichever kernel or arm runs it
    op_step = bounds.operator_step(sop.n, len(sop.diag_offsets), len(sop.row_idx), len(sop.col_idx),
                                   planned=fd._fs is not None)
    arm = {"scores_masked": fd._masked, "scores_masked_planned": fd._fs,
           "path": fd._masked, "path_planned": fd._fs}
    bound = {
        "scores_fs": bounds.fs_scores(op_step, LANES, steps, hmm.emit_num).bound(),
        "backtrace": bounds.backtrace(half, steps).bound(),
    }
    timed = {
        "scores_fs": (
            median_ms(lambda: fused.scores_fs(fd._fs, fd.em, v0, obs)),
            median_ms(lambda: fused.scores_fs_plain(fd._fs, fd.em_t, v0, obs)),
        ),
    }
    for name in ("scores_masked_planned", "scores_masked"):
        bound[name] = bounds.masked_scores(op_step, LANES, steps, LANES * steps, hmm.emit_num,
                                           True).bound()
        timed[name] = (
            median_ms(lambda: fused.scores_masked(arm[name], fd.em, v0, obs, lens_t)),
            median_ms(lambda: fused.scores_masked_plain(arm[name], fd.em_t, v0, obs, lens_t)),
        )
    # the chain floors (probes phase): the empty step at the FS kernel's
    # shape; for the backtrace, a shared-memory hop a step (the staged
    # walk) beside one load of the 4.36 GB tensor a step (the walk before)
    chain = {"scores_fs": {"chain_floor_ms": floors["scores_fs"]},
             "backtrace": {"chain_floor_ms": floors["backtrace"],
                           "chain_floor_one_load_a_step_ms": floors["backtrace_hbm"]}}
    for name, (ms, plain_ms) in timed.items():
        phase("time", kernel=name, card=card, lanes=LANES, steps=steps,
              ms=ms, us_per_step=ms * 1e3 / steps, symbols_per_s=LANES * T_LEN / (ms / 1e3),
              plain_ms=plain_ms, plain_us_per_step=plain_ms * 1e3 / steps,
              plain_symbols_per_s=LANES * T_LEN / (plain_ms / 1e3),
              bound_ms=bound[name][0], bound_by=bound[name][1], **chain.get(name, {}))
    pv0, pobs = path_args
    for name in ("path_planned", "path"):
        bound[name] = bounds.path(op_step, half, steps, half * steps, hmm.emit_num, False).bound()
        timed[name] = (
            median_ms(lambda: fused.path(arm[name], fd.em, pv0, pobs, None)),
            median_ms(lambda: fused.path_plain(arm[name], fd.em_t, pv0, pobs, None),
                      repeats=PLAIN_PATH_REPEATS),
        )
    timed["backtrace"] = (
        median_ms(lambda: fused.backtrace(*bt_args)),
        median_ms(lambda: fused.backtrace_plain(*bt_args)),
    )
    for name in ("path_planned", "path", "backtrace"):
        ms, plain_ms = timed[name]
        phase("time", kernel=name, card=card, lanes=half, steps=steps, ms=ms,
              us_per_step=ms * 1e3 / steps, repeats=REPEATS, plain_ms=plain_ms,
              plain_us_per_step=plain_ms * 1e3 / steps,
              plain_repeats=REPEATS if name == "backtrace" else PLAIN_PATH_REPEATS,
              bound_ms=bound[name][0], bound_by=bound[name][1], **chain.get(name, {}))

    # ---- each kernel's loss against its bound on its main path: a uniform
    # run_batch (FS); a ragged decode_batch (the masked kernel, one launch a
    # bucket); a uniform and a ragged decode_path_batch (path and backtrace,
    # 2 + 4 launches); a TP decode_batch and a 256-lane TP decode_path_batch
    # (219 window launches each; the path decode's time holds its
    # backtrace). Each arm of the masked and path kernels is its own entry,
    # on the same calls. The ragged buckets are timed one by one.
    per_call = {name: [0, 0.0, 0.0] for name in ("scores_fs", *arm, "backtrace")}

    def add(name, launches, ms, work):
        per_call[name][0] += launches
        per_call[name][1] += launches * ms
        per_call[name][2] += launches * work.bound()[0]

    add("scores_fs", 1, timed["scores_fs"][0], bounds.fs_scores(op_step, LANES, steps, hmm.emit_num))
    calls = -(-LANES // max(fused.BB, half))
    for name in ("path_planned", "path"):
        add(name, calls, timed[name][0], bounds.path(op_step, half, steps, half * steps, hmm.emit_num, False))
    add("backtrace", calls, timed["backtrace"][0], bounds.backtrace(half, steps))
    # the chain floor of a main-path call: the FS launch's, and a
    # shared-memory hop for every step of every backtrace launch
    hop_ms = floors["backtrace"] / steps
    call_floor = {"scores_fs": floors["scores_fs"], "backtrace": calls * steps * hop_ms}
    bucket_times = []
    for idx, t_q in plan:
        st, ln, _ = fd.prepare([ragged[i] for i in idx], t_pad=t_q)
        bv0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        b_steps, b_lanes = st.shape[0] - 1, len(idx)
        lane_steps = int((ln.long() - 1).clamp(0, b_steps).sum())
        row = {"lanes": b_lanes, "steps": b_steps}
        for name, t in arm.items():
            if name.startswith("path"):
                ms = median_ms(lambda: fused.path(t, fd.em, bv0, st[1:], ln))
                work = bounds.path(op_step, b_lanes, b_steps, lane_steps, hmm.emit_num, True)
            else:
                ms = median_ms(lambda: fused.scores_masked(t, fd.em, bv0, st[1:], ln))
                work = bounds.masked_scores(op_step, b_lanes, b_steps, lane_steps, hmm.emit_num, True)
            add(name, 1, ms, work)
            row[f"{name}_ms"] = ms
        out, src = fused.path(fd._fs, fd.em, bv0, st[1:], ln)
        last = torch.argmin(out, dim=0).to(torch.int32)
        row["backtrace_ms"] = median_ms(lambda: fused.backtrace(src, last))
        del out, src
        add("backtrace", 1, row["backtrace_ms"], bounds.backtrace(b_lanes, b_steps))
        call_floor["backtrace"] += b_steps * hop_ms
        bucket_times.append(row)
    phase("time", kernel="ragged_buckets", card=card, buckets=bucket_times)
    for e in window_kernels:
        per_call[e["name"]] = [e["decode_launches"], e["decode_ms"], e["decode_bound_ms"]]
    rank = sorted(((name, n, ms, b, ms - b) for name, (n, ms, b) in per_call.items()),
                  key=lambda r: -r[4])
    on_main = {"scores_masked": False, "path": False}  # the corpus main path runs the planned arms
    phase("rank", card=card, by="sum over a main path's launches of (time - bound), ms",
          order=[{"name": name, "launches": n, "ms": ms, "bound_ms": b, "loss_ms": loss,
                  "on_corpus_main_path": on_main.get(name, True),
                  **({"chain_floor_ms": call_floor[name]} if name in call_floor else {})}
                 for name, n, ms, b, loss in rank])

    struct_and_bench(args.seed, card, hmm, uniform, ragged, scores_u, scores_r, plan)

    # launches: the planned arms' from the corpus model's main path, the
    # generic arms' from generic_main's
    entries = (
        ("scores_fs", "scores.cu", "spec_viterbi_tpu/ops/fused_pallas.py:360", counts, err_fs, LANES),
        ("scores_masked_planned", "scores.cu", "spec_viterbi_tpu/ops/fused_pallas.py:203", counts,
         err_masked["scores_masked_planned"], LANES),
        ("scores_masked", "scores.cu", "spec_viterbi_tpu/ops/fused_pallas.py:203", generic_counts,
         max(err_masked["scores_masked"], generic_errs["scores_masked"]), LANES),
        ("path_planned", "path.cu", "spec_viterbi_tpu/ops/fused_pallas.py:490", path_counts,
         err_path["path_planned"], half),
        ("path", "path.cu", "spec_viterbi_tpu/ops/fused_pallas.py:490", generic_counts,
         max(err_path["path"], generic_errs["path"]), half),
        ("backtrace", "path.cu", "spec_viterbi_tpu/ops/fused_pallas.py:695", path_counts, err_bt, half),
    )
    kernels = [
        {"name": name, "route": "cuda", "source": f"spec_viterbi_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launched[name], "max_abs_err": err,
         "ms": timed[name][0], "plain_ms": timed[name][1],
         "bound_ms": bound[name][0], "bound_by": bound[name][1], "library_ms": None,
         "shape": f"{lanes} lanes x {steps} steps", **chain.get(name, {})}
        for name, src, replaces, launched, err, lanes in entries
    ] + window_kernels + probe_kernels + [minplus_entry]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
