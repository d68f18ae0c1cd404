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
    a TP and a DP path call (steps 18 and 21): the ``backtrace_misses``
    line, the emulation's misses a lane of each call; then ``fs_shape``,
    the shape ``svt_scores_fs`` takes at 512, 256 and 128 lanes (threads a
    lane, lanes a CTA, registers, CTAs an SM);
12. ``generic_main`` and ``generic_kernel_vs_plain``: the two models
    outside the uniform plans whose main path is the generic arms of the
    masked and path kernels (the seeded tie-heavy model at 2,405 states;
    the TP phase's banded model, 2,432 states, offsets (1, 3), decoded
    whole), each through ``decode_batch`` and ``decode_path_batch`` of a
    uniform set (512 × 3,500) and a ragged set (the lengths of step 4),
    with the launch counts read around each run; both generic kernels
    against their plain versions on 512 lanes × 511 steps, and the decodes
    against the oracle on a prefix; then each arm's ``time`` line on the
    uniform set (with its launch's shape, ``fused.generic_shape``, and on
    the tie-heavy model the plain versions' times) and at each ragged
    bucket (``generic_ragged_buckets``), each with its bound from the
    model's own generic count;
13. ``dense_main``: ``ViterbiDecoder(mode="dense", device="cuda")`` at the
    dense baseline's shape, the first 50 lanes of the uniform set
    (``prepare_batch``/``run_batch``), ``decode_batch`` of the first 50
    ragged sequences, ``decode`` and ``decode_path`` of one, with the
    ``svt_minplus`` and fused launch counts read around that run (no fused
    kernel; ``run_batch`` one ``svt_minplus`` launch a step, no other
    device kernel in its loop under ``torch.profiler`` and no allocation
    in it); dense scores bit-equal to step 5's (the FS kernel's and the
    masked kernel's) and the dense path to lane 0 of step 8's; ``auto``
    resolving to dense on a seeded dense-class model (1,024 states, 256
    transitions a state), held to the oracle on 4 x 64;
14. ``dense_kernel_vs_plain``: ``svt_minplus`` against ``minplus_plain``
    on one full dense batch step, a 64-step prefix of ``run_batch``, the
    J = 1 argmin arm and ragged-edge shapes (both layouts, gathered), then
    at pinned cluster sizes 1, 2 and 8 (all-inf rows, a K too short for
    the cluster); the one-launch step (``dense_step``) with ``t`` at a
    lane's length, 64-step prefixes of the new loop against the plain loop
    (uniform; lanes frozen at 0-64 steps), and the J = 1 step writing its
    argmin into a pointer row (``dense_step_mv``): bit-equal;
15. ``spec_main``: ``SpecializedViterbi(level=1)`` delegating to the fused
    decoder (``svt_scores_fs``), then level 2: the slowdown warning,
    ``spec_with`` (441 products, a 10.43 GB stack; peak device memory),
    ``run_spec_batch`` of the 50 uniform and 50 ragged sequences and
    ``run_spec`` of one, within ±1.0 of the dense scores (the largest
    difference printed), 4 of the products and a 16-chunk prefix of the
    gathered decode held to the plain version; then ``svt_minplus``'s
    ``time`` lines (the dense ``run_batch`` with the kernel's device µs a
    launch in the decoder's loop, the host's µs a step, the idle share,
    tile, thread tile, cluster and stages; the J = 1 step with and
    without argmin, the level-2 build, the gathered level-2 decode of 50
    x 1,749 chunks), each beside its bound and held to it (neither its
    event time nor its device time may read below it: the J = 1 lines
    take 8 copies of the operator in turn, so each launch reads it from
    HBM as the bound counts it, and give the decode loop's one reused,
    L2-resident operator beside them as ``resident_*``); the stack is
    freed;
16. ``parallel_rest``: the local forms of the rest of ``parallel/`` on
    the card, on this model, each bit-equal to the unsharded result above:
    ``decode_batch_dp`` (data 2) on the 50 uniform and 50 ragged
    sequences (the dense ``run_batch`` and ``decode_batch``),
    ``decode_tp`` (state 4, row blocks of [608, 2,432]) on one sequence
    (the dense ``decode``), ``decode_batch_dp_tp`` (2 x 2, row blocks of
    [1,216, 2,432] with ``row0``) on the 50 uniform sequences,
    ``decode_batch_structured_tp`` (state 4) on both 512-lane sets and
    ``decode_batch_structured_dp`` (data 2) on the ragged set (the fused
    decoder's scores), and ``StreamDP`` (data 2) on both sets in the
    ``stream`` phase's chunks (its scores and paths); one line an entry
    point with its launches, warm seconds (median of 3), the host's µs a
    step against the device's µs a launch and its idle share (a 200-step
    prefix under ``torch.profiler``); then the ``time`` lines of
    ``svt_minplus``'s two new shapes, each held to its bound: the TP
    block's J = 1 step (32 copies in turn, so each launch reads from
    HBM) and the DP x TP block's batch step; every shape these entry
    points give ``svt_minplus`` is held bit-equal to its plain version:
    the J = 1 step of each of the 4 state blocks (its strided rows of
    ``em_t``) on the first and the last carry, each DP shard's 32-lane
    step of both sets (the ragged one where its shortest lane stops) and
    the DP x TP block step;
17. ``time_parallel``: ``TimeParallelDecoder`` (``ops/time_parallel.py``) on
    this model and the first uniform sequence, block lengths 4, 8 and 16,
    each with the scan and the tree compose: ``decode`` and
    ``decode_path(seq, engine=fd)``, with the launch counts read around one
    call (``svt_minplus`` two a compose step or level and two a block of
    the fold; ``svt_path_planned`` for the blocks' remat and for the tail;
    one ``svt_backtrace``); scores with the +inf pattern of the serial
    one-lane ``decode`` (the FS kernel) and within ±1.0 of it, paths equal
    to ``fd.decode_path_batch([seq])``'s, the k = 8 scan bit-equal to the
    same decoder on the CPU; every new ``svt_minplus`` shape, every path
    launch and every walk held to its plain version on the same operands;
    warm seconds (median of 3) beside the serial decode's, the speedup,
    the split (compose, fold, tail, remat, walk) and the fold's host µs a
    block against its device µs and idle share; then the dense SP
    (``decode_time_parallel``, a local time group of 4, the first 1,000
    symbols) within ±1.0 of the dense decode; the ``time`` lines of every
    new ``svt_minplus`` shape, each held to its bound;
18. ``tp_main``: the state-sharded decode of a seeded banded model (2,432
    states, offsets (1, 3), 4 symbols) on a local group of 4 shards, chunk
    16: ``FusedTPDecoder.decode_batch`` and ``decode_path_batch`` on a
    uniform (512 × 3,500) and a ragged set (the lengths of step 4), with
    the launch counts read around each call (219 window launches a call,
    one backtrace a path call); scores, paths and the global pointer
    tensor bit-equal to the unsharded kernels';
19. ``tp_kernel_vs_plain``: both window kernels against their plain
    versions on the first 4 chunks, uniform and ragged, in the local form
    and in the rank form of every shard (one window, window-local
    pointers), and ``decode_batch_emulated(check_path_kernel=True)`` on
    128 lanes;
20. ``tp_oracle``: TP paths and scores against ``viterbi_path_oracle`` on
    a prefix and on a seeded tie-heavy banded model: bit-equal;
21. ``dp``: the fused DP entry points on a world-size-1 NCCL group,
    bit-equal to the single-device decode;
22. ``tp_dist``: with two or more cards, TP on 2 or 4 NCCL ranks,
    bit-equal to the local group, then ``parallel_rest``'s dense DP, TP,
    structured TP and ``StreamDP`` over those ranks (and DP x TP as 2 x 2
    on 4), bit-equal to the unsharded results, and the dense SP over
    ``time``, bit-equal to a local group of as many shards; with one card
    it says so;
23. time kernel and plain version of the window kernels (the whole TP
    decode, and kernel vs plain on the first 4 chunks, beside the
    unsharded kernels on the same model and lanes); then both window
    kernels in both launch forms through the decoder's chunk loops
    (``spec_viterbi_tpu_torch/probes/windows.py``: the local group, and one
    rank's launches on a group with no peers), each with its bound, the
    host's µs a chunk and the device's idle share; the device time of one
    launch against its steps (0 to 1,024); and an ``occupancy_*_window``
    line for each kernel;
23b. ``scheduler_cli`` (``scheduler_auto``, ``scheduler_routes``,
    ``scheduler_cli``, ``native_parser`` lines): ``decode_auto`` on both
    512-lane sets, scores and paths (the ``batch`` route: 1 FS launch, one
    planned masked launch a bucket, the path calls of step 8), bit-equal to
    the main path, with the split of a call (``plan_ms``, ``construct_ms``,
    ``decode_ms``) against the warm direct call; ``execute_route`` for
    every other route, each bit-equal to its direct entry point with its
    launches counted: ``dp`` on ``make_grid(data=2)`` (both sets and the
    uniform paths), ``tp_chunked`` on the banded model of step 18 under a
    budget of half its arrays (219 window launches; paths on 64 lanes),
    ``time_parallel`` on one sequence on request (k = 8, through
    ``decode_auto``), ``tp_halo`` on this model at state 4 (512 lanes of a
    200-step prefix, no kernel; capacity-bound paths refused), and
    ``stream_engine`` on 64 lanes in the ``stream`` chunks; then the CLI in
    process (``decode`` on the 512-lane ``.ess``, ``--path`` and
    ``--stream-chunk 1000`` on 64 lanes, ``--time-parallel 8`` on one
    sequence, ``info``), its stdout equal to the direct results' lines;
    then the native parser, built and taken by ``read_hmm`` and
    ``read_emit_seq``, equal to the Python tokenizer, with the host ms of
    each on the ``.chmm`` and the 512 x 3,500 ``.ess``;
24. ``probes``: the H100 probes (``spec_viterbi_tpu_torch.probes``) on the
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
25. time kernel and plain version of the scores kernels at the uniform
    shape and the path kernels at one uniform path call (median of 5; the
    plain path scans on fewer repeats, as their lines say), each arm of
    the masked and path kernels on its own line; both arms of the masked
    and path kernels and the backtrace kernel at each ragged bucket; then
    ``rank``: per kernel and arm, the sum over one call of its main path
    of (time - bound), the order in which the kernels lose most against
    their bounds (the generic arms forced on the same calls, marked as
    off the corpus model's main path and bound by their generic count;
    and the generic arms on the main path of step 12's two models, a
    uniform and a ragged call of each decode, marked ``on_main_path_of``).
    The FS kernel's and the backtrace's ``time``, ``rank`` and
    ``kernels`` entries carry their chain floors.
26. ``spec_struct``: ``StructuredSpecializedViterbi(level=2)`` on the
    corpus model: the factored form (the fused decoder) through
    ``run_spec_batch`` on both sets and ``run_spec`` on one sequence, with
    the launch counts read around that run (one FS launch a uniform call,
    one planned masked launch a ragged bucket), bit-equal to
    ``decode_batch``; then the composed form (``use_kernels=False``, plain
    PyTorch, no kernel) on 8 uniform and 4 ragged lanes: within ±1.0 of the
    dense scores and bit-equal to the same composed code on the CPU; the
    host seconds of each form on those lanes; the ``hostmem`` line: the
    level-2 compose's slab allocation and fill with ``np.empty`` and with
    ``utils.hostmem.populate_empty``, in turn, 3 times each;
27. ``bench``: the headline line (``spec_viterbi_tpu_torch.bench.headline``,
    the entry point's default inputs: this model and the first 50 uniform
    sequences) at full size: 16 pre-staged batches of 512 x 3,500, the
    dense baseline, the ``empty`` floor at 2,432 x 512, the bit-equality
    gate;
28. ``bench_sweep``: both ``.dat`` sweeps (``bench/bench_viterbi.py``)
    over this model and a 502-state profile model on the 50 sequences,
    2 timed runs a cell, the spec sweep's prep once; NaN exactly where the
    8 GB memory policy says;
29. ``bench_ragged``: the ragged bench (``bench/bench_ragged.py``) on this
    model with the ragged set's lengths, both path columns with their
    peak allocated memory against the pointer budget (``path_peak``
    lines).

Every ``kernels`` entry carries its bound (``spec_viterbi_tpu_torch/
probes/bounds.py``: the larger of its f32 operations over 33.45 T/s and
its bytes over 3.35 TB/s; one count of an operator's work for each arm:
the planned count for the planned arms, the generic count for the generic
arms) for the work it was timed on; the planned arms' launches come
from the corpus model's main path, the generic arms' from
``generic_main`` (their times and bounds from the tie-heavy model's
uniform launch, with the banded model's and the forced stand-in's beside
them), ``minplus``'s from ``dense_main``, ``spec_main``,
``parallel_rest`` and ``time_parallel``, which adds its launches of the
planned path arm and the backtrace to theirs; ``scheduler_cli`` adds its
launches of every kernel its routes run (``scheduler_cli_launches``). The
line before the card's line is that JSON object with one entry per kernel;
the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
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
DENSE_TIME_REPEATS = 2  # repeats of the dense time lines
DENSE_SETUP_EVENTS = 6  # device kernels of a dense run_batch besides its steps (the first carry)
DENSE_SETUP_ALLOCS = 8  # blocks a dense run_batch allocates (the first carry and its pair)
DENSE_HOST_STEPS = 200  # steps of the prefix whose enqueue gives the host's µs a step
CLUSTER_EDGE = (1, 2, 8)  # pinned cluster sizes of the edge cases
PAR_DATA, PAR_STATE, PAR_GRID = 2, 4, (2, 2)  # parallel_rest's shards: DP, TP, DP x TP
PAR_REPEATS = 3  # warm runs of each parallel_rest entry point (median)
PAR_PREFIX = 200  # steps of the prefix whose enqueue and profile give the µs a step
TP_COLD_COPIES = 32  # 32 copies of a 5.9 MB TP block: each launch reads its block from HBM
AUTO_STATES, AUTO_TRANS = 1024, 256  # the seeded dense-class model on which auto resolves to dense
SPEC_PLAIN_PRODUCTS = ((0, 0), (7, 13), (19, 20), (20, 5))  # (new symbol, earlier) of the level-2 build
SPEC_PLAIN_CHUNKS = 16  # chunks of the gathered decode held to the plain version
J1_COLD_COPIES = 8  # operators the J = 1 time lines take in turn: 190 MB, well past the 50 MB L2
TPAR_KS = (4, 8, 16)  # block lengths of the time-parallel decoder, each with both compose schedules
TPAR_REPEATS = 3  # warm runs of each time-parallel call and part (median)
SP_SHARDS, SP_PREFIX = 4, 1000  # the dense SP: a local time group of 4, the first 1,000 symbols
TP_PATH_LANES = 256  # the pointer comparison and the path timing
TP_PLAIN_CHUNKS = 4  # chunks of the kernel-vs-plain checks and timings
TP_EMULATED_LANES = 128
DP_PATH_LANES = 128
SPAWN_SECONDS = 600
STRUCT_LEVEL = 2  # the structured specializer's level in spec_struct
STRUCT_COMPOSED_UNIFORM, STRUCT_COMPOSED_RAGGED = 8, 4  # lanes of the composed form's prefix
HOSTMEM_REPEATS = 3  # level-2 composes timed with each slab allocator (median)
SCHED_REPEATS = 3  # runs of each part of the decode_auto split (median)
SCHED_PATH_LANES = 64  # lanes of the tp_chunked route's path call
SCHED_STREAM_LANES = 64  # lanes of the stream route and of the CLI's --path and --stream-chunk runs
SCHED_CLI_CHUNK = 1000  # the CLI's --stream-chunk
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


def stream_dp_scores(sdp, block):
    """``StreamDP`` scores of the [T, B] ``block`` fed in ``STREAM_CHUNKS``."""
    st = sdp.begin(block[0])
    pos = 1
    for w in STREAM_CHUNKS:
        st = sdp.feed(st, block[pos : pos + w])
        pos += w
    return sdp.scores(st)


def stream_dp_paths(sdp, block, lens):
    """``StreamDP`` (path scores, paths) of ``block`` fed in
    ``STREAM_CHUNKS``, lane ``i`` valid for its first ``lens[i]`` symbols."""
    st = sdp.begin_path(block[0])
    pos = 1
    for w in STREAM_CHUNKS:
        st = sdp.feed_path(st, block[pos : pos + w], valid=np.clip(lens - pos, 0, w))
        pos += w
    return sdp.path_finalize(st)


def _tp_dist_rank(rank: int, world: int, init_file: str, data_file: str, out_file: str,
                  seed: int, rest_file: str) -> None:
    """One NCCL rank of ``tp_dist``, card ``rank``: the banded model's TP
    decode on a distributed group, then ``parallel_rest``'s entry points on
    the corpus model over the world (dense DP, TP and, on 4 ranks, DP x TP
    as 2 x 2; the structured TP; ``StreamDP``; the dense SP over ``time``),
    each run twice, the second run timed; rank 0 writes what it decoded."""
    import pickle

    import torch

    from spec_viterbi_tpu_torch import ViterbiDecoder
    from spec_viterbi_tpu_torch.io import generate_banded_hmm
    from spec_viterbi_tpu_torch.models.decoder import DeviceHMM
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
    from spec_viterbi_tpu_torch.parallel import (
        DATA_AXIS,
        TIME_AXIS,
        FusedTPDecoder,
        StreamDP,
        decode_batch_dp,
        decode_batch_dp_tp,
        decode_batch_structured_tp,
        decode_time_parallel,
        decode_tp,
        init_distributed,
        make_grid,
        make_group,
        state_block,
    )

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
        out = {"scores": scores, "path_scores": np.stack([sc for sc, _ in got]),
               "paths": np.stack([p for _, p in got]), "seconds": np.array(secs[2:])}

        with open(rest_file, "rb") as f:
            r = pickle.load(f)
        corpus = r["hmm"]
        dhmm = DeviceHMM.from_hmm(corpus, device=dev)
        data, state = make_group(dev, axis=DATA_AXIS), make_group(dev)
        tp_block = state_block(corpus, state, device=dev)  # this rank's [Nb, Np] rows
        out["dense_tp_block"] = np.array(tp_block.a_t.shape)
        sdp = StreamDP(ViterbiDecoder(corpus, mode="structured", device=dev)._fused, data)
        runs = {
            "dense_dp": lambda: np.stack(decode_batch_dp(dhmm, r["lanes_u"], data)),
            "dense_tp": lambda: decode_tp(tp_block, r["lanes_u"][0], state),
            "structured_tp": lambda: np.stack(decode_batch_structured_tp(corpus, r["ragged"], state)),
            "stream_scores": lambda: stream_dp_scores(sdp, r["block"]),
            "stream_paths": lambda: np.concatenate(stream_dp_paths(sdp, r["block_r"], r["lens_r"]), axis=1),
            "sp": lambda: decode_time_parallel(corpus, r["lanes_u"][0][:SP_PREFIX], make_group(dev, axis=TIME_AXIS)),
        }
        if world == 4:
            grid = make_grid(dev, 2, 2, distributed=True)
            grid_block = state_block(corpus, grid.state, device=dev)
            runs["dense_dp_tp"] = lambda: np.stack(decode_batch_dp_tp(grid_block, r["lanes_u"], grid))
        for name, fn in runs.items():
            for _ in range(2):
                torch.distributed.barrier(device_ids=[rank])
                t0 = time.perf_counter()
                out[name] = fn()
                out[f"{name}_seconds"] = np.float64(time.perf_counter() - t0)
        if rank == 0:
            np.savez(out_file, **out)
    finally:
        torch.distributed.destroy_process_group()


def tp_dist(seed: int, uniform: list, scores, paths, tmp: str, rest: dict) -> None:
    """``tp_dist``: TP scores and paths on 2 or 4 NCCL ranks, one card
    each, bit-equal to the local group's (``scores``, ``paths``); then
    ``parallel_rest``'s entry points on the corpus model over the ranks,
    bit-equal to the unsharded results in ``rest``, and the dense SP over
    the ranks, bit-equal to a local time group of as many shards."""
    import multiprocessing as mp
    import pickle

    import torch

    from spec_viterbi_tpu_torch.hmm import pad_to_lane
    from spec_viterbi_tpu_torch.parallel import TIME_AXIS, decode_time_parallel, make_group

    count = torch.cuda.device_count()
    if count < 2:
        phase("tp_dist", ran=False, why=f"{count} card")
        return
    world = 4 if count >= 4 else 2
    # the dense SP on a local time group of as many shards as ranks
    sp_local = decode_time_parallel(rest["hmm"], rest["uniform"][0][:SP_PREFIX],
                                    make_group(torch.device("cuda"), world, axis=TIME_AXIS))
    torch.cuda.empty_cache()
    np.save(f"{tmp}/uniform.npy", np.stack(uniform))
    stream = rest["stream"]
    with open(f"{tmp}/rest.pkl", "wb") as f:
        pickle.dump({"hmm": rest["hmm"], "lanes_u": rest["uniform"][:DENSE_LANES], "ragged": rest["ragged"],
                     "block": stream["block"], "block_r": stream["block_r"], "lens_r": stream["lens_r"]}, f)
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_tp_dist_rank, args=(r, world, f"{tmp}/rendezvous", f"{tmp}/uniform.npy",
                                                f"{tmp}/tp_dist.npz", seed, f"{tmp}/rest.pkl"))
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
    dense = rest["dense"]
    want = {"dense_dp": np.stack(dense["u"]), "dense_tp": dense["one"], "structured_tp": np.stack(rest["scores_r"]),
            "stream_scores": stream["scores"],
            "stream_paths": np.concatenate([stream["path_scores"], stream["paths"]], axis=1), "sp": sp_local}
    if world == 4:
        want["dense_dp_tp"] = np.stack(dense["u"])
    with np.load(f"{tmp}/tp_dist.npz") as z:
        check(np.array_equal(z["scores"], np.stack(scores)), "distributed TP scores == local group")
        check(np.array_equal(z["path_scores"], np.stack([sc for sc, _ in paths])),
              "distributed TP path scores == local group")
        check(np.array_equal(z["paths"], np.stack([p for _, p in paths])),
              "distributed TP paths == local group")
        for name, w in want.items():
            check(np.array_equal(z[name], w), f"{name} on {world} NCCL ranks == unsharded, bit for bit")
        n = pad_to_lane(rest["hmm"].states_num)
        check(z["dense_tp_block"].tolist() == [n // world, n], f"a dense TP rank holds its [{n // world}, {n}] block")
        warm = z["seconds"].tolist()
        rest_secs = {name: float(z[f"{name}_seconds"]) for name in want}
    phase("tp_dist", ran=True, ranks=world, seconds=time.perf_counter() - t0, lanes=len(uniform),
          bit_equal=True, decode_batch_seconds=warm[0], decode_path_batch_seconds=warm[1],
          parallel_rest_seconds=rest_secs, parallel_rest_entries=sorted(want))


def generic_main(seed: int, card: str, lengths) -> dict:
    """``generic_main``, ``generic_kernel_vs_plain`` and the generic arms'
    ``time`` lines, on the two models outside the uniform plans whose main
    path is the generic arms of the masked and path kernels: the seeded
    tie-heavy model at the corpus stand-in's 2,405 states (one diagonal,
    one dense row and column, three residual entries) and the TP phase's
    banded model (2,432 states, offsets (1, 3)), decoded whole. For each:
    ``decode_batch`` and ``decode_path_batch`` of a uniform set (512 x
    3,500) and a ragged set (the lengths ``lengths``) through
    ``ViterbiDecoder``, with the launch counts read around each run; both
    generic kernels against their plain versions on 512 lanes x 511 steps,
    ragged and unmasked, and the decodes against the oracle on a prefix;
    then each arm's time on the uniform set and at each ragged bucket
    (median of 5), each with its bound from the model's own generic count
    and the shape of its launch, and on the tie-heavy model the plain
    versions' times on the uniform set (one run after a warm-up: a plain
    path scan takes seconds). Returns the launch counts, the max abs
    errors and, per model, the uniform launch's times (``uniform``) and the
    launches, ms and bound ms of its main path's calls (``calls``)."""
    import torch

    from spec_viterbi_tpu_torch import ViterbiDecoder, viterbi_path_oracle
    from spec_viterbi_tpu_torch.io import generate_banded_hmm, generate_tie_heavy_hmm
    from spec_viterbi_tpu_torch.ops import fused
    from spec_viterbi_tpu_torch.probes import bounds
    from spec_viterbi_tpu_torch.probes.common import median_ms
    from spec_viterbi_tpu_torch.utils.batching import bucket_plan

    models = (
        ("tie_heavy", generate_tie_heavy_hmm(STATES_MATCH, seed=seed)),
        ("banded", generate_banded_hmm(TP_STATES, TP_OFFSETS, TP_SYMBOLS, seed=seed)),
    )
    totals = dict(ZERO_LAUNCHES)
    errs = {"scores_masked": 0.0, "path": 0.0}
    out = {"launches": totals, "errs": errs, "models": {}}
    for k, (name, hmm) in enumerate(models):
        dec = ViterbiDecoder(hmm, mode="structured", device="cuda")
        fd = dec._fused
        t = fd._masked
        check(fd is not None and not fd._fs_ok and fd._scores_arm is t and fd._path_arm is t,
              f"the {name} model takes the generic arms")
        rng = np.random.default_rng(seed + 4 + k)
        # the tie-heavy model's last symbol is dead (no state emits it): left out here
        live = hmm.emit_num - 1 if name == "tie_heavy" else hmm.emit_num
        uniform = [rng.integers(0, live, size=T_LEN).astype(np.int32) for _ in range(LANES)]
        ragged = [rng.integers(0, live, size=int(x)).astype(np.int32) for x in lengths]
        plan = bucket_plan([len(s) for s in ragged], lane_block=fused.BB)
        budget = fd._path_lane_budget
        calls_u = -(-LANES // max(fused.BB, budget(T_LEN)))
        calls_r = sum(-(-len(idx) // max(fused.BB, budget(tq))) for idx, tq in plan)
        secs, got = {}, {}
        for run, fn, want in (
            ("uniform_decode_batch", lambda: dec.decode_batch(uniform), {"scores_masked": 1}),
            ("ragged_decode_batch", lambda: dec.decode_batch(ragged), {"scores_masked": len(plan)}),
            ("uniform_decode_path_batch", lambda: dec.decode_path_batch(uniform),
             {"path": calls_u, "backtrace": calls_u}),
            ("ragged_decode_path_batch", lambda: dec.decode_path_batch(ragged),
             {"path": calls_r, "backtrace": calls_r}),
        ):
            fused.reset_launches()
            t0 = time.perf_counter()
            got[run] = fn()
            secs[run] = time.perf_counter() - t0
            counts = dict(fused.launches)
            check(counts == {**ZERO_LAUNCHES, **want}, f"{name} {run} ran the generic arms: {counts}")
            for key, v in counts.items():
                totals[key] += v
        for kind in ("uniform", "ragged"):
            scores, paths = got[f"{kind}_decode_batch"], got[f"{kind}_decode_path_batch"]
            check(all(np.array_equal(sc, s) for (sc, _), s in zip(paths, scores)),
                  f"{name} {kind} path scores == scores")
            seqs = uniform if kind == "uniform" else ragged
            # a banded (1, 3) path moves up a state or three a symbol, so
            # only a sequence shorter than the states can end on one
            check(all(bool(np.isfinite(sc).any()) for sc, s in zip(scores, seqs)
                      if name == "tie_heavy" or len(s) < hmm.states_num // 2),
                  f"{name} {kind} scores reach a state")
            check(all(p.shape == (len(s),) and bool((p >= 0).all() and (p < hmm.states_num).all())
                      for (_, p), s in zip(paths, seqs)),
                  f"{name} {kind} paths of the right length and range")
        phase("generic_main", model=name, states=hmm.states_num, n=fd.n, seconds=secs,
              launches={"scores_masked": 1 + len(plan), "path": calls_u + calls_r,
                        "backtrace": calls_u + calls_r},
              buckets=[[len(i), tq] for i, tq in plan])
        del got

        steps = GENERIC_CHECK_STEPS
        for kind, seqs in (("ragged", [s[: steps + 1] for s in ragged]),
                           ("uniform", [s[: steps + 1] for s in uniform])):
            st, ln, m = fd.prepare(seqs, t_pad=steps + 1)
            check(m == (kind == "ragged"), f"generic check masking, {kind}")
            v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
            ln = ln if m else None
            kern = fused.scores_masked(t, fd.em, v0, st[1:], ln)
            same, err = equal_with_err(kern, fused.scores_masked_plain(t, fd.em_t, v0, st[1:], ln))
            check(same, f"generic masked kernel == plain, {name}, {kind}")
            errs["scores_masked"] = max(errs["scores_masked"], err)
            k_out, k_src = fused.path(t, fd.em, v0, st[1:], ln)
            p_out, p_src = fused.path_plain(t, fd.em_t, v0, st[1:], ln)
            same, err = equal_with_err(k_out, p_out)
            check(same and torch.equal(k_src, p_src), f"generic path kernel == plain, {name}, {kind}")
            check(torch.equal(k_out, kern), f"generic path carry == generic scores, {name}")
            errs["path"] = max(errs["path"], err)
            del k_src, p_src
        prefix = [s[: 16 * (j + 1)] for j, s in enumerate(ragged[:4])]
        for s, sc, (psc, p) in zip(prefix, dec.decode_batch(prefix), dec.decode_path_batch(prefix)):
            want_sc, want_p = viterbi_path_oracle(hmm, s)
            check(np.array_equal(sc, want_sc) and np.array_equal(psc, want_sc) and np.array_equal(p, want_p),
                  f"generic arms == oracle ({name}, {hmm.states_num} states, {len(s)} symbols)")
        phase("generic_kernel_vs_plain", model=name, steps=steps, lanes=len(ragged),
              **{f"{key}_max_abs_err": e for key, e in errs.items()})

        # each arm's time on the uniform set (one launch of 512 lanes, as
        # decode_batch runs it) and at each ragged bucket, against the
        # bound of the model's own generic count
        sop = fd.sop
        op = bounds.operator_step(sop.n, len(sop.diag_offsets), len(sop.row_idx), len(sop.col_idx),
                                  planned=False)
        st, _, m = fd.prepare(uniform)
        check(not m, f"{name} uniform set is unmasked")
        v0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
        obs = st[1:]
        n_steps = obs.shape[0]
        fns = {"scores_masked": (lambda: fused.scores_masked(t, fd.em, v0, obs, None),
                                 lambda: fused.scores_masked_plain(t, fd.em_t, v0, obs, None)),
               "path": (lambda: fused.path(t, fd.em, v0, obs, None),
                        lambda: fused.path_plain(t, fd.em_t, v0, obs, None))}
        uni = {}
        for arm, (kern_fn, plain_fn) in fns.items():
            work = (bounds.masked_scores if arm == "scores_masked" else bounds.path)(
                op, LANES, n_steps, LANES * n_steps, hmm.emit_num, False)
            ms = median_ms(kern_fn)
            row = {"ms": ms, "us_per_step": ms * 1e3 / n_steps, "bound_ms": work.bound()[0],
                   "bound_by": work.bound()[1],
                   "shape": fused.generic_shape(t, LANES, fd.device, path=arm == "path")}
            if name == "tie_heavy":
                row["plain_ms"] = median_ms(plain_fn, repeats=1)
                row["plain_repeats"] = 1
            uni[arm] = row
            phase("time", kernel=arm, model=name, card=card, lanes=LANES, steps=n_steps, **row)
        del fns
        calls = {arm: [1, uni[arm]["ms"], uni[arm]["bound_ms"]] for arm in uni}
        rows = []
        for idx, tq in plan:
            st, ln, _ = fd.prepare([ragged[i] for i in idx], t_pad=tq)
            bv0 = fd.em_t[:, st[0].long()] + fd.pi[:, None]
            b_steps, b_lanes = st.shape[0] - 1, len(idx)
            lane_steps = int((ln.long() - 1).clamp(0, b_steps).sum())
            row = {"lanes": b_lanes, "steps": b_steps}
            for arm in ("scores_masked", "path"):
                fn = fused.scores_masked if arm == "scores_masked" else fused.path
                ms = median_ms(lambda: fn(t, fd.em, bv0, st[1:], ln))
                work = (bounds.masked_scores if arm == "scores_masked" else bounds.path)(
                    op, b_lanes, b_steps, lane_steps, hmm.emit_num, True)
                row[f"{arm}_ms"] = ms
                row[f"{arm}_bound_ms"] = work.bound()[0]
                calls[arm][0] += 1
                calls[arm][1] += ms
                calls[arm][2] += work.bound()[0]
            rows.append(row)
        phase("time", kernel="generic_ragged_buckets", model=name, card=card, buckets=rows)
        out["models"][name] = {"uniform": uni, "calls": calls, "states": hmm.states_num,
                               "steps": n_steps}
    return out


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


def host_us_per_step(fn, steps: int, repeats: int = 3) -> float:
    """The host's µs a step of ``fn`` (``steps`` launches, too few to fill
    the launch queue): ``perf_counter`` around the call without waiting
    for the device, median of ``repeats`` after a warm-up."""
    import statistics

    import torch

    per = []
    for _ in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        per.append((time.perf_counter() - t0) * 1e6 / steps)
    torch.cuda.synchronize()
    return statistics.median(per[1:])


def device_events(fn) -> dict:
    """The device activities of one call of ``fn`` under ``torch.profiler``
    (kernels, copies, fills), counted by name."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(collections.Counter(e.name for e in prof.events()
                                    if e.device_type == torch.autograd.DeviceType.CUDA))


def dense_and_spec(seed: int, card: str, hmm, uniform, ragged, scores_u, scores_r,
                   path_u0) -> tuple[dict, dict]:
    """The phases ``dense_main``, ``dense_kernel_vs_plain`` and
    ``spec_main`` on the corpus model ``hmm``, and the ``time`` lines of
    ``svt_minplus``. ``scores_u`` ([512, n] on the card), ``scores_r`` and
    ``path_u0`` are the structured main path's uniform and ragged scores and
    lane 0's path. Returns the dense scores (``u``: the first 50 uniform
    lanes' ``run_batch``, ``r``: the first 50 ragged ``decode_batch``,
    ``one``: ``decode`` of the first uniform sequence) and the ``minplus``
    entry of the ``kernels`` line."""
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
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    events = device_events(lambda: dec.run_batch(handle))
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    mp_events = sum(c for name, c in events.items() if "minplus" in name)
    check(mp_events == want["run_batch"] and sum(events.values()) - mp_events <= DENSE_SETUP_EVENTS,
          f"run_batch: one device kernel a step and {DENSE_SETUP_EVENTS} or fewer around the loop: {events}")
    check(allocs <= DENSE_SETUP_ALLOCS, f"run_batch allocates {allocs} blocks: none in the step loop")
    tropical.reset_launches()
    dense_u = dec.run_batch(handle)
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
          run_batch_device_events=events, run_batch_allocations=allocs,
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
    # the new arms' edges at each pinned cluster size: a split with no k
    # (K = 17), all-inf rows (every seventh), J off the tile widths
    a_inf = edge_rm.clone()
    a_inf[:, ::7] = float("inf")
    b56, b65, a17, b17 = ties(1, 999, 56), ties(3, 999, 65), ties(2, 130, 17), ties(2, 17, 17)
    for cl in CLUSTER_EDGE:
        tropical.minplus_tune(cl)
        try:
            for name, a, a_idx, b in (("TN view, J = 56", edge_tn, None, b56),
                                      ("gathered, all-inf rows, J = 65", a_inf, idx, b65),
                                      ("K = 17 short of the cluster", a17, None, b17)):
                for am in (False, True):
                    held(f"cluster {cl}, {name}, argmin={am}", tropical.minplus(a, b, a_idx, argmin=am),
                         tropical.minplus_plain(a, b, a_idx, argmin=am))
        finally:
            tropical.minplus_tune()
    # the one-launch step: its epilogue at a lane's length on the ragged
    # set, a prefix of the new loop against the plain loop (uniform, and
    # ragged with lanes frozen at 0-64 steps), the J = 1 step's pointer row
    a_view = dec.dev.a.T
    r_seqs_t, r_len = dec.prepare_batch(lanes_r)
    rv0 = (em_t[:, r_seqs_t[0].long()] + dec.dev.pi[:, None]).contiguous()
    t_mid = int(r_len[r_len > 0].min())  # lanes below, at and past their length
    held("the epilogue step, ragged, t at the shortest lane's length",
         tropical.dense_step(a_view, rv0, em_t, r_seqs_t, r_len, t_mid, torch.empty_like(rv0)),
         tropical.dense_step_plain(a_view, rv0, em_t, r_seqs_t, r_len, t_mid))

    def new_loop(seqs_t, lens, v):
        bufs = [v.clone(), torch.empty_like(v)]
        for t in range(1, DENSE_PLAIN_STEPS + 1):
            tropical.dense_step(a_view, bufs[(t - 1) % 2], em_t, seqs_t, lens, t, bufs[t % 2])
        return bufs[DENSE_PLAIN_STEPS % 2]

    def plain_loop(seqs_t, lens, v):
        for t in range(1, DENSE_PLAIN_STEPS + 1):
            v = tropical.dense_step_plain(a_view, v, em_t, seqs_t, lens, t)
        return v

    held(f"{DENSE_PLAIN_STEPS}-step prefix of the one-launch loop, uniform", new_loop(seqs_t, lengths, v0),
         plain_loop(seqs_t, lengths, v0))
    frozen = torch.as_tensor(np.resize(np.array([0, 1, 2, 31, 32, 33, 64, T_LEN], np.int32), len(r_len)),
                             device=dev)
    held(f"{DENSE_PLAIN_STEPS}-step prefix of the one-launch loop, lanes frozen at 0-64 steps",
         new_loop(r_seqs_t, frozen, rv0), plain_loop(r_seqs_t, frozen, rv0))
    src = torch.full((3, 1, n), -1, dtype=torch.int32, device=dev)
    o1 = int(lanes_u[0][1])
    v1_flat = v1[0, :, 0].contiguous()
    w1 = tropical.dense_step_mv(dec.dev.a_t, v1_flat, em_t, o1, torch.empty(n, device=dev), src[1, 0])
    held("J = 1 step with its epilogue, argmin into a pointer row", (w1, src[1, 0]),
         tropical.dense_step_mv_plain(dec.dev.a_t, v1_flat, em_t, o1, argmin=True))
    check(bool((src[0] == -1).all() and (src[2] == -1).all()), "the J = 1 step writes its own pointer row only")
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
    # the decoder's own loop: one dense_step launch a step
    run = minplus_timed(lambda: dec.run_batch(handle), steps)
    prefix = dec.prepare_batch([s[: DENSE_HOST_STEPS + 1] for s in lanes_u])
    host_us = host_us_per_step(lambda: dec.run_batch(prefix), DENSE_HOST_STEPS)
    plain_ms = median_ms(lambda: [tropical.minplus_plain(a_tn, v0[None]) for _ in range(DENSE_PLAIN_STEPS)],
                         repeats=DENSE_TIME_REPEATS)
    step_shape = tropical.minplus_shape(1, n, n, j, dev)
    time_line(what="dense run_batch", lanes=DENSE_LANES, padded_lanes=j, steps=steps, **timed,
              us_per_step=timed["ms"] * 1e3 / steps, run_batch_ms=run["ms"],
              run_batch_us_per_step=run["ms"] * 1e3 / steps,
              run_batch_kernel_us_per_launch=run["kernel_us_per_launch"],
              run_batch_idle_share=run["idle_share"], host_us_per_step=host_us,
              host_sets_pace=(host_us > run["kernel_us_per_launch"]) if run["kernel_us_per_launch"] else None,
              plain_steps=DENSE_PLAIN_STEPS,
              plain_ms=plain_ms, plain_us_per_step=plain_ms * 1e3 / DENSE_PLAIN_STEPS,
              bound_ms=steps * step_bound, bound_by=step_by, shape=step_shape, tile=step_shape["tile"],
              thread_tile=step_shape["thread_tile"], cluster=step_shape["cluster"],
              stages=step_shape["stages"])
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
                  # no L2 rate on the data sheet: the resident time has only an operations bound
                  resident_ops_bound_us=work.ops / bounds.F32_OPS_PER_S * 1e6,
                  **{("decode_path_ms" if am else "decode_ms"): whole}, plain_steps=DENSE_PLAIN_STEPS,
                  plain_ms=p1, plain_us_per_step=p1 * 1e3 / DENSE_PLAIN_STEPS,
                  bound_ms=steps * work.bound()[0], bound_by=work.bound()[1],
                  shape=tropical.minplus_shape(1, n, n, 1, dev, i_contiguous=False, argmin=am))
    del cold
    build = minplus_timed(lambda: specializer._add_level(spec2.ops, spec2.ops), radix)
    b_plain = median_ms(lambda: tropical.minplus_plain(spec2.ops[7][None], spec2.ops[13][None]), repeats=1)
    build_work = bounds.minplus(radix, n, n, n, 1)
    time_line(what="level-2 build (_add_level)", products=radix**2, **build,
              us_per_product=build["ms"] * 1e3 / radix**2, plain_ms_one_product=b_plain,
              bound_ms=radix * build_work.bound()[0], bound_by=build_work.bound()[1],
              shape=tropical.minplus_shape(radix, n, n, n, dev, i_contiguous=False))
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
              shape=tropical.minplus_shape(DENSE_LANES, n, n, 1, dev, i_contiguous=False))
    dense = {"u": u_np, "r": dense_r, "one": dense_1}
    del spec2, dec, auto
    torch.cuda.empty_cache()
    return dense, {
        "name": "minplus", "route": "cuda", "source": "spec_viterbi_tpu_torch/csrc/tropical.cu",
        "replaces": "spec_viterbi_tpu/ops/tropical.py:89", "also_replaces": "spec_viterbi_tpu/ops/tropical.py:31-43",
        "launches": dense_launches + build_launches + spec_launches, "dense_main_launches": dense_launches,
        "spec_main_launches": build_launches + spec_launches, "max_abs_err": max(errs.values()),
        "ms": timed["ms"] / steps, "plain_ms": plain_ms / DENSE_PLAIN_STEPS, "bound_ms": step_bound,
        "bound_by": step_by, "library_ms": None,
        "shape": f"one dense batch step: [{n}, {n}] (min,+) [{n}, {j}]",
        "tile": step_shape["tile"], "thread_tile": step_shape["thread_tile"], "slices": step_shape["slices"],
        "cluster": step_shape["cluster"], "stages": step_shape["stages"], "ctas": step_shape["ctas"],
        "run_batch_kernel_us_per_launch": run["kernel_us_per_launch"], "host_us_per_step": host_us,
    }


def _settled(fn) -> float:
    """Wall seconds of ``fn()`` with the device synchronised on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def parallel_rest(card: str, hmm, fd, uniform, ragged, scores_u, scores_r, dense: dict,
                  stream: dict) -> dict:
    """The phase ``parallel_rest``: the local forms of the dense DP, TP and
    DP x TP decodes, the structured TP and DP and ``StreamDP`` on the
    corpus model ``hmm`` (fused decoder ``fd``), each held bit-equal to the
    unsharded result the smoke already has: ``dense`` (from
    ``dense_and_spec``), ``scores_u``/``scores_r`` (the fused decoder's) and
    ``stream`` (the ``stream`` phase's scores, path scores and paths). Then
    the ``time`` lines of ``svt_minplus``'s two new shapes, each held to its
    bound. Returns the launch count of ``svt_minplus`` and the results
    ``tp_dist`` compares its NCCL ranks with."""
    import torch

    from spec_viterbi_tpu_torch.models.decoder import SUBLANE, DeviceHMM, _decode_scores_batch
    from spec_viterbi_tpu_torch.ops import fused, tropical
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
    from spec_viterbi_tpu_torch.parallel import (
        DATA_AXIS,
        StreamDP,
        decode_batch_dp,
        decode_batch_dp_tp,
        decode_batch_structured_dp,
        decode_batch_structured_tp,
        decode_tp,
        make_dp_tp_decode,
        make_grid,
        make_group,
        make_structured_dp_decode,
        make_structured_tp_decode,
        make_tp_decode,
    )
    from spec_viterbi_tpu_torch.probes import bounds
    from spec_viterbi_tpu_torch.probes.common import median_ms, profiled
    from spec_viterbi_tpu_torch.utils.batching import pad_batch

    dev = torch.device("cuda")
    n_real = hmm.states_num
    dhmm = DeviceHMM.from_hmm(hmm, device=dev)
    n = dhmm.padded
    em_t = dhmm.emissions.T
    lanes_u, lanes_r = uniform[:DENSE_LANES], ragged[:DENSE_LANES]
    data = make_group(dev, PAR_DATA, axis=DATA_AXIS)
    state = make_group(dev, PAR_STATE)
    grid = make_grid(dev, *PAR_GRID)
    u_np = scores_u[:, :n_real].cpu().numpy()
    steps = T_LEN - 1
    lines = {}

    def same(got, want) -> bool:
        return len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))

    def warm(fn) -> float:
        """Median of PAR_REPEATS warm wall seconds (``fn`` has run once)."""
        return float(np.median([_settled(fn) for _ in range(PAR_REPEATS)]))

    def staged(seqs, multiple, min_t=1):
        batch, lengths = pad_batch(seqs, multiple, min_t=min_t)
        return (torch.as_tensor(batch.T.copy(), device=dev), torch.as_tensor(lengths, device=dev))

    def per_step(enqueue, launches: int, kernel: str) -> dict:
        """The host's µs a step of ``enqueue`` (PAR_PREFIX steps, no wait
        for the device) against the device's µs: ``kernel``'s a launch and
        all kernels' a step, and the idle share under ``torch.profiler``."""
        k_us, busy, span = profiled(enqueue, kernel)
        return {"host_us_per_step": host_us_per_step(enqueue, PAR_PREFIX),
                "device_us_per_launch": k_us / launches if span and launches else None,
                "device_busy_us_per_step": busy / PAR_PREFIX if span else None,
                "idle_share": 1.0 - busy / span if span else None}

    prefix_u = [s[: PAR_PREFIX + 1] for s in lanes_u]

    # ---- dense DP: data 2, the 50 uniform and 50 ragged sequences ---------
    tropical.reset_launches()
    fused.reset_launches()
    got_u = decode_batch_dp(dhmm, lanes_u, data)
    got_r = decode_batch_dp(dhmm, lanes_r, data)
    want = PAR_DATA * (steps + max(map(len, lanes_r)) - 1)
    launched = {"dp": tropical.launches["minplus"]}
    check(launched["dp"] == want and not any(fused.launches.values()),
          f"decode_batch_dp: {launched['dp']} svt_minplus launches == {want}, no fused kernel")
    check(same(got_u, dense["u"]), "decode_batch_dp uniform == dense run_batch, bit for bit")
    check(same(got_r, dense["r"]), "decode_batch_dp ragged == dense decode_batch, bit for bit")
    st, ln = staged(prefix_u, PAR_DATA * SUBLANE)
    per = st.shape[1] // PAR_DATA
    shard_lanes = [(st[:, d * per : (d + 1) * per].contiguous(), ln[d * per : (d + 1) * per].contiguous())
                   for d in range(PAR_DATA)]
    lines["decode_batch_dp"] = {
        "shards": {"data": PAR_DATA}, "lanes": [DENSE_LANES, DENSE_LANES], "padded_lanes": int(per * PAR_DATA),
        "launches": launched["dp"], "seconds_uniform": warm(lambda: decode_batch_dp(dhmm, lanes_u, data)),
        "seconds_ragged": warm(lambda: decode_batch_dp(dhmm, lanes_r, data)),
        **per_step(lambda: [_decode_scores_batch(dhmm.a, dhmm.pi, dhmm.emissions, o, g)
                            for o, g in shard_lanes], PAR_DATA * PAR_PREFIX, "minplus"),
        "launches_a_step": PAR_DATA}

    # ---- dense TP: state 4 (Nb 608), one sequence of 3,500 ---------------
    tropical.reset_launches()
    got = decode_tp(dhmm, uniform[0], state)
    launched["tp"] = tropical.launches["minplus"]
    check(launched["tp"] == PAR_STATE * steps, f"decode_tp: {launched['tp']} launches == 4 x {steps}")
    check(np.array_equal(got, dense["one"]), "decode_tp == dense decode, bit for bit")
    tp_fn = make_tp_decode(state)
    lines["decode_tp"] = {
        "shards": {"state": PAR_STATE}, "block": [n // PAR_STATE, n], "launches": launched["tp"],
        "seconds": warm(lambda: decode_tp(dhmm, uniform[0], state)),
        **per_step(lambda: tp_fn(dhmm.a_t, dhmm.pi, dhmm.emissions, uniform[0][: PAR_PREFIX + 1]),
                   PAR_STATE * PAR_PREFIX, "minplus"),
        "launches_a_step": PAR_STATE}

    # ---- dense DP x TP: data 2 x state 2, the 50 uniform sequences --------
    tropical.reset_launches()
    got = decode_batch_dp_tp(dhmm, lanes_u, grid)
    launched["dp_tp"] = tropical.launches["minplus"]
    check(launched["dp_tp"] == PAR_GRID[0] * PAR_GRID[1] * steps, f"decode_batch_dp_tp: {launched['dp_tp']} launches")
    check(same(got, dense["u"]), "decode_batch_dp_tp == dense run_batch, bit for bit")
    dp_tp_fn = make_dp_tp_decode(grid)
    st, ln = staged(prefix_u, PAR_GRID[0] * SUBLANE)
    nb, bd = n // PAR_GRID[1], st.shape[1] // PAR_GRID[0]
    lines["decode_batch_dp_tp"] = {
        "shards": dict(zip(("data", "state"), PAR_GRID)), "block": [nb, n], "lanes_a_data_shard": bd,
        "launches": launched["dp_tp"], "seconds": warm(lambda: decode_batch_dp_tp(dhmm, lanes_u, grid)),
        **per_step(lambda: dp_tp_fn(dhmm.a, dhmm.pi, em_t, st, ln), PAR_GRID[0] * PAR_GRID[1] * PAR_PREFIX,
                   "minplus"),
        "launches_a_step": PAR_GRID[0] * PAR_GRID[1]}

    # ---- structured TP: state 4, 512 uniform and 512 ragged lanes ---------
    fused.reset_launches()
    tropical.reset_launches()
    got_u = decode_batch_structured_tp(hmm, uniform, state)
    got_r = decode_batch_structured_tp(hmm, ragged, state)
    check(not any(fused.launches.values()) and not tropical.launches["minplus"],
          "the structured TP launches no kernel of the port")
    check(same(got_u, u_np), "decode_batch_structured_tp uniform == the fused decoder, bit for bit")
    check(same(got_r, scores_r), "decode_batch_structured_tp ragged == the fused decoder, bit for bit")
    sop = StructuredOperator.from_hmm(hmm)
    stp_fn = make_structured_tp_decode(sop, state)
    st, ln = staged([s[: PAR_PREFIX + 1] for s in uniform], SUBLANE, min_t=2)
    ops = [torch.as_tensor(x, device=dev) for x in (sop.diag_vals, sop.row_vals, sop.col_vals)]
    resv = torch.zeros((1, 1), device=dev)
    pi = dhmm.pi
    lines["decode_batch_structured_tp"] = {
        "shards": {"state": PAR_STATE}, "lanes": [LANES, LANES],
        "operator": {"diagonals": list(sop.diag_offsets), "rows": len(sop.row_idx), "cols": len(sop.col_idx),
                     "residual": sop.residual_nnz},
        "seconds_uniform": warm(lambda: decode_batch_structured_tp(hmm, uniform, state)),
        "seconds_ragged": warm(lambda: decode_batch_structured_tp(hmm, ragged, state)),
        **per_step(lambda: stp_fn(*ops, resv, em_t, pi, st, ln), 0, "none")}

    # ---- structured DP: data 2, the 512 ragged lanes ----------------------
    got_r = decode_batch_structured_dp(hmm, ragged, data)
    check(same(got_r, scores_r), "decode_batch_structured_dp == the fused decoder, bit for bit")
    sdp_fn = make_structured_dp_decode(sop, data)
    st, ln = staged([s[: PAR_PREFIX + 1] for s in uniform], PAR_DATA * SUBLANE, min_t=2)
    lines["decode_batch_structured_dp"] = {
        "shards": {"data": PAR_DATA}, "lanes": LANES,
        "seconds": warm(lambda: decode_batch_structured_dp(hmm, ragged, data)),
        **per_step(lambda: sdp_fn(em_t, pi, st, ln), 0, "none")}

    # ---- StreamDP: data 2, 512 lanes in the stream phase's chunks ---------
    sdp = StreamDP(fd, data)
    block, block_r, lens_r = stream["block"], stream["block_r"], stream["lens_r"]

    def scores_stream():
        return stream_dp_scores(sdp, block)

    def path_stream():
        return stream_dp_paths(sdp, block_r, lens_r)

    fused.reset_launches()
    got = scores_stream()
    scores_counts = dict(fused.launches)
    check(scores_counts == {**ZERO_LAUNCHES, "scores_masked_planned": PAR_DATA * len(STREAM_CHUNKS)},
          f"StreamDP: one planned masked launch a shard a feed: {scores_counts}")
    check(np.array_equal(got, stream["scores"]), "StreamDP scores == the single-device stream, bit for bit")
    fused.reset_launches()
    path_scores, paths = path_stream()
    path_counts = dict(fused.launches)
    k = PAR_DATA * len(STREAM_CHUNKS)
    check(path_counts == {**ZERO_LAUNCHES, "scores_masked_planned": k, "path_planned": k, "backtrace": k},
          f"StreamDP path: a feed, a path and a backtrace launch a shard a chunk: {path_counts}")
    check(fd.path_supported(1536 + 1, batch=LANES // PAR_DATA), "every lane within the per-shard budget")
    check(np.array_equal(path_scores, stream["path_scores"]) and np.array_equal(paths, stream["paths"]),
          "StreamDP paths and scores == the single-device path stream, bit for bit")
    lines["stream_dp"] = {
        "shards": {"data": PAR_DATA}, "lanes": LANES, "chunks": list(STREAM_CHUNKS),
        "launches": {"scores": scores_counts, "path": path_counts},
        "seconds_scores": warm(scores_stream), "seconds_path": warm(path_stream)}
    for name, line in lines.items():
        phase("parallel_rest", entry=name, card=card, bit_equal=True, **line)

    # ---- time lines of svt_minplus's two new shapes, each held to its bound
    def time_line(**line):
        phase("time", kernel="minplus", card=card, **line)
        for key in ("ms", "kernel_ms"):
            check(line[key] is None or line[key] >= line["bound_ms"],
                  f"svt_minplus {line['what']}: {key} {line[key]} reads below its bound {line['bound_ms']}")

    v = (dhmm.emissions[int(uniform[0][0])] + dhmm.pi).contiguous()
    nb = n // PAR_STATE
    blocks = [dhmm.a_t[r * nb : (r + 1) * nb] for r in range(PAR_STATE)]
    cold = [blocks[c % PAR_STATE].clone() for c in range(TP_COLD_COPIES)]
    em_blk = em_t[:nb]
    out = torch.empty(nb, device=dev)
    work = bounds.minplus(1, nb, n, 1, 1)
    syms = uniform[0][1:].tolist()
    t1 = minplus_timed(lambda: [tropical.dense_step_mv(cold[s % TP_COLD_COPIES], v, em_blk, o, out)
                                for s, o in enumerate(syms)], steps)
    whole = minplus_timed(lambda: decode_tp(dhmm, uniform[0], state), PAR_STATE * steps, repeats=1)
    plain = median_ms(lambda: [tropical.dense_step_mv_plain(blocks[0], v, em_blk, o)
                               for o in syms[:DENSE_PLAIN_STEPS]], repeats=DENSE_TIME_REPEATS)
    time_line(what="TP block step, J = 1", block=[nb, n], steps=steps,
              operator=f"{TP_COLD_COPIES} copies of the block in turn, each read from HBM", **t1,
              us_per_step=t1["ms"] * 1e3 / steps, decode_tp_ms=whole["ms"],
              resident_kernel_us_per_launch=whole["kernel_us_per_launch"], resident_idle_share=whole["idle_share"],
              plain_steps=DENSE_PLAIN_STEPS, plain_ms=plain, plain_us_per_step=plain * 1e3 / DENSE_PLAIN_STEPS,
              bound_ms=steps * work.bound()[0], bound_by=work.bound()[1],
              shape=tropical.minplus_shape(1, nb, n, 1, dev, i_contiguous=False))
    del cold
    final = tp_fn(dhmm.a_t, dhmm.pi, dhmm.emissions, uniform[0])
    for r in range(PAR_STATE):  # every state block, its em_t rows a strided view
        rows = slice(r * nb, (r + 1) * nb)
        for carry, o in ((v, syms[0]), (final, syms[-1])):
            check(torch.equal(tropical.dense_step_mv(blocks[r], carry, em_t[rows], o, out),
                              tropical.dense_step_mv_plain(blocks[r], carry, em_t[rows], o)),
                  f"the TP block step of state shard {r} == plain, bit for bit")
    for seqs, name in ((lanes_u, "uniform"), (lanes_r, "ragged")):  # each DP shard's 32-lane step
        st, ln = staged(seqs, PAR_DATA * SUBLANE)
        per = st.shape[1] // PAR_DATA
        for d in range(PAR_DATA):
            obs, lns = st[:, d * per : (d + 1) * per].contiguous(), ln[d * per : (d + 1) * per].contiguous()
            carry = (em_t[:, obs[0].long()] + dhmm.pi[:, None]).contiguous()
            out = torch.empty_like(carry)
            # the last step, and the ragged set's step at which its shortest lane of the shard stops
            t = st.shape[0] - 1 if name == "uniform" else int(lns[lns > 0].min())
            check(torch.equal(tropical.dense_step(dhmm.a.T, carry, em_t, obs, lns, t, out),
                              tropical.dense_step_plain(dhmm.a.T, carry, em_t, obs, lns, t)),
                  f"the {name} DP shard {d} step ({per} lanes, t = {t}) == plain, bit for bit")
    st, ln = staged(lanes_u, PAR_GRID[0] * SUBLANE)
    bd = st.shape[1] // PAR_GRID[0]
    obs, lns = st[:, :bd].contiguous(), ln[:bd].contiguous()
    carry = (em_t[:, obs[0].long()] + dhmm.pi[:, None]).contiguous()
    nb = n // PAR_GRID[1]
    a_blk, em_blk = dhmm.a.T[nb:], em_t[nb:]
    out = torch.empty((nb, bd), device=dev)
    work = bounds.minplus(1, nb, n, bd, 1)
    t2 = minplus_timed(lambda: [tropical.dense_step(a_blk, carry, em_blk, obs, lns, t, out, row0=nb)
                                for t in range(1, T_LEN)], steps)
    whole = minplus_timed(lambda: decode_batch_dp_tp(dhmm, lanes_u, grid), launched["dp_tp"], repeats=1)
    plain = median_ms(lambda: [tropical.dense_step_plain(a_blk, carry, em_blk, obs, lns, t, nb)
                               for t in range(1, DENSE_PLAIN_STEPS + 1)], repeats=DENSE_TIME_REPEATS)
    check(torch.equal(tropical.dense_step(a_blk, carry, em_blk, obs, lns, 5, out, row0=nb),
                      tropical.dense_step_plain(a_blk, carry, em_blk, obs, lns, 5, nb)),
          "the DP x TP block step == plain, bit for bit")
    time_line(what="DP x TP block step", block=[nb, n], lanes=bd, row0=nb, steps=steps, **t2,
              us_per_step=t2["ms"] * 1e3 / steps, decode_batch_dp_tp_ms=whole["ms"],
              decode_kernel_us_per_launch=whole["kernel_us_per_launch"], decode_idle_share=whole["idle_share"],
              plain_steps=DENSE_PLAIN_STEPS, plain_ms=plain, plain_us_per_step=plain * 1e3 / DENSE_PLAIN_STEPS,
              bound_ms=steps * work.bound()[0], bound_by=work.bound()[1],
              shape=tropical.minplus_shape(1, nb, n, bd, dev))
    torch.cuda.empty_cache()
    return {"launches": sum(launched.values()), "dense_tp_block_kernel_us": t1["kernel_us_per_launch"],
            "dp_tp_block_kernel_us": t2["kernel_us_per_launch"]}


def _checked_kernels(fn, shapes: dict, remats: list):
    """Run ``fn()`` with the first ``svt_minplus`` launch of every shape
    (operand shapes and A's strides) held to ``minplus_plain`` on the same
    operands, the operands kept in ``shapes`` for the time lines, and every
    path launch held to ``path_plain`` (carry and pointers), its shape
    appended to ``remats``; bit for bit. Returns ``fn()``."""
    import torch

    from spec_viterbi_tpu_torch.ops import fused, tropical

    minplus, path = tropical.minplus, fused.path

    def checked_minplus(a, b, a_idx=None, argmin=False, out=None):
        c = minplus(a, b, a_idx, argmin, out)
        key = (tuple(a.shape), tuple(a.stride()), tuple(b.shape))
        if key not in shapes:
            check(a_idx is None and not argmin, f"svt_minplus {key}: a plain product")
            check(torch.equal(c, tropical.minplus_plain(a, b)), f"svt_minplus {key} == minplus_plain, bit for bit")
            shapes[key] = (a, b)
        return c

    def checked_path(t, em, v0, obs, lengths):
        out, src = path(t, em, v0, obs, lengths)
        want_out, want_src = fused.path_plain(t, em.T, v0, obs, lengths)
        check(torch.equal(out, want_out) and torch.equal(src, want_src),
              f"the path launch of {v0.shape[1]} lanes x {obs.shape[0]} steps == path_plain, bit for bit")
        remats.append({"lanes": v0.shape[1], "steps": obs.shape[0], "planned": isinstance(t, fused.FsTables)})
        return out, src

    tropical.minplus, fused.path = checked_minplus, checked_path
    try:
        return fn()
    finally:
        tropical.minplus, fused.path = minplus, path


def time_parallel(card: str, hmm, dec, fd, seq, serial_path) -> dict:
    """The phase ``time_parallel``: ``TimeParallelDecoder`` on the corpus
    model and one 3,500-symbol sequence, for each block length in
    ``TPAR_KS`` and both compose schedules, ``decode`` and
    ``decode_path(seq, engine=fd)``, against the serial one-lane decode
    (``dec.decode``, the FS kernel) and ``fd.decode_path_batch([seq])``;
    then the dense SP (``decode_time_parallel`` on a local time group of
    ``SP_SHARDS``, the first ``SP_PREFIX`` symbols) against the dense
    decode. Every new ``svt_minplus`` shape, every path launch and every
    walk is held to its plain version; the k = 8 scan also to the same
    decoder on the CPU. Returns the kernels' launches in the counted runs."""
    import statistics

    import torch

    from spec_viterbi_tpu_torch import ViterbiDecoder
    from spec_viterbi_tpu_torch.ops import fused, tropical
    from spec_viterbi_tpu_torch.ops.time_parallel import TimeParallelDecoder
    from spec_viterbi_tpu_torch.parallel import TIME_AXIS, decode_time_parallel, make_group
    from spec_viterbi_tpu_torch.probes import bounds
    from spec_viterbi_tpu_torch.probes.common import median_ms, profiled

    dev = torch.device("cuda")
    sop = fd.sop
    n, n_real = sop.n, hmm.states_num
    em, pi = hmm.emission_matrix(pad_to=n), hmm.start_vector(pad_to=n)
    seq_t = torch.as_tensor(seq, device=dev)
    steps = len(seq) - 1

    def warm(fn) -> float:
        """Median of TPAR_REPEATS wall seconds, after one run."""
        fn()
        return statistics.median(_settled(fn) for _ in range(TPAR_REPEATS))

    def drift(got, want) -> float:
        check(np.array_equal(np.isinf(got), np.isinf(want)), "the same +inf pattern as the serial scores")
        fin = np.isfinite(want)
        err = float(np.abs(got[fin] - want[fin]).max()) if fin.any() else 0.0
        check(err <= 1.0, f"within the ±1.0 contract of the serial scores: {err}")
        return err

    serial = dec.decode(seq)
    fd_scores, fd_path = fd.decode_path_batch([seq])[0]
    check(np.array_equal(fd_path, serial_path), "the serial fused path == decode_path_batch's lane 0")
    serial_s = {"decode": warm(lambda: dec.decode(seq)),
                "decode_path_batch": warm(lambda: fd.decode_path_batch([seq]))}
    phase("time_parallel_serial", card=card, states=n_real, n=n, symbols=len(seq), seconds=serial_s)

    shapes, remats, walks, launched, runs = {}, [], [], {}, []
    for k in TPAR_KS:
        for compose in ("scan", "tree"):
            label = f"k = {k} {compose}"
            tp = TimeParallelDecoder(sop, em, pi, k=k, compose=compose, device=dev)
            nb, tail = tp.plan(len(seq))
            first = checked_backtraces(f"time parallel {label}", lambda: _checked_kernels(
                lambda: tp.decode_path(seq, engine=fd), shapes, remats), walks)
            fused.reset_launches()
            tropical.reset_launches()
            scores = tp.decode(seq)
            decode_launches = {"minplus": tropical.launches["minplus"], **{
                name: c for name, c in fused.launches.items() if c}}
            fused.reset_launches()
            tropical.reset_launches()
            path_scores, path = tp.decode_path(seq, engine=fd)
            counts = {"minplus": tropical.launches["minplus"], **dict(fused.launches)}
            compose_launches = 2 * (k - 1 if compose == "scan" else k.bit_length() - 1)
            want = {**ZERO_LAUNCHES, "minplus": compose_launches + 2 * nb, "path_planned": 1 + (tail > 0),
                    "backtrace": 1}
            check(counts == want, f"{label}: launches {counts} == {want}")
            check(decode_launches == {"minplus": want["minplus"]}, f"{label}: decode launches {decode_launches}")
            for name in ("minplus", "path_planned", "backtrace"):
                launched[name] = launched.get(name, 0) + counts[name]
            check(np.array_equal(scores, path_scores) and np.array_equal(first[0], scores)
                  and np.array_equal(first[1], path), f"{label}: decode == decode_path == the checked run")
            err = drift(scores, serial)
            check(np.array_equal(path, fd_path), f"{label}: path == the serial fused path")
            line = {"run": label, "k": k, "compose": compose, "blocks": nb, "tail": tail, "slots": tp.r1 * k,
                    "band": tp.w_band, "launches": counts, "max_drift": err, "path_equal_serial": True}
            if (k, compose) == (8, "scan"):
                tp_cpu = TimeParallelDecoder(sop, em, pi, k=k, compose=compose, device="cpu")
                fd_cpu = fused.FusedStructuredDecoder(sop, em, pi, device="cpu")
                t0 = time.perf_counter()
                cpu_scores, cpu_path = tp_cpu.decode_path(seq, engine=fd_cpu)
                check(np.array_equal(cpu_scores, scores) and np.array_equal(cpu_path, path)
                      and np.array_equal(tp_cpu.decode(seq), scores), f"{label}: == the CPU's plain versions, bit for bit")
                line.update(bit_equal_cpu=True, cpu_path_seconds=time.perf_counter() - t0)
            line["decode_s"] = warm(lambda: tp.decode(seq))
            line["decode_path_s"] = warm(lambda: tp.decode_path(seq, engine=fd))
            line["speedup_vs_serial"] = serial_s["decode"] / line["decode_s"]
            line["path_speedup_vs_serial"] = serial_s["decode_path_batch"] / line["decode_path_s"]
            # the split: compose, fold, tail, the block and tail remat launches, the walk
            syms = seq_t[1 : 1 + nb * k].long().reshape(nb, k)
            v0 = tp._em_t[:, int(seq[0])] + tp._pi
            ops = tp._compose_blocks(syms)
            v_blocks, fronts = tp._fold(v0, *ops)
            obs = seq_t[1 : 1 + nb * k].reshape(nb, k).T.contiguous()
            fronts_t = fronts.T.contiguous()
            carry, tail_obs = v_blocks[:, None].contiguous(), seq_t[1 + nb * k :, None].contiguous()
            src = fused.path(fd._path_arm, fd.em, fronts_t, obs, None)[1]
            tsrc = fused.path(fd._path_arm, fd.em, carry, tail_obs, None)[1]
            src_all = torch.cat([src.transpose(0, 1).reshape(nb * k, 1, n), tsrc]).contiguous()
            v_end = tp._tail(v_blocks, seq[1 + nb * k :].tolist()) if tail else v_blocks
            last = torch.argmin(v_end).to(torch.int32)[None]
            line["split_s"] = {  # one run each, every part warm from the runs above
                "compose": _settled(lambda: tp._compose_blocks(syms)), "fold": _settled(lambda: tp._fold(v0, *ops)),
                "tail": _settled(lambda: tp._tail(v_blocks, seq[1 + nb * k :].tolist())),
                "remat_blocks": _settled(lambda: fused.path(fd._path_arm, fd.em, fronts_t, obs, None)),
                "remat_tail": _settled(lambda: fused.path(fd._path_arm, fd.em, carry, tail_obs, None)),
                "walk": _settled(lambda: fused.backtrace(src_all, last))}
            k_us, busy, span = profiled(lambda: tp._fold(v0, *ops), "minplus")
            line["fold"] = {"blocks": nb, "launches": 2 * nb,
                            "host_us_per_block": host_us_per_step(lambda: tp._fold(v0, *ops), nb, repeats=1),
                            "device_busy_us_per_block": busy / nb if span else None,
                            "minplus_device_us_per_launch": k_us / (2 * nb) if span else None,
                            "idle_share": 1.0 - busy / span if span else None}
            del ops, src, tsrc, src_all
            runs.append(line)
            phase("time_parallel", card=card, **line)

    # ---- the dense SP: a local time group, the first SP_PREFIX symbols ---
    sp_seq = seq[:SP_PREFIX]
    group = make_group(dev, SP_SHARDS, axis=TIME_AXIS)
    want = ViterbiDecoder(hmm, mode="dense", device=dev).decode(sp_seq)
    first = _checked_kernels(lambda: decode_time_parallel(hmm, sp_seq, group), shapes, remats)
    tropical.reset_launches()
    t0 = time.perf_counter()
    got = decode_time_parallel(hmm, sp_seq, group)
    sp_s = time.perf_counter() - t0
    sp_launches = tropical.launches["minplus"]
    block = -(-(SP_PREFIX - 1) // SP_SHARDS)
    check(sp_launches == SP_SHARDS * (block + 1), f"decode_time_parallel: {sp_launches} svt_minplus launches")
    check(np.array_equal(got, first), "decode_time_parallel twice, bit for bit")
    sp_err = drift(got, want)
    launched["minplus"] += sp_launches
    phase("time_parallel_sp", card=card, shards=SP_SHARDS, symbols=SP_PREFIX, block=block, launches=sp_launches,
          seconds=sp_s, max_drift_vs_dense=sp_err, products=SP_SHARDS * block)

    # ---- time lines of every new svt_minplus shape, each held to its bound
    for (a_shape, a_stride, b_shape), (a, b) in shapes.items():
        g, i, kk = b_shape[0], a_shape[1], b_shape[1]
        j = b_shape[2]
        work = bounds.minplus(g, i, kk, j, a_shape[0])
        ms = median_ms(lambda: tropical.minplus(a, b))
        plain_ms = median_ms(lambda: tropical.minplus_plain(a, b), repeats=2)
        line = {"what": "time parallel", "g": g, "i": i, "k": kk, "j": j, "a_stride": list(a_stride), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": work.bound()[0], "bound_by": work.bound()[1],
                "shape": tropical.minplus_shape(g, i, kk, j, dev, i_contiguous=a_stride[-2] == 1 and i > 1)}
        phase("time", kernel="minplus", card=card, **line)
        check(ms >= line["bound_ms"], f"svt_minplus {a_shape} x {b_shape}: {ms} ms reads below its bound")
    phase("time_parallel_checks", card=card, minplus_shapes=len(shapes), remat_launches=remats,
          walks=walks, bit_equal=True)
    shapes.clear()
    torch.cuda.empty_cache()
    return launched


def tp_and_dp(seed: int, card: str, lengths, fd, ragged, scores_r, bt_calls: list,
              rest_refs: dict) -> tuple[list, list]:
    """The phases ``tp_main``, ``tp_kernel_vs_plain``, ``tp_oracle``,
    ``dp``, ``tp_dist`` and the window kernels' ``time`` lines. ``fd``,
    ``ragged`` and ``scores_r`` are the corpus model's fused decoder, ragged
    set and ``decode_batch`` scores; the backtrace launches of a TP and a
    DP path call, each held to its plain version, add their misses to
    ``bt_calls``; ``rest_refs`` are the corpus model's inputs and results
    that ``tp_dist`` holds the NCCL ranks of ``parallel_rest``'s entry
    points to. Returns the window kernels' entries of the ``kernels``
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
        tp_dist(seed, uniform, scores_u, paths_u, tmp, rest_refs)

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


def hostmem_compose(card: str, hmm) -> dict:
    """The level-2 compose of ``hmm``'s structured specializer
    (``batched_compose_level``: its slabs' allocation and fill) with
    ``np.empty`` and with ``utils.hostmem.populate_empty`` as the slab
    allocator, in turn, ``HOSTMEM_REPEATS`` times each on the card's host;
    both give the same slabs. Prints the ``hostmem`` line."""
    import statistics

    from spec_viterbi_tpu_torch.ops import structured_compose as sc
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
    from spec_viterbi_tpu_torch.utils.hostmem import populate_empty

    sop = StructuredOperator.from_hmm(hmm)
    l1 = sc.batched_level1(sop, hmm.emission_matrix(pad_to=sop.n))
    allocs = {"np_empty": np.empty, "populate_empty": populate_empty}
    secs = {name: [] for name in allocs}
    first = {}
    for _ in range(HOSTMEM_REPEATS):
        for name, alloc in allocs.items():
            t0 = time.perf_counter()
            out = sc.batched_compose_level(l1, l1, alloc=alloc)
            secs[name].append(time.perf_counter() - t0)
            first.setdefault(name, out)
            del out
    a, b = first["np_empty"], first["populate_empty"]
    check(a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:])),
          "the level-2 compose is the same with either allocator")
    line = {"slab_bytes": sum(int(x.nbytes) for x in a[1:]), "repeats": HOSTMEM_REPEATS,
            "cpu_count": os.cpu_count(), **{f"{k}_s": v for k, v in secs.items()},
            **{f"{k}_median_s": statistics.median(v) for k, v in secs.items()}}
    phase("hostmem", card=card, **line)
    return line


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
    hostmem = hostmem_compose(card, hmm)
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
          largest_difference_to_dense=max(diffs), composed_card_equals_cpu=True, hostmem=hostmem)
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


def _cli_scores(rows) -> str:
    """What ``decode`` prints for the score vectors ``rows``: the JAX
    CLI's lines, formatted here apart from the port's CLI."""
    out = []
    for i, v in enumerate(rows):
        head = " ".join(f"{x:.4f}" for x in v[:8])
        out.append(f"seq {i}: [{head}{' ...' if len(v) > 8 else ''}] min={np.min(v):.4f}\n")
    return "".join(out)


def _cli_paths(pairs) -> str:
    """What ``decode --path`` prints for (scores, path) pairs."""
    return "".join(f"seq {i}: best={np.min(sc):.4f} path={p.tolist()}\n" for i, (sc, p) in enumerate(pairs))


def scheduler_cli(seed: int, card: str, hmm, dec, uniform, ragged, scores_u, scores_r, paths_u, paths_r,
                  plan) -> dict:
    """The phase ``scheduler_cli``: ``decode_auto``, every other route of
    ``execute_route``, ``stream_engine``, the CLI in process and the
    native parser, on the card. ``dec`` is the main path's decoder of the
    corpus model ``hmm``; ``scores_u`` ([512, n] on the card), ``scores_r``,
    ``paths_u`` and ``paths_r`` its results on the two sets, ``plan`` the
    ragged set's bucket plan. Each route's output is held bit-equal to its
    direct entry point's, and its kernels' launches are counted around
    it. Returns the launches of the counted runs by kernel."""
    import contextlib
    import io
    import statistics

    import torch

    from spec_viterbi_tpu_torch import (
        Route,
        ViterbiDecoder,
        Workload,
        decode_auto,
        execute_route,
        plan_route,
        stream_engine,
    )
    from spec_viterbi_tpu_torch.cli import main as cli_main
    from spec_viterbi_tpu_torch.io import chmm as chmm_io
    from spec_viterbi_tpu_torch.io import ess as ess_io
    from spec_viterbi_tpu_torch.io import (
        generate_banded_hmm,
        read_emit_seq,
        read_hmm,
        write_chmm,
        write_ess,
    )
    from spec_viterbi_tpu_torch.native import loader
    from spec_viterbi_tpu_torch.ops import _build, fused, tropical
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
    from spec_viterbi_tpu_torch.ops.time_parallel import TimeParallelDecoder
    from spec_viterbi_tpu_torch.parallel import (
        FusedTPDecoder,
        decode_batch_dp_fused,
        decode_batch_structured_tp,
        decode_path_batch_dp_fused,
        make_grid,
        make_group,
    )
    from spec_viterbi_tpu_torch.scheduler import TIME_PARALLEL_K_DEFAULT, model_resident_bytes

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    fd = dec._fused
    n_real = hmm.states_num
    u_np = scores_u.cpu().numpy()[:, :n_real]
    launched: dict[str, int] = {}

    def counted(label, fn, want):
        """``fn()`` with the kernels' launches counted around it: exactly
        ``want``, no other kernel."""
        fused.reset_launches()
        tropical.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {**fused.launches, **tropical.launches}
        check(counts == {**ZERO_LAUNCHES, "minplus": 0, **want}, f"{label}: launches {counts}, want {want}")
        for name, c in counts.items():
            launched[name] = launched.get(name, 0) + c
        return out

    def same_scores(got, want) -> bool:
        return len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))

    def same_paths(got, want) -> bool:
        return len(got) == len(want) and all(
            np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1]) for g, w in zip(got, want))

    def med_ms(fn) -> float:
        return 1e3 * statistics.median(_settled(fn) for _ in range(SCHED_REPEATS))

    # ---- decode_auto on both sets: the batch route, bit-equal to the main
    # path, then the split of a call against the warm direct call ---------
    budget = fd._path_lane_budget
    u_calls = -(-LANES // max(fused.BB, budget(T_LEN)))
    r_calls = sum(-(-len(idx) // max(fused.BB, budget(t))) for idx, t in plan)
    auto = {}
    for name, seqs, scores, paths, want_s, want_p in (
        ("uniform", uniform, list(u_np), paths_u, {"scores_fs": 1},
         {"path_planned": u_calls, "backtrace": u_calls}),
        ("ragged", ragged, scores_r, paths_r, {"scores_masked_planned": len(plan)},
         {"path_planned": r_calls, "backtrace": r_calls}),
    ):
        route = plan_route(hmm, Workload.from_seqs(seqs), device=dev)
        check(route.kind == "batch", f"decode_auto plans {route.kind} for the {name} set")
        got = counted(f"decode_auto {name}", lambda: decode_auto(hmm, seqs, device=dev), want_s)
        check(same_scores(got, scores), f"decode_auto {name} scores == the main path's")
        got = counted(f"decode_auto {name} paths", lambda: decode_auto(hmm, seqs, paths=True, device=dev), want_p)
        check(same_paths(got, paths), f"decode_auto {name} paths == decode_path_batch's")
        del got
        fresh = {}

        def construct():
            fresh["dec"] = ViterbiDecoder(hmm, device=dev)

        auto[name] = {
            "route": route.kind, "reason": route.reason, "launches": want_s, "path_launches": want_p,
            "plan_ms": med_ms(lambda: plan_route(hmm, Workload.from_seqs(seqs), device=dev)),
            "construct_ms": med_ms(construct),
            "decode_ms": med_ms(lambda: fresh["dec"].decode_batch(seqs)),
            "decode_auto_ms": med_ms(lambda: decode_auto(hmm, seqs, device=dev)),
            "warm_direct_ms": med_ms(lambda: dec.decode_batch(seqs)),
            "decode_auto_paths_ms": med_ms(lambda: decode_auto(hmm, seqs, paths=True, device=dev)),
            "warm_direct_paths_ms": med_ms(lambda: dec.decode_path_batch(seqs)),
        }
        del fresh
    phase("scheduler_auto", card=card, states=n_real, lanes=LANES, symbols=T_LEN, repeats=SCHED_REPEATS,
          **auto)

    # ---- execute_route: the other routes, each against its direct entry
    # point ---------------------------------------------------------------
    routes = {}
    sop = fd.sop
    em, pi = hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)

    # dp, data 2: the uniform set's shards run FS, the ragged set's the
    # planned masked arm, the paths the planned path arm and the walk
    grid = make_grid(dev, data=2)
    route = plan_route(hmm, Workload.from_seqs(uniform), grid, device=dev)
    check(route.kind == "dp" and route.params == {"shards": 2}, f"data 2 plans {route}")
    with_paths = Route(route.kind, route.reason, {**route.params, "paths": True})
    want = {"uniform": {"scores_fs": 2}, "ragged": {"scores_masked_planned": 2},
            "uniform_paths": {"path_planned": 2, "backtrace": 2}}
    t0 = time.perf_counter()
    got_u = counted("dp uniform", lambda: execute_route(hmm, uniform, route, grid, device=dev), want["uniform"])
    got_r = counted("dp ragged", lambda: execute_route(hmm, ragged, route, grid, device=dev), want["ragged"])
    got_p = counted("dp uniform paths", lambda: execute_route(hmm, uniform, with_paths, grid, device=dev),
                    want["uniform_paths"])
    secs = time.perf_counter() - t0
    check(same_scores(got_u, decode_batch_dp_fused(fd, uniform, grid.data)) and same_scores(got_u, list(u_np)),
          "dp route == decode_batch_dp_fused == run_batch (uniform)")
    check(same_scores(got_r, decode_batch_dp_fused(fd, ragged, grid.data)) and same_scores(got_r, scores_r),
          "dp route == decode_batch_dp_fused == decode_batch (ragged)")
    check(same_paths(got_p, decode_path_batch_dp_fused(fd, uniform, grid.data)) and same_paths(got_p, paths_u),
          "dp route paths == decode_path_batch_dp_fused == decode_path_batch")
    del got_u, got_r, got_p
    routes["dp"] = {"shards": 2, "seconds": secs, "launches": want}

    # tp_chunked: the banded model of tp_main, capacity-bound by a budget
    # of half its arrays
    banded = generate_banded_hmm(TP_STATES, TP_OFFSETS, TP_SYMBOLS, seed=seed)
    b_sop = StructuredOperator.from_hmm(banded)
    rng = np.random.default_rng(seed + 5)
    b_seqs = [rng.integers(0, banded.emit_num, size=T_LEN).astype(np.int32) for _ in range(LANES)]
    grid = make_grid(dev, state=TP_SHARDS)
    small = model_resident_bytes(b_sop, banded.emit_num) // 2
    route = plan_route(banded, Workload.from_seqs(b_seqs, hbm_bytes=small), grid, device=dev)
    check(route.kind == "tp_chunked" and route.params == {
        "chunk": TP_CHUNK, "shards": TP_SHARDS, "capacity_bound": True}, f"the banded model plans {route}")
    with_paths = Route(route.kind, route.reason, {**route.params, "paths": True})
    chunks = -(-(T_LEN - 1) // TP_CHUNK)
    want = {"scores": {"scores_window": chunks}, "paths": {"path_window": chunks, "backtrace": 1}}
    t0 = time.perf_counter()
    got = counted("tp_chunked", lambda: execute_route(banded, b_seqs, route, grid, device=dev), want["scores"])
    got_p = counted("tp_chunked paths", lambda: execute_route(
        banded, b_seqs[:SCHED_PATH_LANES], with_paths, grid, device=dev), want["paths"])
    secs = time.perf_counter() - t0
    direct = FusedTPDecoder(b_sop, banded.emission_matrix(pad_to=b_sop.n), banded.start_vector(pad_to=b_sop.n),
                            make_group(dev, TP_SHARDS), chunk=TP_CHUNK)
    check(same_scores(got, direct.decode_batch(b_seqs)), "tp_chunked route == FusedTPDecoder.decode_batch")
    check(same_paths(got_p, direct.decode_path_batch(b_seqs[:SCHED_PATH_LANES])),
          "tp_chunked route paths == FusedTPDecoder.decode_path_batch")
    del got, got_p, direct
    routes["tp_chunked"] = {"states": banded.states_num, "shards": TP_SHARDS, "chunk": TP_CHUNK, "lanes": LANES,
                            "path_lanes": SCHED_PATH_LANES, "hbm_bytes": small, "seconds": secs,
                            "launches": want}

    # time_parallel: one 3,500-symbol sequence on request (k = 8, scan),
    # through decode_auto
    seq = uniform[0]
    k = TIME_PARALLEL_K_DEFAULT
    tp = TimeParallelDecoder(sop, em, pi, k=k, device=dev)
    nb, tail = tp.plan(len(seq))
    want = {"scores": {"minplus": 2 * (k - 1) + 2 * nb},
            "paths": {"minplus": 2 * (k - 1) + 2 * nb, "path_planned": 1 + (tail > 0), "backtrace": 1}}
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        got = counted("time_parallel", lambda: decode_auto(
            hmm, [seq], prefer_time_parallel=True, verbose=True, device=dev), want["scores"])
        got_p = counted("time_parallel paths", lambda: decode_auto(
            hmm, [seq], paths=True, prefer_time_parallel=True, verbose=True, device=dev), want["paths"])
    secs = time.perf_counter() - t0
    check(err.getvalue().count(f"[scheduler] time_parallel: single {len(seq)}-symbol sequence") == 2,
          f"decode_auto planned time_parallel: {err.getvalue()!r}")
    check(same_scores(got, [tp.decode(seq)]), "time_parallel route == TimeParallelDecoder.decode")
    check(same_paths(got_p, [tp.decode_path(seq, engine=fd)]),
          "time_parallel route paths == TimeParallelDecoder.decode_path(engine=)")
    tp_scores = got[0]
    check(np.array_equal(got_p[0][1], paths_u[0][1]), "time_parallel path == the serial fused path")
    routes["time_parallel"] = {"k": k, "blocks": nb, "tail": tail, "seconds": secs, "launches": want}
    del tp

    # tp_halo: the corpus model (coupled: its dense row and columns fail
    # fused_tp_supported), state 4, a 200-step prefix of the 512 lanes; no
    # kernel, by definition; capacity-bound paths refused
    prefix = [s[:PAR_PREFIX] for s in uniform]
    grid = make_grid(dev, state=TP_SHARDS)
    small = model_resident_bytes(sop, hmm.emit_num) // 2
    route = plan_route(hmm, Workload.from_seqs(prefix, hbm_bytes=small), grid, device=dev)
    check(route.kind == "tp_halo" and route.params == {"shards": TP_SHARDS, "capacity_bound": True},
          f"the corpus model plans {route}")
    t0 = time.perf_counter()
    got = counted("tp_halo", lambda: execute_route(hmm, prefix, route, grid, device=dev), {})
    secs = time.perf_counter() - t0
    check(same_scores(got, decode_batch_structured_tp(hmm, prefix, make_group(dev, TP_SHARDS))),
          "tp_halo route == decode_batch_structured_tp")
    check(same_scores(got, dec.decode_batch(prefix)), "tp_halo route == the fused decoder's scores")
    refused = False
    try:
        execute_route(hmm, prefix[:2], Route(route.kind, route.reason, {**route.params, "paths": True}), grid,
                      device=dev)
    except ValueError:
        refused = True
    check(refused, "capacity-bound halo TP refuses paths")
    routes["tp_halo"] = {"shards": TP_SHARDS, "lanes": LANES, "symbols": PAR_PREFIX, "hbm_bytes": small,
                         "seconds": secs, "launches": {}, "paths_refused": True}

    # stream_engine: the fused engine, chunks of 999, 1,500 and 1,000
    route = plan_route(hmm, Workload(n_seqs=SCHED_STREAM_LANES, max_len=T_LEN, streaming=True), device=dev)
    check(route.kind == "stream_fused", f"a stream plans {route.kind}")
    eng = stream_engine(hmm, route, device=dev)
    check(isinstance(eng, fused.FusedStructuredDecoder) and eng is not fd, "stream_engine: a new fused engine")
    block = np.stack(uniform[:SCHED_STREAM_LANES], axis=1)
    feeds = len(STREAM_CHUNKS)

    def scores_stream():
        st, pos = eng.stream_begin(block[0]), 1
        for w in STREAM_CHUNKS:
            st, pos = eng.stream_feed(st, block[pos : pos + w]), pos + w
        return eng.stream_scores(st)

    def path_stream():
        st, pos = eng.stream_begin_path(block[0]), 1
        for w in STREAM_CHUNKS:
            st, pos = eng.stream_feed_path(st, block[pos : pos + w]), pos + w
        return eng.stream_path_finalize(st)

    want = {"scores": {"scores_masked_planned": feeds},
            "paths": {"scores_masked_planned": feeds, "path_planned": feeds, "backtrace": feeds}}
    t0 = time.perf_counter()
    got = counted("stream_engine scores", scores_stream, want["scores"])
    got_sc, got_p = counted("stream_engine paths", path_stream, want["paths"])
    secs = time.perf_counter() - t0
    check(np.array_equal(got, u_np[:SCHED_STREAM_LANES]), "stream_engine scores == the main path's")
    check(same_paths(list(zip(got_sc, got_p)), paths_u[:SCHED_STREAM_LANES]),
          "stream_engine paths == decode_path_batch's")
    refused = False
    try:
        execute_route(hmm, uniform[:2], route, device=dev)
    except ValueError:
        refused = True
    check(refused, "execute_route refuses a stream route")
    routes["stream_fused"] = {"lanes": SCHED_STREAM_LANES, "chunks": list(STREAM_CHUNKS), "seconds": secs,
                              "launches": want}
    phase("scheduler_routes", card=card, **routes)

    # ---- the CLI in process, on files written here; stdout captured -----
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        chmm, u512, u64, one = (f"{tmp}/{f}" for f in ("model.chmm", "uniform.ess", "u64.ess", "one.ess"))
        write_chmm(hmm, chmm)
        write_ess(uniform, u512)
        write_ess(uniform[:SCHED_STREAM_LANES], u64)
        write_ess([seq], one)
        cli = {}

        def run_cli(label, argv, want_launches, want_out):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = counted(f"cli {label}", lambda: cli_main(argv), want_launches)
            cli[label] = {"seconds": time.perf_counter() - t0, "launches": want_launches,
                          "stdout_bytes": len(out.getvalue())}
            check(rc == 0, f"cli {label}: rc {rc}")
            check(out.getvalue() == want_out, f"cli {label}: stdout == the direct results' lines")
            return err.getvalue()

        err = run_cli("decode", ["decode", chmm, u512, "--device", "cuda"], {"scores_fs": 1}, _cli_scores(u_np))
        check(err.startswith(f"[scheduler] batch: single-device batched decode ({LANES} seqs)"),
              f"cli decode: the scheduler line {err!r}")
        run_cli("decode_path", ["decode", chmm, u64, "--path", "--device", "cuda"],
                {"path_planned": 1, "backtrace": 1}, _cli_paths(paths_u[:SCHED_STREAM_LANES]))
        feeds = len(range(1, T_LEN, SCHED_CLI_CHUNK))
        run_cli("decode_stream_chunk", ["decode", chmm, u64, "--stream-chunk", str(SCHED_CLI_CHUNK),
                                        "--device", "cuda"],
                {"scores_masked_planned": feeds}, _cli_scores(u_np[:SCHED_STREAM_LANES]))
        run_cli("decode_time_parallel", ["decode", chmm, one, "--time-parallel", str(k), "--device", "cuda"],
                {"minplus": 2 * (k - 1) + 2 * nb}, _cli_scores([tp_scores]))
        info = io.StringIO()
        with contextlib.redirect_stdout(info):
            check(cli_main(["info", chmm]) == 0, "cli info")
        check(info.getvalue().startswith(f"states:        {n_real} (padded {sop.n})\n"), "cli info's first line")
        check(f"fingerprint:   {hmm.fingerprint()}\n" in info.getvalue(), "cli info's fingerprint")
        phase("scheduler_cli", card=card, runs=cli, stream_chunk=SCHED_CLI_CHUNK, info_lines=len(
            info.getvalue().splitlines()))

        # ---- the native parser: built, taken by read_hmm, equal to the
        # Python tokenizer; the host ms of each -------------------------------
        t0 = time.perf_counter()
        lib = loader.build()
        build_s = time.perf_counter() - t0
        check(lib is not None and loader.native_available(), "the native parser builds")
        before = dict(loader.parses)
        t0 = time.perf_counter()
        h_native = read_hmm(chmm)
        chmm_native_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        s_native = read_emit_seq(u512)
        ess_native_ms = 1e3 * (time.perf_counter() - t0)
        check(loader.parses == {"hmm": before["hmm"] + 1, "ess": before["ess"] + 1},
              "read_hmm and read_emit_seq took the native parser")
        t0 = time.perf_counter()
        with open(chmm) as f:
            h_py = chmm_io._parse_tokens(f.read().split(), chmm)
        chmm_python_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        with open(u512) as f:
            s_py = ess_io._parse_tokens(f.read().split(), u512)
        ess_python_ms = 1e3 * (time.perf_counter() - t0)
        for field in ("trans_rows", "trans_cols", "trans_probs", "emissions", "start_probabilities_cols",
                      "start_probabilities"):
            a, b = getattr(h_native, field), getattr(h_py, field)
            check(a.dtype == b.dtype and np.array_equal(a, b), f"native .chmm == the Python tokenizer: {field}")
        check(h_native.fingerprint() == hmm.fingerprint(), "native .chmm == the model")
        check(same_scores(s_native, s_py) and same_scores(s_native, uniform), "native .ess == the Python tokenizer")
        phase("native_parser", card=card, library=lib.name, build_or_lookup_s=build_s, states=n_real,
              chmm_bytes=os.path.getsize(chmm), ess_bytes=os.path.getsize(u512), sequences=len(s_native),
              chmm_native_ms=chmm_native_ms, chmm_python_ms=chmm_python_ms, ess_native_ms=ess_native_ms,
              ess_python_ms=ess_python_ms, parses=dict(loader.parses))
    torch.cuda.empty_cache()
    phase("scheduler_cli_total", card=card, seconds=time.perf_counter() - t_phase,
          launches={name: c for name, c in launched.items() if c})
    return launched


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
    stream_ref = {"block": block, "block_r": block_r, "lens_r": lens_r, "scores": got,
                  "path_scores": scores_s, "paths": paths_s}

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

    generic = generic_main(args.seed, card, lengths)
    generic_counts, generic_errs = generic["launches"], generic["errs"]
    dense, minplus_entry = dense_and_spec(args.seed, card, hmm, uniform, ragged, scores_u, scores_r,
                                          paths_u[0])
    rest = parallel_rest(card, hmm, fd, uniform, ragged, scores_u, scores_r, dense, stream_ref)
    minplus_entry["launches"] += rest["launches"]
    minplus_entry.update(parallel_rest_launches=rest["launches"],
                         tp_block_kernel_us=rest["dense_tp_block_kernel_us"],
                         dp_tp_block_kernel_us=rest["dp_tp_block_kernel_us"])
    tpar = time_parallel(card, hmm, dec, fd, uniform[0], paths_u[0][1])
    minplus_entry["launches"] += tpar["minplus"]
    minplus_entry["time_parallel_launches"] = tpar["minplus"]
    rest_refs = {"hmm": hmm, "uniform": uniform, "ragged": ragged, "scores_r": scores_r,
                 "dense": dense, "stream": stream_ref}
    window_kernels, window_floors = tp_and_dp(args.seed, card, lengths, fd, ragged, scores_r, bt_calls,
                                              rest_refs)
    sched = scheduler_cli(args.seed, card, hmm, dec, uniform, ragged, scores_u, scores_r, paths_u, paths_r, plan)
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
    # main path runs; the generic arms, forced, run the same calls without
    # the plans) ------------------------------------------------------------
    steps = obs.shape[0]
    sop = fd.sop
    # one count of the operator's work for each kernel: the planned count
    # where the kernel uses the plans, the generic count for the generic arms
    op_planned = bounds.operator_step(sop.n, len(sop.diag_offsets), len(sop.row_idx), len(sop.col_idx),
                                      planned=fd._fs is not None)
    op_generic = bounds.operator_step(sop.n, len(sop.diag_offsets), len(sop.row_idx), len(sop.col_idx),
                                      planned=False)
    op_of = {"scores_fs": op_planned, "scores_masked_planned": op_planned, "path_planned": op_planned,
             "scores_masked": op_generic, "path": op_generic}
    arm = {"scores_masked": fd._masked, "scores_masked_planned": fd._fs,
           "path": fd._masked, "path_planned": fd._fs}
    bound = {
        "scores_fs": bounds.fs_scores(op_planned, LANES, steps, hmm.emit_num).bound(),
        "backtrace": bounds.backtrace(half, steps).bound(),
    }
    timed = {
        "scores_fs": (
            median_ms(lambda: fused.scores_fs(fd._fs, fd.em, v0, obs)),
            median_ms(lambda: fused.scores_fs_plain(fd._fs, fd.em_t, v0, obs)),
        ),
    }
    for name in ("scores_masked_planned", "scores_masked"):
        bound[name] = bounds.masked_scores(op_of[name], LANES, steps, LANES * steps, hmm.emit_num,
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
        bound[name] = bounds.path(op_of[name], half, steps, half * steps, hmm.emit_num, False).bound()
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

    add("scores_fs", 1, timed["scores_fs"][0], bounds.fs_scores(op_planned, LANES, steps, hmm.emit_num))
    calls = -(-LANES // max(fused.BB, half))
    for name in ("path_planned", "path"):
        add(name, calls, timed[name][0], bounds.path(op_of[name], half, steps, half * steps, hmm.emit_num, False))
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
                work = bounds.path(op_of[name], b_lanes, b_steps, lane_steps, hmm.emit_num, True)
            else:
                ms = median_ms(lambda: fused.scores_masked(t, fd.em, bv0, st[1:], ln))
                work = bounds.masked_scores(op_of[name], b_lanes, b_steps, lane_steps, hmm.emit_num, True)
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
    # the generic arms on the main path of the models that need them: a
    # uniform and a ragged decode_batch (1 + 4 launches), a uniform and a
    # ragged decode_path_batch (the same)
    rank = [(name, None, n, ms, b, ms - b) for name, (n, ms, b) in per_call.items()]
    for model, entry in generic["models"].items():
        rank += [(name, model, n, ms, b, ms - b) for name, (n, ms, b) in entry["calls"].items()]
    rank.sort(key=lambda r: -r[5])
    # the corpus main path runs the planned arms; the stand-in's generic
    # arms are forced
    on_main = {"scores_masked": False, "path": False}
    phase("rank", card=card, by="sum over a main path's launches of (time - bound), ms",
          order=[{"name": name, "launches": n, "ms": ms, "bound_ms": b, "loss_ms": loss,
                  "on_corpus_main_path": model is None and on_main.get(name, True),
                  **({"on_main_path_of": model} if model else {}),
                  **({"chain_floor_ms": call_floor[name]} if name in call_floor else {})}
                 for name, model, n, ms, b, loss in rank])

    struct_and_bench(args.seed, card, hmm, uniform, ragged, scores_u, scores_r, plan)

    # launches: the planned arms' from the corpus model's main path, the
    # generic arms' from generic_main's; the generic arms' times and bounds
    # from the main path of the tie-heavy model (its uniform decode_batch
    # and decode_path_batch launch), the banded model's and the forced
    # stand-in's beside them
    entries = (
        ("scores_fs", "scores.cu", "spec_viterbi_tpu/ops/fused_pallas.py:360", counts, err_fs, LANES),
        ("scores_masked_planned", "scores.cu", "spec_viterbi_tpu/ops/fused_pallas.py:203", counts,
         err_masked["scores_masked_planned"], LANES),
        ("path_planned", "path.cu", "spec_viterbi_tpu/ops/fused_pallas.py:490", path_counts,
         err_path["path_planned"], half),
        ("backtrace", "path.cu", "spec_viterbi_tpu/ops/fused_pallas.py:695", path_counts, err_bt, half),
    )
    kernels = [
        {"name": name, "route": "cuda", "source": f"spec_viterbi_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launched[name], "max_abs_err": err,
         "ms": timed[name][0], "plain_ms": timed[name][1],
         "bound_ms": bound[name][0], "bound_by": bound[name][1], "library_ms": None,
         "shape": f"{lanes} lanes x {steps} steps", **chain.get(name, {})}
        for name, src, replaces, launched, err, lanes in entries
    ]
    tie, banded = generic["models"]["tie_heavy"], generic["models"]["banded"]
    for name, replaces in (("scores_masked", "spec_viterbi_tpu/ops/fused_pallas.py:203"),
                           ("path", "spec_viterbi_tpu/ops/fused_pallas.py:490")):
        u = tie["uniform"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": "spec_viterbi_tpu_torch/csrc/generic.cuh",
            "replaces": replaces, "launches": generic_counts[name],
            "max_abs_err": max(err_masked["scores_masked"] if name == "scores_masked" else err_path["path"],
                               generic_errs[name]),
            "ms": u["ms"], "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"], "bound_by": u["bound_by"],
            "library_ms": None,
            "shape": f"{LANES} lanes x {tie['steps']} steps, tie-heavy model ({tie['states']} states)",
            "launch_shape": u["shape"],
            "banded_ms": banded["uniform"][name]["ms"], "banded_bound_ms": banded["uniform"][name]["bound_ms"],
            "stand_in_forced_ms": timed[name][0], "stand_in_forced_bound_ms": bound[name][0],
        })
    kernels += window_kernels + probe_kernels + [minplus_entry]
    for e in kernels:  # the time-parallel phase's launches of the fused kernels
        if e["name"] in ("path_planned", "backtrace"):
            e["launches"] += tpar[e["name"]]
            e["time_parallel_launches"] = tpar[e["name"]]
    for e in kernels:  # the scheduler_cli phase's launches
        if sched.get(e["name"]):
            e["launches"] += sched[e["name"]]
            e["scheduler_cli_launches"] = sched[e["name"]]
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
