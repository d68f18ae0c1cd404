"""The window kernels of the state-sharded decode on one card, in both of
their launch forms.

``svt_scores_window`` (512 lanes) and ``svt_path_window`` (256 lanes) on
the banded smoke model of ``chip_smoke.py`` (2,432 states, offsets (1, 3),
4 symbols, 4 shards, chunk 16: 219 chunks over 3,499 steps of a uniform
batch of 3,500 symbols), through the decoder's own chunk loops:

- the local form: ``FusedTPDecoder._run_local``, every shard's window in
  one launch a chunk, global pointers;
- the rank form: ``FusedTPDecoder._run_rank`` of one shard on a
  :class:`SoloRank` group, a rank with no peers whose halo exchange does
  nothing, so the loop is that rank's launches alone (S = 1, ``op_row0 =
  rank·block``, window-local pointers).

For each, :func:`run` records the loop's time (CUDA events, median of 5),
µs a step and bound (:mod:`.bounds`); the host's µs a chunk (the loop's
enqueue on the host clock, before the device is done); and, from one loop
under ``torch.profiler``, the window kernel's device µs a chunk, the
device's idle share between the loop's first and last device activity,
and one minus the kernel's device time over the unprofiled loop's time
(None where the profiler saw no device activity: not measured).
:func:`launch_costs` splits one launch's device time into what it costs
with no step and what each step adds; :func:`occupancy` records
registers, resident CTAs an SM and lanes a CTA of each kernel's arm. Only the decoder's entry points are used, so the
same calls time any version of the kernels.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from spec_viterbi_tpu_torch.probes import bounds
from spec_viterbi_tpu_torch.probes.common import T_LEN, Record, median_ms, profiled

STATES = 2432
OFFSETS = (1, 3)
SYMBOLS = 4
SHARDS = 4
CHUNK = 16
LANES = {"scores_window": 512, "path_window": 256}
RANK = 1  # the shard the rank form runs: an interior one
HOST_REPEATS = 3
LAUNCH_STEPS = (0, 1, 4, 16, 64, 1024)  # steps of one launch (launch_costs)
LAUNCH_REPEATS = 20


class SoloRank:
    """Rank ``rank`` of a ``size``-shard state group with no peers: the
    group a :class:`FusedTPDecoder` takes for one rank's window, minus the
    communication (its halo exchange does nothing)."""

    is_local = False

    def __init__(self, rank: int, size: int, device):
        from spec_viterbi_tpu_torch.parallel.mesh import STATE_AXIS

        self.rank, self.size, self.device, self.axis = rank, size, torch.device(device), STATE_AXIS

    def exchange_halo(self, win, h_lo, block, h_hi) -> None:
        pass


def decoders(seed: int, device):
    """(model, decoder of a local group of SHARDS, decoder of rank RANK)."""
    from spec_viterbi_tpu_torch.io import generate_banded_hmm
    from spec_viterbi_tpu_torch.ops.structured import StructuredOperator
    from spec_viterbi_tpu_torch.parallel import FusedTPDecoder

    hmm = generate_banded_hmm(STATES, OFFSETS, SYMBOLS, seed=seed)
    sop = StructuredOperator.from_hmm(hmm)
    em, pi = hmm.emission_matrix(pad_to=sop.n), hmm.start_vector(pad_to=sop.n)
    local = FusedTPDecoder(sop, em, pi, None, chunk=CHUNK, shards=SHARDS, device=device)
    rank = FusedTPDecoder(sop, em, pi, SoloRank(RANK, SHARDS, device), chunk=CHUNK)
    return hmm, local, rank


def _host_s(fn) -> float:
    """Median host seconds to enqueue ``fn`` (the device may still run)."""
    secs = []
    for _ in range(HOST_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        secs.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(secs)


def run(rec: Record, device, seed: int = 0) -> dict:
    """Both window kernels in both forms; one record each, named
    ``window_<form>_<kernel>``."""
    hmm, local, rank = decoders(seed, device)
    rng = np.random.default_rng(seed + 2)
    seqs = [rng.integers(0, hmm.emit_num, size=T_LEN).astype(np.int32) for _ in range(max(LANES.values()))]
    steps = T_LEN - 1
    chunks = -(-steps // CHUNK)
    out = {}
    for kernel, lanes in LANES.items():
        st, ln = local._stage(seqs[:lanes])
        path = kernel == "path_window"
        loops = {
            "local": (lambda: local._run_local(st, ln, path=path), SHARDS),
            "rank": (lambda: rank._run_rank(st, ln, path=path), 1),
        }
        for form, (fn, windows) in loops.items():
            # the least time for the work: every window row each step, each
            # launch reading and writing the carry it runs on
            geometry = (len(OFFSETS), local.n_win, windows,
                        local.h_lo + local.n + local.h_hi if form == "local" else local.n_win, lanes)
            if path:
                bound_ms, bound_by = bounds.window_path(*geometry, steps, chunks, SYMBOLS,
                                                        block=local.block).bound()
            else:
                bound_ms, bound_by = bounds.window_scores(*geometry, steps, chunks, SYMBOLS).bound()
            ms = median_ms(fn)
            host = _host_s(fn)
            kernel_us, busy_us, span_us = profiled(fn, "window_kernel")
            out[f"{form}_{kernel}"] = rec.emit(
                f"window_{form}_{kernel}", kernel=kernel, form=form, lanes=lanes,
                windows_per_launch=windows, steps=steps, chunks=chunks, ms=ms,
                us_per_step=ms * 1e3 / steps, bound_ms=bound_ms, bound_by=bound_by,
                loop_us_per_chunk=ms * 1e3 / chunks,
                host_us_per_chunk=host * 1e6 / chunks,
                kernel_us_per_chunk=kernel_us / chunks if span_us else None,
                idle_share=1.0 - busy_us / span_us if span_us else None,
                # the profiler widens the gaps between launches; the same
                # share against the loop's own time, unprofiled
                idle_share_unprofiled=max(0.0, 1.0 - kernel_us / (ms * 1e3)) if span_us else None,
                profiled_span_ms=span_us / 1e3 if span_us else None,
            )
    return out


def launch_costs(rec: Record, device, seed: int = 0, steps=LAUNCH_STEPS) -> dict:
    """The device time of one launch of each window kernel in each form
    against its steps ``c`` (``torch.profiler`` kernel durations, median of
    LAUNCH_REPEATS back-to-back launches on the uniform batch, every lane
    taking every step): what a launch costs with no step (``c`` = 0: the
    tables, the carry in and out, the launch) and what a step adds."""
    from torch.profiler import ProfilerActivity, profile

    from spec_viterbi_tpu_torch.parallel import fused_tp

    hmm, local, rank = decoders(seed, device)
    rng = np.random.default_rng(seed + 2)
    seqs = [rng.integers(0, hmm.emit_num, size=T_LEN).astype(np.int32) for _ in range(max(LANES.values()))]
    out = {}
    for kernel, lanes in LANES.items():
        st, ln = local._stage(seqs[:lanes])
        v = local._em_t[:, st[0].long()] + local._pi[:, None]
        obs = st[1:]
        w0 = RANK * local.block
        forms = {"local": (local._local, v), "rank": (rank._rank, v[w0 : w0 + local.n_win].contiguous())}
        for form, (t, v_in) in forms.items():
            row = {}
            for c in steps:
                o = obs[:c].contiguous()
                lens = torch.full((lanes,), c + 1, dtype=torch.int32, device=device)
                dst = torch.full_like(v_in, float("inf"))
                bp = torch.empty((c, lanes, t.shards * t.block), dtype=torch.int16, device=device)

                def one():
                    if kernel == "scores_window":
                        fused_tp.scores_window(t, v_in, o, lens, out=dst)
                    else:
                        fused_tp.path_window(t, v_in, o, lens, out=dst, bp=bp)

                one()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(LAUNCH_REPEATS):
                        one()
                    torch.cuda.synchronize()
                durs = [e.time_range.end - e.time_range.start for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA and "window_kernel" in e.name]
                row[f"c{c}_us"] = statistics.median(durs) if durs else None
                del bp
            lo, hi = steps[-2], steps[-1]
            if row[f"c{lo}_us"] is not None and row[f"c{hi}_us"] is not None:
                row["us_per_step"] = (row[f"c{hi}_us"] - row[f"c{lo}_us"]) / (hi - lo)
            out[f"{form}_{kernel}"] = rec.emit(f"window_launch_{form}_{kernel}", lanes=lanes, **row)
    return out


def occupancy(rec: Record, device, seed: int = 0) -> dict:
    """Registers a thread, resident CTAs an SM and lanes a CTA of both
    window kernels in the arm the smoke model's tables take (the same
    arm in both forms), and the lane-windows one wave holds."""
    from spec_viterbi_tpu_torch.parallel import fused_tp

    _, local, rank = decoders(seed, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out = {}
    for kernel in ("scores", "path"):
        regs, ctas, lanes = fused_tp.window_occupancy(local._local, kernel, device)
        out[kernel] = rec.emit(
            f"occupancy_{kernel}_window", registers=regs, ctas_per_sm=ctas, lanes_per_cta=lanes,
            sms=sms, lane_windows_per_wave=ctas * lanes * sms, staged=local._local.staged,
            rank_staged=rank._rank.staged, n_win=local.n_win, smem_bytes=local._local.smem,
        )
    return out
