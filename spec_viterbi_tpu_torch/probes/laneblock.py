"""S3: the lane-block question of ``scripts/exp_fs_laneblock2.py``, on the
H100.

On the TPU a wider lane block hands the compiler more independent chains
to interleave, and ``empty_run`` pinned the per-step floor of the widest
block. On the card one CTA of 256 threads runs one lane; the question is
whether 512 such CTAs (on 132 SMs) leave the card's latency unhidden,
and whether more lanes per CTA or more CTAs help. So this times:

- the ``empty`` probe with the step's symbol added (``empty_run``'s
  body) at 1, 2 and 4 lanes per CTA, [2,432, 512] carries, 3,496 steps;
- ``svt_scores_fs`` and both arms of ``svt_scores_masked`` (unmasked) on
  the corpus-shaped stand-in at 128, 256, 512 and 1,024 lanes (one CTA a
  lane, but the generic arm's L lanes a CTA; the batches repeat or cut
  the 512 sequences, so the lanes they share must give the same scores
  bit for bit): flat times while the chain's latency bounds a step, times
  that grow with the lanes once the SMs' throughput does; with the
  registers a thread and the CTAs an SM of these kernels and of both arms
  of ``svt_path``, as the card reports them (the generic arms in their
  shape at 512 lanes, with its lanes a CTA), so the lanes one wave holds.

It also gives the chain floors, which the bounds of the production
kernels leave out: the empty step's time at any carry length and CTA count
(:func:`empty_floor`), and the hop of a dependent pointer walk in shared
memory and through a 4 GB table (:func:`chase_floor`, ``svt_backtrace``'s
chain).
"""

from __future__ import annotations

import torch

from spec_viterbi_tpu_torch.ops import fused, probes
from spec_viterbi_tpu_torch.probes.common import (
    LANES,
    N_STATES,
    STATES_MATCH,
    T_LEN,
    CorpusBatch,
    PassInputs,
    Record,
    fit_slope,
    median_ms,
)

EMPTY_STEPS = 3496
CHASE_HOPS = {"chase": (1, 2, 4, 8), "chase_hbm": (1, 2)}  # hops a step timed
LANES_PER_CTA = (1, 2, 4)
FS_LANES = (128, 256, 512, 1024)


def empty_us_per_step(n: int, ctas: int, steps: int, seed: int, device,
                      lanes_per_cta: int = 1, symbols: bool = True) -> float:
    """µs per step of the ``empty`` probe on ``ctas * lanes_per_cta`` lanes
    of ``n`` states."""
    inp = PassInputs.make(n, ctas * lanes_per_cta, steps, seed, device)
    obs = inp.obs if symbols else None
    return median_ms(lambda: probes.probe_pass(
        "empty", inp.v0, steps, obs=obs, lanes_per_cta=lanes_per_cta)) * 1e3 / steps


def empty_floor(rec: Record, configs, steps: int, seed: int, device) -> dict:
    """The chain floor per ``(name, n, ctas)``: the empty probe's µs per
    step and that times ``steps``."""
    out = {}
    for name, n, ctas in configs:
        us = empty_us_per_step(n, ctas, EMPTY_STEPS, seed, device, symbols=False)
        out[name] = rec.emit(f"chain_floor_{name}", n=n, ctas=ctas, us_per_step=us,
                             steps=steps, floor_ms=us * steps / 1e3)
    return out


def chase_floor(rec: Record, lanes: int, n: int, steps: int, seed: int, device) -> dict:
    """The hop of ``svt_backtrace``'s chain: the slope over the hops a step
    of the ``chase`` probe's time on ``lanes`` lanes for ``steps`` steps,
    through one random ``n``-cycle held in shared memory (``chase``) and
    through random pointers of a [steps, lanes, n] int16 table in device
    memory (``chase_hbm``, 4.36 GB at 256 x 3,499 x 2,432). Each floor is
    ``steps`` hops: the staged walk's (shared) and the one-load-a-step
    walk's (HBM). Beside them, ``svt_backtrace`` itself at both ends of
    what its staging can meet (``backtrace_random``, ``backtrace_identity``):
    the random table (every step a miss) and identity pointers (none),
    each held to ``backtrace_plain``."""
    g = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(n, generator=g, device=device)
    cycle = torch.empty(n, dtype=torch.int16, device=device)
    cycle[order] = order.roll(-1).to(torch.int16)
    big = torch.randint(0, n, (steps, lanes, n), generator=g, device=device, dtype=torch.int16)
    v0 = torch.zeros((n, lanes), device=device)
    out = {}
    for cls, tab in (("chase", cycle), ("chase_hbm", big)):
        hops = CHASE_HOPS[cls]
        ms = [median_ms(lambda: probes.probe_pass(cls, v0, steps, tab=tab, p=p)) for p in hops]
        us = fit_slope(hops, ms) * 1e3 / steps
        out[cls] = rec.emit(f"chain_floor_chase_{'shared' if cls == 'chase' else 'hbm'}", n=n, lanes=lanes,
                            steps=steps, hops=list(hops), ms=ms, us_per_hop=us,
                            floor_ms=us * steps / 1e3, table_bytes=tab.numel() * 2)
    boundary = torch.randint(0, n, (lanes,), generator=g, device=device, dtype=torch.int32)
    for name in ("random", "identity"):
        if name == "identity":
            del big
            big = torch.arange(n, device=device, dtype=torch.int16).expand(steps, lanes, n).contiguous()
        same = bool(torch.equal(fused.backtrace(big, boundary), fused.backtrace_plain(big, boundary)))
        ms = median_ms(lambda: fused.backtrace(big, boundary))
        out[f"backtrace_{name}"] = rec.emit(f"backtrace_{name}", n=n, lanes=lanes, steps=steps, ms=ms,
                                            us_per_step=ms * 1e3 / steps, bit_equal=same)
    del big
    return out


def run(rec: Record, device, seed: int = 0, corpus: CorpusBatch | None = None) -> dict:
    out = {}
    for lpc in LANES_PER_CTA:
        us = empty_us_per_step(N_STATES, LANES // lpc, EMPTY_STEPS, seed, device, lanes_per_cta=lpc)
        out[f"empty_lpc{lpc}"] = rec.emit(f"empty_b{LANES}_lpc{lpc}", us_per_step=us,
                                          lanes_per_cta=lpc, ctas=LANES // lpc, steps=EMPTY_STEPS)
    corpus = corpus or CorpusBatch.make(STATES_MATCH, LANES, T_LEN, seed, device)
    fd = corpus.fd
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for name in probes.OCCUPANCY_KERNELS:
        regs, ctas = probes.scores_occupancy(name, fd.n, device)
        shape = {"lanes_a_cta": 1}
        if name in ("masked", "path"):  # the generic arms take L lanes a CTA
            g = fused.generic_shape(fd._masked, LANES, device, path=name == "path")
            shape = {key: g[key] for key in ("lanes_a_cta", "tables_in_shared_memory")}
        out[f"occupancy_{name}"] = rec.emit(
            f"occupancy_{name}", registers=regs, ctas_per_sm=ctas, sms=sms,
            lanes_per_wave=ctas * sms * shape["lanes_a_cta"], n=fd.n, **shape)
    first = None
    for lanes in FS_LANES:
        c = corpus.widened(lanes)
        steps = c.obs.shape[0]
        got = fused.scores_fs(fd._fs, fd.em, c.v0, c.obs)
        if first is None:
            first = got
        if not torch.equal(got[:, : first.shape[1]], first):
            raise RuntimeError(f"svt_scores_fs at {lanes} lanes differs from {FS_LANES[0]} lanes")
        for name, fn in (
            ("fs", lambda: fused.scores_fs(fd._fs, fd.em, c.v0, c.obs)),
            ("masked", lambda: fused.scores_masked(fd._masked, fd.em, c.v0, c.obs, None)),
            ("masked_planned", lambda: fused.scores_masked(fd._fs, fd.em, c.v0, c.obs, None)),
        ):
            ms = median_ms(fn)
            out[f"{name}_b{lanes}"] = rec.emit(
                f"{name}_b{lanes}", us_per_step=ms * 1e3 / steps, ms=ms,
                msym_per_s=lanes * (steps + 1) / (ms * 1e3), steps=steps)
    return out
