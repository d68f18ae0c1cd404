"""Launch times of ``svt_minplus`` at the dense and specializer shapes.

It times the kernel of whichever ``spec_viterbi_tpu_torch`` comes first on
``sys.path``, so two trees compare in one call: run this file by path, with
``PYTHONPATH`` set to each tree in turn (parent, change, change, parent)::

    PYTHONPATH=<tree> python3 spec_viterbi_tpu_torch/probes/minplus.py [--tag NAME] [--tune]

It prints one JSON line naming the card, with, in ms a launch (the median
of 3 CUDA-event timings of a chain of 100 launches, each operand set
checked bit-equal to ``minplus_plain``):

- the 2,432-state dense batch step at 56, 8 and 512 lanes, with and
  without argmin, in both layouts of the operator: the transposed view of
  the untransposed matrix (``j56_ms``, i contiguous) and its row-major
  copy (``j56_rowmajor_ms``, k contiguous), timed in turns (view, copy,
  copy, view) and held bit-equal to each other;
- the J = 1 step, with and without argmin, on one operator reused by
  every launch (``j1_ms``: it stays in the 50 MB L2, as in the dense
  decode loop) and on ``COLD_COPIES`` copies taken in turn (``j1_cold_ms``:
  each launch reads its operator from HBM);
- one level-2 build launch (21 products of 2,432², median of 3) and one
  gathered 50-lane launch;
- ``*_device_us``: the device µs a launch of the same chains under
  ``torch.profiler`` (where the host is slower than the kernel, as for
  J = 1, the events time the host);
- ``run_batch``: the decoder's dense batch loop (``_decode_scores_batch``)
  at 56 lanes × 3,500 symbols: its wall time (host clock, synchronised,
  median of 3), the host's µs a step against the kernel's device µs a
  launch under ``torch.profiler``, and the device's idle share;
- ``host_us``: the host's µs a call of each part of one dense step at 56
  lanes (``perf_counter`` around 100 calls, median of 5 rounds, the device
  synchronised between rounds): the step as the decoder runs it, and its
  parts one by one (a tree whose decoder has the one-launch step,
  ``tropical.dense_step``, is taken apart as that; an older tree as its
  product, gather, add, mask and ``where``);
- with ``--tune`` (a tree with ``tropical.minplus_tune``): the 56-lane
  step at each pinned cluster size (``tune_ms``).

With ``--plan7`` it prints only the ``plan7`` line: the dense batch step of
a Plan7 profile at LENG 500 (``io.generate_plan7_hmm(500)``, 1,024 padded
states, 12% finite) at 512 lanes, lanes masked past their lengths, as
``tropical.dense_step`` launches it: the median of 5 CUDA-event timings of
a chain of 100 steps, in µs a step, without a block list and (a tree whose
``DeviceHMM`` has one) with the operator's list, at the shape function's
cluster and at each pinned cluster size; every output bit-equal to the
launch without a list and to ``dense_step_plain``.

Seeded operands, normal(5, 2). Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

N = 2432  # the corpus stand-in's padded states
CHAIN = 100
COLD_COPIES = 8  # 8 x 23.7 MB: a copy comes back after 166 MB of others
HOST_CALLS, HOST_ROUNDS = 100, 5
DENSE_LANES, DENSE_T, EMIT = 56, 3500, 20
TUNE = (0, 1, 2, 4, 8, 16)  # pinned cluster sizes of --tune (0: the shape function's)
PLAN7_LENG, PLAN7_LANES = 500, 512  # --plan7: the benchmark's Plan7 cell


def host_us(fn) -> float:
    """Median over ``HOST_ROUNDS`` of the host's µs a call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(HOST_ROUNDS):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        per.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def plan7_step(dev, rng) -> dict:
    """The ``plan7`` line: µs a dense step of the Plan7 profile at
    ``PLAN7_LANES`` lanes without a list and with its list, at the shape
    function's cluster and at each of ``TUNE``'s pinned sizes."""
    from spec_viterbi_tpu_torch.io import generate_plan7_hmm
    from spec_viterbi_tpu_torch.models.decoder import DeviceHMM
    from spec_viterbi_tpu_torch.ops import tropical
    from spec_viterbi_tpu_torch.probes.common import median_ms

    dh = DeviceHMM.from_hmm(generate_plan7_hmm(PLAN7_LENG, seed=0), device=dev)
    n, lanes = dh.padded, PLAN7_LANES
    a_view, em_t = dh.a.T, dh.emissions.T
    v = torch.as_tensor(rng.normal(5, 2, size=(n, lanes)).astype(np.float32), device=dev)
    v[::7] = float("inf")  # the carry's unreachable states
    obs = torch.as_tensor(rng.integers(0, 20, size=(8, lanes)).astype(np.int32), device=dev)
    lengths = torch.as_tensor(np.resize(np.array([8, 8, 8, 3, 4, 5], np.int32), lanes), device=dev)
    t = 4  # lanes of length 3 and 4 keep their carry
    want = tropical.dense_step_plain(a_view, v, em_t, obs, lengths, t)
    blk = getattr(dh, "blocks", None)
    variants = {"none": None} if blk is None else {"none": None, "list": blk}
    out = {"states": n, "lanes": lanes, "finite": getattr(dh, "finite", None),
           "list": None if blk is None else {"tiles": blk.tiles, "listed": blk.listed,
                                             "most": blk.most}}
    tune = (0,) + (tuple(c for c in TUNE if c) if hasattr(tropical, "minplus_tune") else ())
    for name, listed in variants.items():
        kw = {"blocks": listed} if listed is not None else {}
        c = torch.empty_like(v)
        for cl in tune:
            if cl:
                tropical.minplus_tune(cl)
            try:
                def chain():
                    for _ in range(CHAIN):
                        tropical.dense_step(a_view, v, em_t, obs, lengths, t, c, **kw)

                us = median_ms(chain, repeats=5) / CHAIN * 1e3
                shape = tropical.minplus_shape(1, n, n, lanes, dev, **kw)
                out[f"{name}_cluster{cl or 'auto'}"] = {
                    "us": us, "cluster": shape["cluster"], "tile": shape["tile"],
                    "ctas": shape["ctas"], "resident_ctas": shape["resident_ctas"],
                    "bit_equal": bool(torch.equal(c, want))}
            finally:
                if cl:
                    tropical.minplus_tune()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="", help="a name for the tree under test")
    ap.add_argument("--tune", action="store_true", help="time the pinned cluster sizes")
    ap.add_argument("--plan7", action="store_true", help="time only the Plan7 step at 512 lanes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("minplus: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import spec_viterbi_tpu_torch
    from spec_viterbi_tpu_torch.models import decoder
    from spec_viterbi_tpu_torch.ops import _build, tropical
    from spec_viterbi_tpu_torch.probes.common import card_line, median_ms, profiled

    _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    one_launch = hasattr(tropical, "dense_step")

    def normal(*shape):
        return torch.as_tensor(rng.normal(5, 2, size=shape).astype(np.float32), device=dev)

    def chain_ms(a_j, v, am, a_idx=None):
        return median_ms(lambda: [tropical.minplus(a_j, v, a_idx, argmin=am) for _ in range(CHAIN)],
                         repeats=3) / CHAIN

    def device_us(a_j, v, am, a_idx=None, copies=None):
        """The device µs a launch under torch.profiler (a chain whose host
        is slower than its kernel times the host with events)."""
        def fn():
            for c in range(CHAIN):
                tropical.minplus(copies[c % COLD_COPIES] if copies else a_j, v, a_idx, argmin=am)

        fn()
        return profiled(fn, "minplus")[0] / CHAIN

    def shape(*args, **kw):  # an older tree's minplus_shape takes no layout
        try:
            return tropical.minplus_shape(*args, **kw)
        except TypeError:
            return tropical.minplus_shape(*args)

    def same(got, want, am):
        return bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) if am
                    else torch.equal(got, want))

    a = normal(N, N)
    a_rm = a.T.contiguous()[None]  # the same operator, k contiguous
    out = {"tag": args.tag, "package": spec_viterbi_tpu_torch.__file__, "card": card_line(),
           "one_launch_step": one_launch}
    if args.plan7:
        out["plan7"] = plan7_step(dev, rng)
        print(json.dumps(out), flush=True)
        return 0
    for j in (56, 8, 512):
        v = normal(1, N, j)
        for am in (False, True):
            name = f"j{j}{'_argmin' if am else ''}"
            turns = [chain_ms(x, v, am) for x in (a.T[None], a_rm, a_rm, a.T[None])]
            out[f"{name}_ms"] = [turns[0], turns[3]]
            out[f"{name}_rowmajor_ms"] = [turns[1], turns[2]]
            out[f"{name}_device_us"] = device_us(a.T[None], v, am)
            got = tropical.minplus(a.T[None], v, argmin=am)
            out[f"{name}_bit_equal"] = (same(got, tropical.minplus_plain(a.T[None], v, argmin=am), am)
                                        and same(got, tropical.minplus(a_rm, v, argmin=am), am))
        out[f"j{j}_shape"] = shape(1, N, N, j, dev)
    copies = [a_rm.clone() for _ in range(COLD_COPIES)]
    v1 = normal(1, N, 1)
    for am in (False, True):
        name = f"j1{'_argmin' if am else ''}"
        out[f"{name}_ms"] = chain_ms(a_rm, v1, am)
        out[f"{name}_cold_ms"] = median_ms(
            lambda: [tropical.minplus(copies[c % COLD_COPIES], v1, argmin=am) for c in range(CHAIN)],
            repeats=3) / CHAIN
        out[f"{name}_device_us"] = device_us(a_rm, v1, am)
        out[f"{name}_cold_device_us"] = device_us(None, v1, am, copies=copies)
        out[f"{name}_bit_equal"] = same(tropical.minplus(a_rm, v1, argmin=am),
                                        tropical.minplus_plain(a_rm, v1, argmin=am), am)
    del copies
    ops = normal(21, N, N)
    out["build_launch_21_products_ms"] = median_ms(lambda: tropical.minplus(ops[3][None], ops), repeats=3)
    out["build_bit_equal"] = same(tropical.minplus(ops[3][None], ops[:2]),
                                  tropical.minplus_plain(ops[3][None], ops[:2]), False)
    out["build_shape"] = shape(21, N, N, N, dev, i_contiguous=False)
    idx = torch.as_tensor(rng.integers(0, 21, size=50), device=dev)
    v50 = normal(50, N, 1)
    out["gathered_50_lanes_ms"] = chain_ms(ops, v50, False, idx)
    out["gathered_50_lanes_device_us"] = device_us(ops, v50, False, idx)
    del ops

    if args.tune and hasattr(tropical, "minplus_tune"):
        v = normal(1, N, DENSE_LANES)
        want = tropical.minplus_plain(a.T[None], v)
        tune = {}
        for c in TUNE:
            tropical.minplus_tune(c)
            key = f"cluster{c or 'auto'}"
            tune[key] = {"ms": chain_ms(a.T[None], v, False),
                         "shape": shape(1, N, N, DENSE_LANES, dev),
                         "bit_equal": same(tropical.minplus(a.T[None], v), want, False)}
        tropical.minplus_tune()
        out["tune_ms"] = tune

    # ---- the dense batch loop and the host's cost of one step -----------
    em = normal(EMIT, N)
    pi = normal(N)
    seqs_t = torch.as_tensor(rng.integers(0, EMIT, size=(DENSE_T, DENSE_LANES)).astype(np.int32), device=dev)
    lengths = torch.full((DENSE_LANES,), DENSE_T, dtype=torch.int32, device=dev)
    steps = DENSE_T - 1

    def run():
        return decoder._decode_scores_batch(a, pi, em, seqs_t, lengths)

    def wall_ms():
        run()
        torch.cuda.synchronize()
        per = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(per)

    ms = wall_ms()
    kernel_us, busy_us, span_us = profiled(run, "minplus")
    out["run_batch"] = {"lanes": DENSE_LANES, "steps": steps, "ms": ms, "us_per_step": ms * 1e3 / steps,
                        "kernel_us_per_launch": kernel_us / steps if span_us else None,
                        "idle_share": 1.0 - busy_us / span_us if span_us else None}

    em_t = em.T
    obs = seqs_t
    v = normal(N, DENSE_LANES)
    c = torch.empty((N, DENSE_LANES), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    t = 3
    if one_launch:
        lib = _build.library()
        obs_ptr = obs.data_ptr() + t * obs.stride(0) * 4
        a_tn = a.T

        no_list = (None, -1) if len(lib.svt_minplus.argtypes) > 21 else ()  # a tree with lists

        def launch():  # the step's ctypes call with its arguments ready
            lib.svt_minplus(a_tn.data_ptr(), None, v.data_ptr(), c.data_ptr(), None, 0, 1, N, 1, N,
                            N, DENSE_LANES, em_t.data_ptr(), 1, N, obs_ptr, 0, lengths.data_ptr(), t,
                            0, *no_list, stream)

        def device_context():
            with torch.cuda.device(dev):
                pass

        parts = {
            "step": lambda: tropical.dense_step(a_tn, v, em_t, obs, lengths, t, c, stream=stream),
            "step_own_stream": lambda: tropical.dense_step(a_tn, v, em_t, obs, lengths, t, c),
            "launch_ctypes": launch,
            "device_guard": lambda: tropical._device_guard(dev),
            "device_context": device_context,
            "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
            "data_ptrs": lambda: (a_tn.data_ptr(), v.data_ptr(), c.data_ptr(), em_t.data_ptr(),
                                  obs.data_ptr(), lengths.data_ptr()),
            "library": _build.library,
        }
    else:
        keep = (t < lengths)[None, :]

        def step():
            v_new = em_t[:, obs[t].long()] + tropical.minplus(a.T[None], v.contiguous()[None])[0]
            return torch.where((t < lengths)[None, :], v_new, v)

        parts = {
            "step": step,
            "wrapper": lambda: tropical.minplus(a.T[None], v[None]),
            "emission_gather": lambda: em_t[:, obs[t].long()],
            "add": lambda: c + v,
            "mask": lambda: (t < lengths)[None, :],
            "where": lambda: torch.where(keep, c, v),
        }
    out["host_us"] = {name: host_us(fn) for name, fn in parts.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
