"""Launch times of ``svt_minplus`` at the dense and specializer shapes.

It times the kernel of whichever ``spec_viterbi_tpu_torch`` comes first on
``sys.path``, so two trees compare in one call: run this file by path, with
``PYTHONPATH`` set to each tree in turn (parent, change, change, parent)::

    PYTHONPATH=<tree> python3 spec_viterbi_tpu_torch/probes/minplus.py [--tag NAME]

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
- ``host_us``: the host's µs a call of each part of one dense
  ``run_batch`` step at 56 lanes (``perf_counter`` around 100 calls,
  median of 5 rounds, the device synchronised between rounds): the step
  as the decoder runs it, the wrapper, and the wrapper's and the loop's
  parts one by one.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="", help="a name for the tree under test")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("minplus: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import spec_viterbi_tpu_torch
    from spec_viterbi_tpu_torch.ops import _build, tropical
    from spec_viterbi_tpu_torch.probes.common import card_line, median_ms

    _build.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.as_tensor(rng.normal(5, 2, size=shape).astype(np.float32), device=dev)

    def chain_ms(a_j, v, am, a_idx=None):
        return median_ms(lambda: [tropical.minplus(a_j, v, a_idx, argmin=am) for _ in range(CHAIN)],
                         repeats=3) / CHAIN

    def same(got, want, am):
        return bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) if am
                    else torch.equal(got, want))

    a = normal(N, N)
    a_rm = a.T.contiguous()[None]  # the same operator, k contiguous
    out = {"tag": args.tag, "package": spec_viterbi_tpu_torch.__file__, "card": card_line()}
    for j in (56, 8, 512):
        v = normal(1, N, j)
        for am in (False, True):
            name = f"j{j}{'_argmin' if am else ''}"
            turns = [chain_ms(x, v, am) for x in (a.T[None], a_rm, a_rm, a.T[None])]
            out[f"{name}_ms"] = [turns[0], turns[3]]
            out[f"{name}_rowmajor_ms"] = [turns[1], turns[2]]
            got = tropical.minplus(a.T[None], v, argmin=am)
            out[f"{name}_bit_equal"] = (same(got, tropical.minplus_plain(a.T[None], v, argmin=am), am)
                                        and same(got, tropical.minplus(a_rm, v, argmin=am), am))
    copies = [a_rm.clone() for _ in range(COLD_COPIES)]
    v1 = normal(1, N, 1)
    for am in (False, True):
        name = f"j1{'_argmin' if am else ''}"
        out[f"{name}_ms"] = chain_ms(a_rm, v1, am)
        out[f"{name}_cold_ms"] = median_ms(
            lambda: [tropical.minplus(copies[c % COLD_COPIES], v1, argmin=am) for c in range(CHAIN)],
            repeats=3) / CHAIN
        out[f"{name}_bit_equal"] = same(tropical.minplus(a_rm, v1, argmin=am),
                                        tropical.minplus_plain(a_rm, v1, argmin=am), am)
    del copies
    ops = normal(21, N, N)
    out["build_launch_21_products_ms"] = median_ms(lambda: tropical.minplus(ops[3][None], ops), repeats=3)
    idx = torch.as_tensor(rng.integers(0, 21, size=50), device=dev)
    out["gathered_50_lanes_ms"] = chain_ms(ops, normal(50, N, 1), False, idx)
    del ops

    # ---- the host's cost of one dense run_batch step, part by part ------
    lanes, e = 56, 20
    em_t = normal(e, N).T
    obs = torch.as_tensor(rng.integers(0, e, size=(8, lanes)), device=dev)
    lengths = torch.full((lanes,), 8, dtype=torch.int32, device=dev)
    v = normal(N, lanes)
    a_tn, b = a.T[None], v[None]
    shape = tropical.minplus_shape(1, N, N, lanes, dev)
    c = torch.empty((1, N, lanes), device=dev)
    ws = torch.empty((shape["splits"], 1, N, lanes), device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    t = 3

    def step():
        v_new = em_t[:, obs[t]] + tropical.minplus(a.T[None], v.contiguous()[None])[0]
        return torch.where((t < lengths)[None, :], v_new, v)

    def launch():  # the wrapper's ctypes call with its arguments ready
        lib.svt_minplus(a_tn.data_ptr(), None, b.data_ptr(), c.data_ptr(), None, 0, a_tn.stride(1),
                        a_tn.stride(2), 1, N, N, lanes, ws.data_ptr(), None, stream)

    def device_context():
        with torch.cuda.device(dev):
            pass

    keep = (t < lengths)[None, :]
    parts = {
        "step": step,
        "wrapper": lambda: tropical.minplus(a_tn, b),
        "launch_ctypes": launch,
        "shape_lookup": lambda: tropical.minplus_shape(1, N, N, lanes, dev),
        "out_empty": lambda: torch.empty((1, N, lanes), device=dev),
        "workspace_empty": lambda: torch.empty((shape["splits"], 1, N, lanes), device=dev),
        "library": _build.library,
        "device_context": device_context,
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "views": lambda: (a.T[None], v.contiguous()[None], c[0]),
        "obs_row": lambda: obs[t],
        "emission_gather": lambda: em_t[:, obs[t]],
        "add": lambda: c[0] + v,
        "mask": lambda: (t < lengths)[None, :],
        "where": lambda: torch.where(keep, c[0], v),
    }
    out["host_us"] = {name: host_us(fn) for name, fn in parts.items()}
    out["host_splits"] = shape["splits"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
