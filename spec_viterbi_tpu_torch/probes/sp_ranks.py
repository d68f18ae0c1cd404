"""The dense time-parallel decode over NCCL ranks, one card each.

Run on a machine with two or more cards, from the repository root::

    python3 -m spec_viterbi_tpu_torch.probes.sp_ranks [--prefix 1000]

It decodes the first ``--prefix`` symbols of the seeded corpus stand-in's
first uniform sequence (2,407 states, the sequences of ``probes/common``)
with ``decode_time_parallel`` on a local ``time`` group of as many shards
as ranks on card 0, then spawns 4 ranks (2 with two or three cards) that
decode it over the ranks (``make_group(device, axis=TIME_AXIS)``: each
rank composes its block, the blocks are all-gathered), each twice, and
holds rank 0's result bit-equal to the local group's. It prints one JSON
line naming the card: the local group's warm seconds and the ranks'
seconds of both runs. Exits 1 with fewer than two cards.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import tempfile
import time

import numpy as np
import torch

SPAWN_SECONDS = 600


def _inputs(prefix: int):
    from spec_viterbi_tpu_torch.io import generate_profile_hmm
    from spec_viterbi_tpu_torch.probes.common import STATES_MATCH, T_LEN

    hmm = generate_profile_hmm(STATES_MATCH, seed=0)
    seq = np.random.default_rng(0).integers(0, hmm.emit_num, size=T_LEN).astype(np.int32)
    return hmm, seq[:prefix]


def _rank(rank: int, world: int, init_file: str, out_file: str, prefix: int) -> None:
    from spec_viterbi_tpu_torch.parallel import TIME_AXIS, decode_time_parallel, init_distributed, make_group

    dev = torch.device(f"cuda:{rank}")
    torch.cuda.set_device(dev)
    init_distributed(f"file://{init_file}", world, rank, device=dev)
    try:
        hmm, seq = _inputs(prefix)
        group = make_group(dev, axis=TIME_AXIS)
        secs = []
        for _ in range(2):  # the second run warm (NCCL set up)
            torch.distributed.barrier(device_ids=[rank])
            t0 = time.perf_counter()
            got = decode_time_parallel(hmm, seq, group)
            secs.append(time.perf_counter() - t0)
        if rank == 0:
            np.savez(out_file, scores=got, seconds=np.array(secs))
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prefix", type=int, default=1000, help="symbols of the sequence decoded")
    args = ap.parse_args(argv)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        print(f"sp_ranks: needs two or more CUDA devices, found {count}", file=sys.stderr)
        return 1
    from spec_viterbi_tpu_torch.ops import _build
    from spec_viterbi_tpu_torch.parallel import TIME_AXIS, decode_time_parallel, make_group
    from spec_viterbi_tpu_torch.probes.common import card_line

    _build.library()
    world = 4 if count >= 4 else 2
    hmm, seq = _inputs(args.prefix)
    group = make_group(torch.device("cuda:0"), world, axis=TIME_AXIS)
    decode_time_parallel(hmm, seq, group)
    t0 = time.perf_counter()
    local = decode_time_parallel(hmm, seq, group)
    local_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, world, f"{tmp}/rendezvous", f"{tmp}/out.npz", args.prefix))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SPAWN_SECONDS
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if hung or any(p.exitcode for p in procs):
            print(f"sp_ranks: ranks {hung} hung, exit codes {[p.exitcode for p in procs]}", file=sys.stderr)
            return 1
        with np.load(f"{tmp}/out.npz") as z:
            scores, secs = z["scores"], z["seconds"].tolist()
    if not np.array_equal(scores, local):
        print("sp_ranks: the ranks' scores differ from the local group's", file=sys.stderr)
        return 1
    print(json.dumps({"probe": "sp_ranks", "card": card_line(), "ranks": world, "symbols": len(seq),
                      "bit_equal_local": True, "local_seconds": local_s, "rank_seconds": secs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
