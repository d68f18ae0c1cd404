"""The control of the check that decides ``correct``: the plain reference put
in the program's place and computed in bfloat16, the nearest precision below
the configurations' float32. Its runs must come out not correct.

    python3 svt_bench/control.py --workload NAME --seeds 1,2,3 [--program]

runs, for each seed, one call at the cell's own shape (its first pool batch;
every lane's answer kept, so the sample is as large as a run's) and prints
one JSON line of the numbers the check compared. With ``--program`` it runs
the program itself the same way, for the sound readings. The benchmark's own
runs never run it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from svt_bench import reference  # noqa: E402
from svt_bench.harness import Cell, run_cell  # noqa: E402


class Bf16Entry:
    """The reference in bfloat16 behind the entry's interface."""

    @staticmethod
    def setup(arrays: dict, mix: dict, device) -> dict:
        return {"model": reference.Model(arrays, device, torch.bfloat16),
                "paths": bool(mix["paths"]), "block": int(mix["block"])}

    @staticmethod
    def call(state: dict, batch: list) -> list:
        return reference.decode(state["model"], batch, paths=state["paths"], block=state["block"])


def readings(cell: Cell, seed: int, device, program: bool = False) -> dict:
    """The checks of one short run: one call at the cell's shape, every lane
    kept."""
    one = dataclasses.replace(cell, mix={**cell.mix, "pool": 1})
    result = run_cell(one, seed, 0.0, False, device, time.perf_counter(),
                      entry=None if program else Bf16Entry, keep=int(cell.mix["lanes"]))
    return {"seed": seed, "correct": result["correct"], "checks": result["checks"]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = Cell.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = readings(cell, seed, "cuda:0", program=args.program)
        print(json.dumps({"workload": cell.name, "program": args.program, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
