"""Run the H100 probes on the card, one JSON line per measurement.

    python3 -m spec_viterbi_tpu_torch.probes [--stage NAME ...] [--out DIR] [--seed N]

Every line names the card (``nvidia-smi`` name and power limit). With
``--out`` the results are also written to ``DIR/probes.json``. Without a
CUDA device it exits 1 and measures nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def main(argv=None) -> int:
    from spec_viterbi_tpu_torch.probes import STAGES, run_all
    from spec_viterbi_tpu_torch.probes.common import Record, card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", action="append", choices=list(STAGES),
                    help="a stage to run (repeatable; default: all)")
    ap.add_argument("--out", help="directory for probes.json")
    ap.add_argument("--seed", type=int, default=0, help="seed of every input")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probes: no CUDA device; nothing was measured", file=sys.stderr)
        return 1
    rec = Record(card_line())
    run_all(rec, torch.device("cuda"), args.seed, tuple(args.stage or STAGES))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "probes.json"), "w") as f:
            json.dump({"card": rec.card, "results": rec.results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
