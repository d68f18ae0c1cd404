"""Print the headline benchmark's JSON line, measured on the card.

    python3 -m spec_viterbi_tpu_torch.bench [--chmm MODEL] [--ess WORKLOAD] [--seed N]

Without ``--chmm`` it decodes the seeded 2,407-state stand-in, without
``--ess`` 50 seeded sequences of 3,500 symbols
(:mod:`spec_viterbi_tpu_torch.bench.headline`). Without a CUDA device it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def main(argv=None) -> int:
    from spec_viterbi_tpu_torch.bench import headline

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chmm", help="the model (.chmm); default: the seeded stand-in")
    ap.add_argument("--ess", help="the workload sequences (.ess); default: seeded")
    ap.add_argument("--seed", type=int, default=0, help="seed of the stand-ins and the floor probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device; nothing was measured", file=sys.stderr)
        return 1
    hmm, seqs, model, work = headline.load_inputs(args.chmm, args.ess, args.seed)
    line = headline.run(hmm, seqs, device="cuda", model=f"{model}; {work}", seed=args.seed)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
