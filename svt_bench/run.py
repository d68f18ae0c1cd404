"""Runs one cell of the port's benchmark once and prints its result line.

    python3 svt_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds the port (``spec_viterbi_tpu_torch``)
and ``BENCHMARK.json``. With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
a ``torch.profiler`` trace of the window. The last lines on standard error,
and the result's last key (``checks``), give each number the check compared
with its limit. The last line on standard output is the result.

Exits with 2, and prints no result, without a CUDA device (or with fewer than
the cell asks for), or when ``jax``, ``jaxlib``, ``flax`` or the JAX package
``spec_viterbi_tpu`` is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare() -> None:
    """As a script: the checkout's root, not this folder, leads the import
    path, and every kernel cache sits at a fixed place inside the checkout."""
    sys.path[0] = ROOT
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".svtb_cache", "triton")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else proc.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as exc:
        return f"nvidia-smi: {exc!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from svt_bench.harness import Cell, forbidden_modules, run_cell

    cell = Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); {have} available",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    prepare()
    sys.exit(main())
