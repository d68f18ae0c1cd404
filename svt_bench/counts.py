"""The frozen yardstick: the work of a decode and the card's peaks.

The count depends only on the model and the lengths decoded, never on which
kernel or arm the program runs:

- operations: for each real symbol after a sequence's first, one add for
  every finite transition, the d - 1 mins that reduce a state's d finite
  incoming candidates, and one emission add for every state (19,242 a
  symbol at 2,407 states and 9,621 transitions; 4,002 at 502 and 2,001);
- bytes: the symbols (int32) and the model's tables (the transitions as
  source, destination and cost; the emissions; the start costs) read once,
  the final scores (float32, every state) and, where the calls ask for them,
  the paths (int32, a state a symbol) written once.

The peaks are NVIDIA's published H100 SXM figures at 700 W: f32 adds and
mins at one an FP32 lane a clock, 132 SMs × 128 lanes × 1.98 GHz (half the
67 TFLOP/s FMA rate: a min-plus step has no multiply to fuse), and HBM3 at
3.35 TB/s.
"""

from __future__ import annotations

import numpy as np

F32_OPS_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def ops_per_symbol(arrays: dict) -> int:
    """f32 operations a symbol after a sequence's first."""
    finite = np.isfinite(np.asarray(arrays["cost"]))
    reached = len(np.unique(np.asarray(arrays["dst"])[finite]))
    return 2 * int(finite.sum()) - reached + int(arrays["states"])


def table_bytes(arrays: dict) -> int:
    """Bytes of the model's tables, each read once."""
    finite = int(np.isfinite(np.asarray(arrays["cost"])).sum())
    return (finite * 3 + arrays["emissions"].size + 2 * len(arrays["start_states"])) * 4


def work(arrays: dict, lengths, paths: bool, calls: int = 1) -> tuple[float, float]:
    """(operations, bytes) of ``calls`` calls that decode sequences of
    ``lengths`` (the lengths of all of them together)."""
    lengths = np.asarray(lengths, np.int64)
    symbols = int(lengths.sum())
    ops = float(ops_per_symbol(arrays)) * float(np.maximum(lengths - 1, 0).sum())
    out = len(lengths) * int(arrays["states"]) * 4 + (symbols * 4 if paths else 0)
    nbytes = float(symbols * 4 + out) + float(table_bytes(arrays)) * calls
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(the least seconds the card could take, "operations" or "bytes")."""
    op_s, byte_s = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(op_s, byte_s), ("operations" if op_s >= byte_s else "bytes")
