"""``decode_mfu``: the frozen operation count of the window's real symbols
(``counts.py``) over the traced window's seconds times the card's f32 peak,
in %: the whole decode's share of the chip, whichever kernels run it."""

from svt_bench import counts


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    lo, hi = run.trace.window
    ops, _ = counts.work(run.arrays, run.lengths_done(), bool(run.cell.mix["paths"]))
    return 100.0 * ops / ((hi - lo) * counts.F32_OPS_PER_S)
