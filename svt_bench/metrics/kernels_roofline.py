"""``kernels_roofline``: the frozen bound of the window's work
(``counts.py``: the larger of its operations over the f32 peak and its
bytes over the HBM rate) over the summed device time of every kernel in the
window, whatever kernel or arm runs it, in %."""

from svt_bench import counts


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(run.trace.device_sums(kernels_only=True).values())
    if kernel_s <= 0:
        return None
    ops, nbytes = counts.work(run.arrays, run.lengths_done(), bool(run.cell.mix["paths"]),
                              calls=len(run.calls))
    return 100.0 * counts.bound_s(ops, nbytes)[0] / kernel_s
