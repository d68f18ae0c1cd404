"""``host.launch_ms``: the mean over the window's calls of the time inside the
program's ``svt.launch`` span in which no kernel or copy ran (``spans.py``):
the launches in ``FusedStructuredDecoder.decode_batch`` and
``decode_path_batch`` (``v0``, the kernels' wrappers, argmin,
``svt_backtrace``, transposes and slices, a bucket or chunk). Nothing where
the program records no such span."""

from svt_bench import spans


def read(run):
    return spans.mean_exposed_ms(run.trace, "svt.launch")
