"""``host.stage_ms``: the mean over the window's calls of the time inside the
program's ``svt.stage`` span in which no kernel or copy ran (``spans.py``):
the batch's staging in ``FusedStructuredDecoder.decode_batch`` and
``decode_path_batch`` (the bucket and lane-chunk plan, then validation, the
H2D copies and ``_expand_symbols`` a bucket or chunk). Nothing where the
program records no such span."""

from svt_bench import spans


def read(run):
    return spans.mean_exposed_ms(run.trace, "svt.stage")
