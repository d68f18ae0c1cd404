"""``host.fetch_ms``: the mean over the window's calls of the time inside the
program's ``svt.fetch`` span in which no kernel or copy ran (``spans.py``):
the answers' fetch in ``FusedStructuredDecoder.decode_batch`` and
``decode_path_batch`` (``torch.cat``, the D2H copies and the per-lane lists).
Nothing where the program records no such span."""

from svt_bench import spans


def read(run):
    return spans.mean_exposed_ms(run.trace, "svt.fetch")
