"""``host.build_ms``: the mean over the window's calls of the time inside the
program's ``svt.build`` span in which no kernel or copy ran (``spans.py``):
the decoder's construction in ``execute_route`` (``ViterbiDecoder.__init__``:
the operator, its tensors, ``DeviceHMM``, the fused decoder's plans and
tables). Nothing where the program records no such span."""

from svt_bench import spans


def read(run):
    return spans.mean_exposed_ms(run.trace, "svt.build")
