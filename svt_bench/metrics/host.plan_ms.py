"""``host.plan_ms``: the mean over the window's calls of the time inside the
program's ``svt.plan`` span in which no kernel or copy ran (``spans.py``): the
scheduler's plan (``Workload.from_seqs``, ``plan_route`` with its
``StructuredOperator.from_hmm``). Nothing where the program records no such
span."""

from svt_bench import spans


def read(run):
    return spans.mean_exposed_ms(run.trace, "svt.plan")
