"""``setup_s``: seconds from the process's start to the first timed call
(imports, the model and the pool, the kernels' build or load, the warm-up
calls), on the host's clock."""


def read(run):
    return run.setup_s
