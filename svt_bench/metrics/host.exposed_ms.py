"""``host.exposed_ms``: the mean over the window's calls of each call's wall
time in which no kernel or copy ran on the device (from the ``torch.profiler``
trace): the host's work that the device does not hide (the scheduler's plan,
the decoder's construction, the batch's staging, the answers' unpacking),
whichever order the call launches its work in."""


def read(run):
    if run.trace is None:
        return None
    exposed = run.trace.exposed_s()
    return 1e3 * sum(exposed) / len(exposed)
