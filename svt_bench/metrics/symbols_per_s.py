"""``symbols_per_s``: the real symbols (no padding) of every call completed
in the window, over the seconds from the window's start to the last
completion, on the host's clock."""


def read(run):
    if not run.calls:
        return None
    return run.symbols() / (run.calls[-1][1] - run.calls[0][0])
