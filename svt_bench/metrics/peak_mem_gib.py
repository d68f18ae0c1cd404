"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the window
(reset at its start), in GiB; nothing on a run without a card."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30
