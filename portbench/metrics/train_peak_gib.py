"""``torch.cuda.max_memory_allocated`` over the window, reset at its
start, the resident state included, in GiB."""


def read(run):
    return run.window.peak_bytes / 2**30 if run.window.peak_bytes else None
