"""The host's wait for the next staged batch (``next`` on the port's
``PrefetchQueue``), summed over the window's steps, over their number;
milliseconds, host clock."""


def read(run):
    w = run.window
    return 1e3 * sum(w.waits) / w.steps if w.steps else None
