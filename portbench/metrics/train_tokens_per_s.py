"""Training tokens of every step that ended inside the window, over the
time from the window's start to the end of the last of them (host
clock; each step ends with its loss read to the host)."""


def read(run):
    w = run.window
    return w.tokens / w.ends[-1] if w.steps else None
