"""RD points encoded, decoded and scored over the whole window, per second
of the window."""


def read(run):
    return run.window.units / run.window.seconds
