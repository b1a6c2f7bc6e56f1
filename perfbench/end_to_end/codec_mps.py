"""Megapixels encoded and then decoded (round trips) over the whole window,
per second of the window."""


def read(run):
    return run.window.megapixels / run.window.seconds
