"""Seconds from the start of the process to the first timed request: import,
CUDA context, kernel load, input generation and warm-up."""


def read(run):
    return run.setup_s
