"""The 95th percentile of every encode request of the window, from the call
to the bytes returned, on the host clock."""

from perfbench.yardstick import percentile


def read(run):
    if not run.window.encode_ms:
        return None
    return percentile(run.window.encode_ms, 95)
