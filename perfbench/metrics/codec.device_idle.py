"""Per cent of the window in which no kernel ran on the device: 1 - the union
of the kernel intervals over the window's length."""


def read(trace):
    if not trace.kernels():
        return None
    return 100.0 * (1.0 - trace.busy_ns() / trace.window_ns)
