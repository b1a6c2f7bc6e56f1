"""Milliseconds a point of the `battery` spans (`metric_battery_grid_async` and its finalize) in the window."""


def read(trace):
    if not trace.counters.get("units"):
        return None
    return trace.span_ns("battery") / 1e6 / trace.counters["units"]
