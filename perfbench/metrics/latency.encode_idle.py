"""Per cent of the time inside the `encode` spans in which no kernel ran: the
share of an encode's latency that the device waits for the host."""


def read(trace):
    span = trace.span_ns("encode")
    busy = trace.busy_in_ns("encode")
    return 100.0 * (1.0 - busy / span) if span and busy else None
