"""The rANS encode kernel (B3, `csrc/rans_enc.cu`)'s share of its roofline, in per cent: the bytes its launches in
the window must move (`yardstick.encode_bytes` at each stream's steps, lanes, words
and mantissa bytes) over the peak memory rate, divided by the time its
kernels (`rans_encode_kernel`) ran in the window."""

from perfbench import streams, yardstick


def read(trace):
    kernels = trace.kernels("rans_encode_kernel")
    if not kernels or not trace.containers:
        return None
    nbytes = sum(yardstick.encode_bytes(*streams.shape(c)) for c in trace.containers)
    busy = yardstick.union_ns([(s, e) for _n, s, e in kernels])
    return 100.0 * (nbytes / yardstick.PEAK_BW) / (busy / 1e9)
