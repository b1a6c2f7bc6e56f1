"""`rans_enc_roofline` in the striped cell: B3's share of its roofline, in per cent,
with the bytes (`yardstick.encode_bytes`) summed over every section of every
container of the window, read with the frozen striped reader, over the peak memory
rate, divided by the time its kernels (`rans_encode_kernel`) ran in the window."""

from perfbench import streams, yardstick
from perfbench.reference.striped import read_striped


def read(trace):
    kernels = trace.kernels("rans_encode_kernel")
    if not kernels or not trace.containers:
        return None
    nbytes = sum(yardstick.encode_bytes(*streams.shape(s)) for c in trace.containers for s in read_striped(c)[2])
    busy = yardstick.union_ns([(s, e) for _n, s, e in kernels])
    return 100.0 * (nbytes / yardstick.PEAK_BW) / (busy / 1e9)
