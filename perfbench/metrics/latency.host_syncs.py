"""Host synchronisations of one encode of the cell's first image, counted
with `torch.cuda.set_sync_debug_mode("warn")` after the traced window."""


def read(trace):
    return trace.counters.get("host_syncs")
