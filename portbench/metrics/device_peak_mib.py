"""device_peak_mib (MiB): torch.cuda.max_memory_allocated() over the window,
the peak statistics reset at its opening."""


def read(record):
    return record["peak_bytes"] / 2**20 if record["peak_bytes"] else None
