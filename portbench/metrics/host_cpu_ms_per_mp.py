"""host_cpu_ms_per_mp (ms/MP): the threads' CPU time inside the port's
`Host entropy stage`, `Fused program inputs` and `Stacked program inputs`
spans that closed in the window (each span's `cpu_ns`, from
time.thread_time_ns), over the megapixels completed there. Python, and
native code run on the span's own thread."""

from portbench.recorder import host_split


def read(record):
    split = host_split(record)
    if split is None:
        return None
    return split["host_cpu"] / 1e6 / record["mp"]
