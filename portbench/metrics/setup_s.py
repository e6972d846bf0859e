"""setup_s (s): from the process's start to the end of warm-up (imports,
the card's context, the port's host library and kernels where they are
not built yet, every program of the cell built, the untimed traffic),
less the time spent making the input streams, which is the benchmark's
own work and is printed apart."""


def read(record):
    return record["setup_s"]
