"""stream_ms_per_mp.filters (ms/MP): the stream time of the port's
`Filters` device spans that closed in the window, over the megapixels
completed there. Launch-bound: the time runs between two CUDA events on
the stream the stage launches on, so it counts the time the stream waits
for its launching thread beside the device's work (the profiler's device
time of all the program's operations is device_ms_per_mp)."""

from portbench.recorder import stream_ms_per_mp


def read(record):
    return stream_ms_per_mp(record, "Filters")
