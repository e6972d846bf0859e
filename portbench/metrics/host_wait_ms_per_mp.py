"""host_wait_ms_per_mp (ms/MP): the time the host stages' threads were off
the CPU outside native calls, that is waiting for the GIL or a CPU: the
summed (wall - CPU time) of the `Host entropy stage`, `Fused program
inputs` and `Stacked program inputs` spans that closed in the window,
less the summed (wall - CPU time) of the `Native` spans under them, over
the megapixels completed there.

So the host stages' wall time is host_cpu + host_wait + the native
calls' time off the thread's CPU. That wall time, from the recorder, is
printed to standard error beside the same sum from the harness's log of
the spans (host_entropy_ms_per_mp + program_inputs_ms_per_mp), which it
should match within a few per cent."""

import sys

from portbench.recorder import HOST, host_split


def read(record):
    split = host_split(record)
    if split is None:
        return None
    mp = record["mp"]
    logged = sum(end - start for name, start, end in record["spans"]
                 if name in HOST) * 1e3 / mp
    print(f"[portbench] host stages: wall {split['host_wall'] / 1e6 / mp:.4f} "
          f"ms/MP recorded, {logged:.4f} logged", file=sys.stderr)
    off = (split["host_wall"] - split["host_cpu"]
           - (split["native_wall"] - split["native_cpu"]))
    return off / 1e6 / mp
