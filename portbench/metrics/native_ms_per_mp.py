"""native_ms_per_mp (ms/MP): the wall time of the port's `Native` spans
(one a ctypes call into the C++ host library, which releases the GIL)
under the `Host entropy stage`, `Fused program inputs` and `Stacked
program inputs` spans, those that closed in the window, over the
megapixels completed there. Their CPU time goes to standard error: a
span's wall time less its CPU time is native worker threads' time and the
wait to take the GIL back."""

import sys

from portbench.recorder import host_split


def read(record):
    split = host_split(record)
    if split is None:
        return None
    mp = record["mp"]
    wall, cpu = split["native_wall"] / 1e6 / mp, split["native_cpu"] / 1e6 / mp
    print(f"[portbench] native_ms_per_mp: wall {wall:.4f}, thread CPU "
          f"{cpu:.4f} ms/MP", file=sys.stderr)
    return wall
