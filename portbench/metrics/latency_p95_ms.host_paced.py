"""latency_p95_ms.host_paced (ms): the 95th percentile of request time,
submission to completion, over every request counted in the window. In
the loader cells the host stage paces it; the sample count goes to
standard error."""

import statistics
import sys


def read(record):
    times = [(q["done"] - q["submit"]) * 1e3 for q in record["counted"]]
    print(f"[portbench] latency_p95_ms.host_paced over {len(times)} requests",
          file=sys.stderr)
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=100, method="inclusive")[94]
