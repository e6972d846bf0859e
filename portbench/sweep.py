#!/usr/bin/env python3
"""One run of a cell with some of its traffic's counts changed, for choosing
them on the card (clients, host workers, native threads, CPUs, seconds of
untimed traffic):

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> \\
        --set num_threads=2 --set num_workers=4

It prints run.py's result line with the traffic it ran. Benchmark runs
never use it; a new process for each setting, as run.py."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import run  # noqa: E402


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--set", action="append", default=[],
                    help="traffic key=integer")
    args = ap.parse_args()
    cell, config, traffic, bench = run.load_cell(args.workload)
    for item in args.set:
        key, _, value = item.partition("=")
        if key not in traffic:
            raise SystemExit(f"traffic has no {key!r}")
        traffic[key] = int(value)
    run.pin_environment()
    result = run.run_cell(cell, config, traffic, bench, args.seed,
                          args.seconds, bool(args.trace))
    result["traffic"] = traffic
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
