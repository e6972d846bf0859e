"""A whole run of a cell by run.py's `run_cell` at a size a test run holds,
with the chip look skipped, for the fault and control tests."""

import importlib.util
import json
import os

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
SEED = 2**31 + 5


def harness():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(PB, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small(name: str, size: dict) -> tuple:
    """(cell, config, traffic, bench) of the cell of configuration `name`,
    its images cut to `size` and its batch, pool and stack to 4."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["config"] == name)
    with open(os.path.join(PB, "configs", f"{name}.json")) as f:
        config = json.load(f)
    with open(os.path.join(PB, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    config["params"].update(size)
    config["geometry"].update(size)
    config["name"] += "_test"
    traffic.update(batch=4, pool=4, max_stack=4, check_slots=4,
                   warmup_seconds=0.2, num_workers=2, num_threads=2)
    return cell, config, traffic, bench


def run(name: str, size: dict, decode=None, device: str = "cpu",
        seconds: float = 0.6) -> tuple:
    """run_cell's result and the configuration's limit."""
    cell, config, traffic, bench = small(name, size)
    result = harness().run_cell(cell, config, traffic, bench, SEED, seconds,
                                False, device=device, decode=decode,
                                streams_workers=2)
    return result, config["limits"]["max_abs_gap"]


def control_decode(name: str, size: dict):
    """The control in the program's place: for each stream of the small
    pool, the plain reference of what it carries, in float32 with TF32
    operands."""
    import importlib

    import torch

    from portbench.streams.pool import recipe

    _, config, traffic, _ = small(name, size)
    rec = recipe(config["recipe"])
    ref = importlib.import_module(
        f"portbench.reference.{config['reference']}")
    by_stream = {rec.make(config["params"], SEED, s):
                 rec.reference_inputs(config["params"], SEED, s)
                 for s in range(traffic["pool"])}

    def decode(streams, device="cpu", **_):
        return [ref.decode(by_stream[s], torch.float32, device, tf32=True)
                for s in streams]

    return decode
