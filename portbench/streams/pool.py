"""A seed's pool of streams: one stream per slot, made by the configuration's
recipe module in worker processes and cached inside the checkout, with
the reference's inputs of the slots a run checks (what those streams
carry, as the recipe gives it).

The cache directory is `portbench/.stream_cache/<config>/<key>/<seed>/`,
fixed for a (configuration, recipe, seed), holding `<slot>.jxl` and
`<slot>.ref.npz`: `key` hashes the recipe's
parameters and the sources of the recipe module, the frozen encoders and
`_support.py`, so a changed recipe never reads an old stream. A slot's
file is written to a temporary name and renamed, so a run that is cut off
leaves no half-written stream behind."""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import importlib
import json
import multiprocessing
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), ".stream_cache")
_FROZEN = ("encoder.py", "encoder_vardct.py", "_support.py", "pool.py")


def recipe(name: str):
    """The recipe module `portbench/streams/<name>.py`."""
    return importlib.import_module(f"portbench.streams.{name}")


def recipe_key(config: dict) -> str:
    h = hashlib.sha256()
    h.update(json.dumps([config["recipe"], config["params"]],
                        sort_keys=True).encode())
    for f in (f"{config['recipe']}.py", *_FROZEN):
        with open(os.path.join(HERE, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _shrink(a: np.ndarray) -> np.ndarray:
    """Integer arrays in the narrowest of int8/int16/int32 that holds them
    (the reference reads them as float64)."""
    if a.dtype.kind != "i" or not a.size:
        return a
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= a.min() and a.max() <= info.max:
            return a.astype(dt)
    return a


def save_inputs(path: str, inputs: dict) -> None:
    """A reference-input dict as one .npz: arrays and lists of arrays
    under their key (`key.i` for a list's i-th), the rest as JSON."""
    arrays, meta = {}, {}
    for k, v in inputs.items():
        if isinstance(v, np.ndarray):
            arrays[k] = _shrink(v)
            meta[k] = {"array": True}
        elif (isinstance(v, (list, tuple)) and v
              and all(isinstance(a, np.ndarray) for a in v)):
            for i, a in enumerate(v):
                arrays[f"{k}.{i}"] = _shrink(a)
            meta[k] = {"arrays": len(v)}
        else:
            meta[k] = {"value": v}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, __meta__=np.array(json.dumps(meta)), **arrays)
    os.replace(tmp, path)


def load_inputs(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        out = {}
        for k, m in meta.items():
            if "array" in m:
                out[k] = z[k]
            elif "arrays" in m:
                out[k] = [z[f"{k}.{i}"] for i in range(m["arrays"])]
            else:
                out[k] = m["value"]
    return out


def _make(recipe_name: str, params: dict, seed: int, slot: int,
          path: str) -> None:
    data = recipe(recipe_name).make(params, seed, slot)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def _make_inputs(recipe_name: str, params: dict, seed: int, slot: int,
                 path: str) -> None:
    save_inputs(path, recipe(recipe_name).reference_inputs(params, seed,
                                                             slot))


def make_pool(config: dict, seed: int, slots: int, workers: int,
              checked=()) -> tuple:
    """The `slots` streams of `seed` and the reference inputs of the
    `checked` slots, from the cache where they are there, else made by
    `workers` spawned processes (numpy only; no torch)."""
    d = os.path.join(CACHE, config["name"], recipe_key(config), str(seed))
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, f"{slot:02d}.jxl") for slot in range(slots)]
    refs = {s: os.path.join(d, f"{s:02d}.ref.npz") for s in checked}
    jobs = [(_make, s, p) for s, p in enumerate(paths)
            if not os.path.exists(p)]
    jobs += [(_make_inputs, s, p) for s, p in refs.items()
             if not os.path.exists(p)]
    if jobs:
        ctx = multiprocessing.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=max(1, min(workers, len(jobs))),
                                    mp_context=ctx) as ex:
            # the encodes, the slowest jobs, first
            jobs.sort(key=lambda j: j[0] is _make_inputs)
            futs = [ex.submit(fn, config["recipe"], config["params"], seed,
                              s, p) for fn, s, p in jobs]
            for f in futs:
                f.result()
    streams = []
    for p in paths:
        with open(p, "rb") as f:
            streams.append(f.read())
    return streams, {s: load_inputs(p) for s, p in refs.items()}
