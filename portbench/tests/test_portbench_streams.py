"""The frozen encoders write the port's encoders' bytes: the recipe's image
at the configuration's own size, two seeds, through the frozen
`encode_jxl_vardct` and the port's (the sharpness map, which the port's
copy does not take, left at its default zeros). That the map is written
right, the port's decode against the reference shows
(test_portbench_reference.py)."""

import json
import os

import numpy as np
import pytest

from portbench.streams import encoder_vardct, natural_rgb_vardct, pool

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
SEEDS = (0, 2**31 + 12345)


def _params(name="vardct_epf2_3mp"):
    with open(os.path.join(CONFIGS, f"{name}.json")) as f:
        return json.load(f)["params"]


@pytest.mark.parametrize("seed", SEEDS)
def test_natural_rgb_bytes_are_the_ports(seed):
    from jxl_oxide_tpu_torch.encoders import encoder_vardct as port

    params = _params()
    img, sharp = natural_rgb_vardct._draw(params, seed, 3)
    kw = dict(gabor=params["gabor"], epf_iters=params["epf_iters"])
    frozen = encoder_vardct.encode_jxl_vardct(img, **kw)
    assert frozen == port.encode_jxl_vardct(img, **kw)
    assert encoder_vardct.encode_jxl_vardct(
        img, sharpness=np.zeros_like(sharp), **kw) == frozen
    assert natural_rgb_vardct.make(params, seed, 3) != frozen


def test_slots_and_seeds_give_distinct_streams():
    params = dict(_params(), height=64, width=64)
    a = natural_rgb_vardct.make(params, 7, 0)
    assert a == natural_rgb_vardct.make(params, 7, 0)
    assert a != natural_rgb_vardct.make(params, 7, 1)
    assert a != natural_rgb_vardct.make(params, 8, 0)


def test_pool_caches_under_a_fixed_key(tmp_path, monkeypatch):
    monkeypatch.setattr(pool, "CACHE", str(tmp_path))
    config = {"name": "tiny", "recipe": "natural_rgb_vardct",
              "params": dict(_params(), height=64, width=64)}
    first, refs = pool.make_pool(config, 2**31 + 1, 3, 2, [1])
    key = pool.recipe_key(config)
    d = tmp_path / "tiny" / key / str(2**31 + 1)
    assert sorted(p.name for p in d.iterdir()) == ["00.jxl", "01.jxl",
                                                   "01.ref.npz", "02.jxl"]
    again, refs_again = pool.make_pool(config, 2**31 + 1, 3, 2, [1])
    assert again == first
    want = natural_rgb_vardct.reference_inputs(config["params"], 2**31 + 1, 1)
    for got in (refs[1], refs_again[1]):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert (got[k] == v).all()
            elif isinstance(v, list) and hasattr(v[0], "shape"):
                assert all((a == b).all() for a, b in zip(got[k], v))
            else:
                assert got[k] == (list(v) if isinstance(v, tuple) else v)
    assert first[1] == natural_rgb_vardct.make(config["params"], 2**31 + 1, 1)
    changed = dict(config, params=dict(config["params"], epf_iters=1))
    assert pool.recipe_key(changed) != key
