"""The plain reference against the port on the CPU, at sizes a test run
holds: the recipe's stream decoded by the port against the reference's
decode of what the stream carries, within the configuration's limit,
with the EPF filtering; the reference's EPF pass against the port's plain
pass; and the reference's DCT8 matrices, worked out from the format's
distance bands, against the frozen encoders' tables."""

import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import vardct_dct8
from portbench.streams import natural_rgb_vardct

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "vardct_epf2_3mp"


def config():
    with open(os.path.join(PB, "configs", f"{NAME}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("size", [(256, 512), (200, 136)])
@pytest.mark.parametrize("seed", (3, 2**31 + 99))
def test_port_matches_the_reference(size, seed):
    from jxl_oxide_tpu_torch.serving import decode_batch_stacked

    conf = config()
    params = dict(conf["params"], height=size[0], width=size[1])
    streams = [natural_rgb_vardct.make(params, seed, s) for s in range(2)]
    outs = decode_batch_stacked(streams, output="device", device="cpu",
                                num_workers=1)
    for s, out in enumerate(outs):
        inputs = natural_rgb_vardct.reference_inputs(params, seed, s)
        ref = vardct_dct8.decode(inputs)
        assert out.shape == ref.shape == (size[0], size[1], 3)
        gap = float((out.double() - ref).abs().max())
        assert gap <= conf["limits"]["max_abs_gap"], gap
        # a wrong coefficient layout or a skipped stage is far off
        assert float(ref.abs().max()) > 0.1
        # the HF coefficients are not all zero, and the EPF filters
        assert sum(int((q[..., 1:, :] != 0).sum()) for q in inputs["q"]) > 0
        flat = vardct_dct8.decode(dict(inputs, sharpness=0 * inputs["sharpness"]))
        assert float((flat - ref).abs().max()) > 1e-3


@pytest.mark.parametrize("step,mul", [(0, 0.9), (1, 1.0), (2, 6.5)])
def test_epf_pass_matches_the_ports_plain_pass(step, mul):
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    rng = np.random.default_rng(step)
    amp = 10.0 ** rng.uniform(-4, -1, (1, 67, 1))
    planes = (0.5 + rng.random((3, 67, 90)) * amp).astype(np.float32)
    sigma = (rng.random((67, 90)) * 2.0).astype(np.float32)
    sigma[rng.random((67, 90)) < 0.1] = 0.0
    port = epf_step(torch.tensor(planes), torch.tensor(sigma), step,
                    (40.0, 5.0, 3.5), mul, 2.0 / 3.0).numpy()
    ref = vardct_dct8._epf_pass(torch.tensor(planes, dtype=torch.float64),
                                torch.tensor(sigma, dtype=torch.float64),
                                step, mul).numpy()
    assert np.abs(port - ref).max() < 1e-6
    assert np.abs(ref - planes).max() > 1e-3  # the pass filtered


@pytest.mark.parametrize("c", range(3))
def test_dct8_matrix_from_the_distance_bands(c):
    from portbench.streams._support import DequantMatrixSet, TransformType

    frozen = DequantMatrixSet.default().get(c, TransformType.DCT8,
                                            transposed=True)
    mine = vardct_dct8.dct8_matrix(c)
    # the frozen tables are float32
    assert np.abs(mine / frozen - 1).max() < 2e-7
    assert (mine == mine.T).all()
