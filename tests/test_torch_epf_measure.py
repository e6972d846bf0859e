"""The EPF measurement helpers (jxl_oxide_tpu_torch/ops/cuda/
epf_measure.py) that chip_smoke.py and tools/epf_variants.py time the
kernel with: their inputs, the bound, the cold input sets and the capture
of a decode's passes. The timing itself needs the card."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu_torch.ops.cuda import epf_measure as em


@pytest.mark.parametrize("shape,seed", [((3, 150, 40), 0), ((3, 2, 5), 3)])
def test_epf_inputs_are_the_tests_inputs(shape, seed):
    p, s = em.epf_inputs(shape, seed)
    q, t = tp.epf_inputs(shape, seed)
    np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(s, t)


def test_bound_counts_bytes_and_active_operations():
    sigma = torch.zeros((1024, 1024))
    # 28 B/px at 3.35 TB/s, whatever the step
    byte_ms = 28 * 1024 * 1024 / 3.35e12 * 1e3
    for step in range(3):
        assert em.bound_ms(sigma, step) == (pytest.approx(byte_ms), "bytes")
    # every pixel filtered: step 0's 737 operations per pixel at 67 TFLOP/s
    # exceed the bytes; steps 1 and 2 stay bound by bytes
    sigma.fill_(1.0)
    assert em.ops_per_pixel(0) == 737
    ms, by = em.bound_ms(sigma, 0)
    assert by == "operations"
    assert ms == pytest.approx(737 * 1024 * 1024 / 67e12 * 1e3)
    assert em.bound_ms(sigma, 1)[1] == "bytes"
    assert em.bound_ms(sigma, 2)[1] == "bytes"


@pytest.mark.parametrize("hw,copies", [((1024, 1024), 5), ((2048, 2048), 2),
                                       ((1000, 1030), 5)])
def test_cold_sets_move_twice_the_l2_between_uses(hw, copies):
    planes = torch.zeros((3, *hw))
    sigma = torch.zeros(hw)
    assert len(em.input_sets(planes, sigma, cold=False)) == 1
    sets = em.input_sets(planes, sigma, cold=True)
    assert len(sets) == copies
    assert (copies - 1) * 28 * hw[0] * hw[1] >= 2 * 50e6
    assert sets[0][0] is planes
    ptrs = {t.data_ptr() for s in sets for t in s}
    assert len(ptrs) == 3 * copies


@pytest.mark.parametrize("make,staged", [
    (lambda: tp.vardct_stream(64, 72, 2, gabor=True, epf_iters=2), False),
    (lambda: tp.ycbcr_stream(64, 64, tp.CHROMA["420"], seed=1, epf_iters=3),
     False),
    (lambda: tp.overflow_stream(epf_iters=2), True),
], ids=["fused_444", "fused_420", "staged"])
def test_capture_sees_every_pass_of_every_path(make, staged, monkeypatch):
    """capture_decode keeps the inputs of each EPF pass whichever program
    runs it (the staged path's passes run in the render tail), in order,
    and decodes as an uncaptured decode does. The fused programs run one
    image as a stack of one: their passes take [1, 3, H, W]."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.render import vardct as tvmod

    if staged:
        monkeypatch.setattr(tvmod, "DENSE_PLAN_MAX_ENTRIES", 0)
    data = make()
    u8, captured = em.capture_decode(data, device="cpu")
    np.testing.assert_array_equal(u8, tp.torch_u8(data))
    img = JxlImage.from_bytes(data, device="cpu")
    iters = img._frames[0].header.restoration_filter.epf.iters
    assert [c[2] for c in captured] == [0, 1, 2][3 - iters:]
    lead = () if staged else (1,)
    for planes, sigma, *_ in captured:
        assert tuple(planes.shape) == (*lead, 3, img.height, img.width)
        assert tuple(sigma.shape) == (*lead, img.height, img.width)
