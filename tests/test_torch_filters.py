"""Restoration filters of the port (jxl_oxide_tpu_torch/ops/filters.py and
the EPF kernel's wrapper) against the JAX package's, on the CPU.

EPF tolerance: atol 2e-5, the bound the JAX tests already allow between
two versions of the same pass (tests/test_color.py, Pallas vs jnp).
Gaborish is 9 multiply-adds in the same order: atol 1e-6.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu.ops import filters as jf
from jxl_oxide_tpu.ops.pallas.epf import epf_step_pallas
from jxl_oxide_tpu_torch.ops import filters as tf
from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

EPF_ATOL = 2e-5
CS = (40.0, 5.0, 3.5)
BSM = 2.0 / 3.0
STEPS = ((0, 0.9), (1, 1.0), (2, 6.5))
# 1-, 2- and 5-px sides: numpy's symmetric pad reflects more than once
# where a side is narrower than the 3-px halo
SHAPES = ((3, 150, 40), (3, 1, 1), (3, 1, 9), (3, 2, 5), (3, 5, 2),
          (3, 5, 5), (3, 17, 33))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("pad", [1, 3, 4])
def test_mirror_index_is_numpy_symmetric(n, pad):
    a = np.arange(n)
    want = np.pad(a, pad, mode="symmetric")
    got = tf.mirror_index(n, pad, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("step,mult", STEPS)
def test_epf_step_matches_jax(shape, step, mult):
    planes, sigma = tp.epf_inputs(shape)
    ref = np.asarray(jf.epf_step(planes, sigma, step, CS, mult, BSM))
    got = tf.epf_step(torch.from_numpy(planes), torch.from_numpy(sigma),
                      step, CS, mult, BSM).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=EPF_ATOL, rtol=0)
    if shape == SHAPES[0]:
        # the inputs exercise the filter: most filtered pixels move
        moved = np.abs(ref - planes).max(axis=0) > 1e-5
        assert moved[sigma >= 0.3].mean() > 0.3


@pytest.mark.parametrize("shape", [(3, 150, 40), (3, 5, 2)])
@pytest.mark.parametrize("step,mult", STEPS)
def test_epf_step_matches_pallas_interpret(shape, step, mult):
    planes, sigma = tp.epf_inputs(shape, seed=11)
    ref = np.asarray(epf_step_pallas(planes, sigma, step, CS, mult, BSM,
                                     interpret=True))
    got = tf.epf_step(torch.from_numpy(planes), torch.from_numpy(sigma),
                      step, CS, mult, BSM).numpy()
    np.testing.assert_allclose(got, ref, atol=EPF_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 1), (2, 5), (5, 2), (37, 21)])
def test_gabor_matches_jax(shape):
    rng = np.random.default_rng(3)
    plane = rng.random(shape).astype(np.float32)
    w = (0.115169525, 0.061248592)
    ref = np.asarray(jf.gabor(plane, w))
    got = tf.gabor(torch.from_numpy(plane), w).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_halo_forms_raise():
    """The halo (prepad) forms, which the sharded programs run on bands
    with real rows or columns from their neighbours attached, against the
    JAX package's: EPF prepad_rows=3 and prepad_cols=3, gaborish
    prepad_rows=1 and prepad_cols=1. (The name is this test's from before
    the forms were ported, when they raised.)"""
    planes, sigma = tp.epf_inputs((3, 22, 17))
    for step, mult in STEPS:
        want = np.asarray(jf.epf_step(planes, sigma[3:-3], step, CS, mult,
                                      BSM, prepad_rows=3))
        got = tf.epf_step(torch.from_numpy(planes),
                          torch.from_numpy(sigma[3:-3]), step, CS, mult, BSM,
                          prepad_rows=3).numpy()
        assert got.shape == (3, 16, 17)
        np.testing.assert_allclose(got, want, atol=EPF_ATOL, rtol=0)
        want = np.asarray(jf.epf_step(planes, sigma[:, 3:-3], step, CS,
                                      mult, BSM, prepad_cols=3))
        got = tf.epf_step(torch.from_numpy(planes),
                          torch.from_numpy(sigma[:, 3:-3]), step, CS, mult,
                          BSM, prepad_cols=3).numpy()
        assert got.shape == (3, 22, 11)
        np.testing.assert_allclose(got, want, atol=EPF_ATOL, rtol=0)
    w = (0.115169525, 0.061248592)
    for kw, shape in (({"prepad_rows": 1}, (20, 17)),
                      ({"prepad_cols": 1}, (22, 15))):
        want = np.asarray(jf.gabor(planes[0], w, **kw))
        got = tf.gabor(torch.from_numpy(planes[0]), w, **kw).numpy()
        assert got.shape == shape
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_wrapper_uses_plain_version_only_on_cpu():
    """CPU tensors take the plain epf_step (bit for bit, no launch
    counted); a tensor on any other non-CUDA device raises instead of
    falling back."""
    planes, sigma = tp.epf_inputs((3, 24, 16))
    p, s = torch.from_numpy(planes), torch.from_numpy(sigma)
    before = epf_step_cuda.launches
    got = epf_step_cuda(p, s, 1, CS, 1.0, BSM)
    want = tf.epf_step(p, s, 1, CS, 1.0, BSM)
    assert torch.equal(got, want)
    assert epf_step_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        epf_step_cuda(p.to("meta"), s.to("meta"), 1, CS, 1.0, BSM)


@pytest.mark.parametrize("shape", [(3, 150, 40), (3, 5, 2), (3, 17, 33)])
@pytest.mark.parametrize("step,mult", STEPS)
@pytest.mark.parametrize("n", [1, 3])
def test_batched_epf_step_equals_a_loop(shape, step, mult, n):
    """epf_step on a stack [N, 3, H, W] with sigma [N, H, W] is a loop of
    one-image passes, bit for bit (the wrapper takes the stack on the CPU
    too); gabor on [N, H, W] likewise."""
    ins = [tp.epf_inputs(shape, seed=20 + j) for j in range(n)]
    planes = torch.from_numpy(np.stack([p for p, _ in ins]))
    sigma = torch.from_numpy(np.stack([s for _, s in ins]))
    got = epf_step_cuda(planes, sigma, step, CS, mult, BSM)
    want = torch.stack([tf.epf_step(planes[j], sigma[j], step, CS, mult, BSM)
                        for j in range(n)])
    assert torch.equal(got, want)
    w = (0.115169525, 0.061248592)
    assert torch.equal(tf.gabor(planes[:, 0], w),
                       torch.stack([tf.gabor(planes[j, 0], w)
                                    for j in range(n)]))
