"""The port's fused VarDCT program (jxl_oxide_tpu_torch/ops/
vardct_pipeline.py::build_fused_pipeline, built by the port's
fused_program_parts) against the JAX package's make_fn(), both fed the
JAX host stage's inputs, on the CPU.

Tolerance: 2e-5 times the plane's peak magnitude (at least 1). Both
programs are float32 with the same operation order, but the separable
transforms are einsums that XLA and torch sum in different orders, so the
error grows with the magnitude of the pixels (the random-coefficient
streams below reach |x| ~ 100; natural images stay within [0, 1]). The
bound is the EPF's 2e-5 (tests/test_color.py) at unit scale.
"""

import numpy as np
import pytest

import torch_parity as tp
from jxl_oxide_tpu_torch.ops.vardct_pipeline import upload_inputs
from torch_parity import STREAMS


def _compare(data, rect=None):
    _, jmake, jin = tp.jax_parts(data, rect=rect)
    _, tmake, _ = tp.torch_parts(data, rect=rect)
    ref = np.asarray(jmake()(*jin))
    got = tmake("cpu")(*upload_inputs(jin, "cpu")).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    peak = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=2e-5 * peak, rtol=0)
    return jin


@pytest.mark.parametrize("upload", ["sparse", "dense"])
@pytest.mark.parametrize("name", ["dct8", "xyb_gabor_epf2",
                                  "tiled_cfl_smooth_epf3"])
def test_fused_pipeline_matches_jax(name, upload, monkeypatch):
    """dct8: no xyb, no filters, constant CfL. xyb_gabor_epf2: xyb,
    gaborish, EPF steps 1 and 2. tiled_cfl_smooth_epf3: the 8x8 specials
    and rectangular DCTs, per-tile CfL maps, adaptive LF smoothing, EPF
    steps 0-2, two groups."""
    monkeypatch.setenv("JXL_TPU_SPARSE_UPLOAD",
                       "0" if upload == "dense" else "1")
    jin = _compare(STREAMS[name]())
    assert isinstance(jin[0], tuple) == (upload == "sparse")


def test_fused_pipeline_roi_embed_matches_jax():
    """The embed leg: a rect of the frame computed alone and placed into a
    zero canvas, then cropped."""
    _compare(STREAMS["tiled_cfl_smooth_epf3"](), rect=(256, 0, 320, 128))


def test_fused_pipeline_constant_cfl_matches_jax():
    """Streams with all-zero CfL grids fold the factor maps to scalars."""
    data = tp.tiled_stream(128, 320, 4, types=[0, 4, 6, 7, 12, 13])
    key, _, _ = tp.torch_parts(data)
    assert key[1] is True   # cfl_const
    _compare(data)


def test_upload_passes_device_tensors_through():
    """A program input that is a tensor already (an LF frame's planes)
    stays where it is, beside the packed host arrays; one on another
    device raises."""
    import numpy as np
    import pytest
    import torch

    from jxl_oxide_tpu_torch.ops.vardct_pipeline import upload_inputs

    lf = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
    host = np.arange(4, dtype=np.int16)
    pair = (np.arange(3, dtype=np.int32), np.ones(3, dtype=np.int8))
    out = upload_inputs([host, lf, pair], "cpu")
    assert out[1] is lf
    np.testing.assert_array_equal(out[0].numpy(), host)
    np.testing.assert_array_equal(out[2][0].numpy(), pair[0])
    with pytest.raises(ValueError):
        upload_inputs([host, lf.to("meta")], "cpu")
