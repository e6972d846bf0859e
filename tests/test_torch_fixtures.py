"""The committed fixtures of the port (jxl_oxide_tpu_torch/testdata, written
by tools/make_torch_port_fixtures.py): each reference .npz is exactly
jxl_oxide_tpu's decode of its committed stream, so the chip smoke test,
which has no JAX, holds the port against the reference decoder."""

import numpy as np
import pytest

import torch_parity as tp
from jxl_oxide_tpu_torch.render.render import host_stage


@pytest.mark.parametrize("name", tp.FIXTURES)
def test_reference_is_the_jax_decode(name):
    data, ref = tp.fixture(name)
    assert ref.dtype == np.uint8 and ref.ndim == 3 and ref.shape[2] == 3
    np.testing.assert_array_equal(tp.jax_u8(data), ref)


def test_fixtures_cover_the_main_path():
    """flagship: gaborish + 2 EPF passes at 1024^2; epf3: EPF step 0;
    mixed: the 8x8 specials and rectangular DCTs."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.models.vardct import TransformType as T

    info = {}
    for name in tp.FIXTURES:
        img = JxlImage.from_bytes(tp.fixture(name)[0], device="cpu")
        rf = img._frames[0].header.restoration_filter
        host = host_stage(img._frames[0])
        sels = {b.sel for b in host.state.buckets(0)}
        info[name] = (img.width, rf.gab.enabled, rf.epf.iters, sels)
    assert info["flagship_1024"][:3] == (1024, True, 2)
    assert info["epf3_512"][2] == 3
    specials = {T.DCT2, T.DCT4, T.HORNUSS, T.DCT4X8, T.DCT8X4,
                T.AFV0, T.AFV1, T.AFV2, T.AFV3}
    assert specials <= info["mixed_512"][3]
    assert len(info["mixed_512"][3]) >= 12


@pytest.mark.parametrize("name,ups,size,path", [
    ("ycbcr420_1024", (0, 1, 0), (1024, 1024), "subsampled"),
    ("ycbcr422_256", (0, 2, 0), (256, 256), "subsampled"),
    ("staged_1030", (0, 0, 0), (1024, 1030), "staged"),
])
def test_fixtures_take_their_paths(name, ups, size, path):
    """ycbcr420_1024 is bench.py's vardct_420 and ycbcr422_256 a 4:2:2
    stream, both through the fused subsampled program; staged_1030's plan
    overflows, so it takes the staged path, whose EPF runs at W = 1030.
    All three carry gaborish and 2 EPF passes."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.render.vardct import decode_vardct_planes

    img = JxlImage.from_bytes(tp.fixture(name)[0], device="cpu")
    header = img._frames[0].header
    assert tuple(header.jpeg_upsampling) == ups
    assert header.do_ycbcr == (path == "subsampled")
    assert (img.height, img.width) == size
    rf = header.restoration_filter
    assert rf.gab.enabled and rf.epf.iters == 2
    host = host_stage(img._frames[0])
    decode_vardct_planes(host.state, host.hf_global, "cpu")
    assert host.state.filters_applied == (path == "subsampled")
    assert host.state.chroma_upsampled == (path == "subsampled")
