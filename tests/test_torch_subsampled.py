"""Chroma-subsampled YCbCr VarDCT in the port (4:2:0, 4:2:2, 4:4:0)
against the JAX package, on the CPU: the two triangle upsamples, the
BT.601 conversion, the host stage's program inputs, the fused subsampled
program and its per-channel part, and the decode end to end.

Tolerances:
  - _triangle_up2: bit for bit (adds, then an exact x0.25: nothing to
    contract to FMA on either side);
  - _upsample2x_triangle and ycbcr_to_rgb: atol 1e-6 (multiply-then-add,
    which XLA on the CPU may contract to FMA; one float32 ulp near 1);
  - the programs: 2e-5 times the plane's peak magnitude (at least 1), as
    tests/test_torch_pipeline.py states for the 4:4:4 program;
  - u8: within 1 LSB.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu_torch.ops import color as tcolor
from jxl_oxide_tpu_torch.ops import vardct_pipeline as tvp
from jxl_oxide_tpu_torch.ops.vardct_pipeline import upload_inputs
from jxl_oxide_tpu_torch.render import render as trender


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (16, 9), (33, 64)])
@pytest.mark.parametrize("axis", [0, 1])
def test_triangle_up2_bit_identical(shape, axis):
    from jxl_oxide_tpu.ops.vardct_pipeline import _triangle_up2

    rng = np.random.default_rng(shape[0] * 7 + axis)
    p = (rng.standard_normal(shape) * 40).astype(np.float32)
    want = np.asarray(_triangle_up2(p, axis))
    got = tvp._triangle_up2(torch.from_numpy(p), axis).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,axis,size", [((5, 7), 0, 10), ((5, 7), 0, 9),
                                             ((5, 7), 1, 13), ((32, 1), 1, 2),
                                             ((1, 4), 0, 1)])
def test_upsample2x_triangle_matches_jax(shape, axis, size):
    """The render tail's upsample, against both of the JAX package's
    forms: the numpy one (the staged path's planes reach it on the host)
    and the jitted one."""
    import jax.numpy as jnp

    from jxl_oxide_tpu.render.render import _upsample2x_triangle

    rng = np.random.default_rng(size)
    p = rng.random(shape).astype(np.float32)
    got = trender._upsample2x_triangle(torch.from_numpy(p), axis,
                                       size).numpy()
    for ref in (_upsample2x_triangle(p, axis, size),
                _upsample2x_triangle(jnp.asarray(p), axis, size)):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_ycbcr_to_rgb_matches_jax():
    import jax.numpy as jnp

    from jxl_oxide_tpu.ops.color import ycbcr_to_rgb

    rng = np.random.default_rng(0)
    cb, y, cr = (rng.random((3, 17, 23)) - 0.5).astype(np.float32)
    got = tcolor.ycbcr_to_rgb(*(torch.from_numpy(a) for a in (cb, y, cr)))
    for ref in (ycbcr_to_rgb(cb, y, cr),
                ycbcr_to_rgb(*(jnp.asarray(a) for a in (cb, y, cr)))):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                       rtol=0)


def _sub_parts(data):
    js, jh = tp.jax_host(data)
    ts, th = tp.torch_host(data)
    return (js.fused_subsampled_program_parts(jh),
            ts.fused_subsampled_program_parts(th))


def _assert_inputs_identical(jin, tin):
    assert len(jin) == len(tin) == 13
    for i, (j, t) in enumerate(zip(jin, tin)):
        assert isinstance(j, tuple) == isinstance(t, tuple), i
        for a, b in zip(j if isinstance(j, tuple) else (j,),
                        t if isinstance(t, tuple) else (t,)):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            assert np.array_equal(a, b), f"input {i} differs"


@pytest.mark.parametrize("upload", ["sparse", "dense"])
@pytest.mark.parametrize("size", [64, 256])
@pytest.mark.parametrize("chroma", sorted(tp.CHROMA))
def test_subsampled_inputs_bit_identical(chroma, size, upload, monkeypatch):
    """Both host stages hand the fused subsampled program the same key
    and the same 13 inputs, dtypes included."""
    monkeypatch.setenv("JXL_TPU_SPARSE_UPLOAD",
                       "0" if upload == "dense" else "1")
    data = tp.ycbcr_stream(size, size, tp.CHROMA[chroma], seed=size,
                           density=0.02, gabor=True, epf_iters=2)
    (jkey, _, jin), (tkey, _, tin) = _sub_parts(data)
    assert jkey == tkey
    _assert_inputs_identical(jin, tin)
    sparse = [isinstance(jin[4 * c], tuple) for c in range(3)]
    assert any(sparse) == (upload == "sparse")


@pytest.mark.parametrize("name", ["ycbcr420_1024", "ycbcr422_256"])
def test_fixture_subsampled_inputs_bit_identical(name):
    (jkey, _, jin), (tkey, _, tin) = _sub_parts(tp.fixture(name)[0])
    assert jkey == tkey
    _assert_inputs_identical(jin, tin)


@pytest.mark.parametrize("filters", ["gabor_epf2", "epf3"])
@pytest.mark.parametrize("chroma", sorted(tp.CHROMA))
def test_subsampled_program_matches_jax(chroma, filters):
    """The two make_fn()s, both fed the JAX host stage's inputs (sparse
    uploads at this density)."""
    kw = (dict(gabor=True, epf_iters=2) if filters == "gabor_epf2"
          else dict(epf_iters=3))
    data = tp.ycbcr_stream(128, 128, tp.CHROMA[chroma], seed=3, **kw)
    (_, jmake, jin), (_, tmake, _) = _sub_parts(data)
    ref = np.asarray(jmake()(*jin))
    got = tmake("cpu")(*upload_inputs(jin, "cpu")).numpy()
    assert got.shape == ref.shape == (3, 128, 128)
    assert np.isfinite(got).all()
    peak = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=2e-5 * peak, rtol=0)


@pytest.mark.parametrize("chroma,calls", [
    ("420", [((1, 32, 32), -1), ((1, 32, 64), -2)]),
    ("422", [((1, 64, 32), -1)]),
    ("440", [((1, 32, 64), -2)]),
])
def test_subsampled_program_upsamples_horizontal_first(chroma, calls,
                                                       monkeypatch):
    """Each chroma channel is upsampled horizontally (axis -1), then
    vertically (axis -2), as the JAX program does: the two orders round
    differently (by an ulp, under the programs' tolerance), so the order
    is checked by itself. The program runs one image as a stack of one."""
    seen = []
    up2 = tvp._triangle_up2

    def recording(p, axis):
        seen.append((tuple(p.shape), axis))
        return up2(p, axis)

    monkeypatch.setattr(tvp, "_triangle_up2", recording)
    data = tp.ycbcr_stream(64, 64, tp.CHROMA[chroma], seed=9)
    state, hf_global = tp.torch_host(data)
    _, make, inputs = state.fused_subsampled_program_parts(hf_global)
    out = make("cpu")(*upload_inputs(inputs, "cpu"))
    assert tuple(out.shape) == (3, 64, 64)
    assert seen == calls * 2


def test_1ch_pipeline_matches_jax():
    """build_fused_pipeline_1ch, the per-channel part, on the dense
    planes of a 4:2:0 stream's first chroma channel."""
    from jxl_oxide_tpu.ops.vardct_pipeline import (
        build_fused_pipeline_1ch as jax_1ch,
    )

    data = tp.ycbcr_stream(64, 64, tp.CHROMA["420"], seed=5, density=0.5)
    state, hf_global = tp.torch_host(data)
    plans, qm = state._subsampled_channel_plans(hf_global)
    entries, code, mul, mats = plans[0]
    coeff = state.coeff_planes[0]
    lf_q = state.lf_quant_planes[0]
    args = (state.plane_shapes[0], state.lf_shapes[0], entries, mats,
            0.25, 0.145, 4096, qm[0], 0.0625)
    ref = np.asarray(jax_1ch(*args)(coeff, lf_q, code, mul))
    fn = tvp.build_fused_pipeline_1ch(*args, device="cpu")
    got = fn(*(torch.from_numpy(a) for a in (coeff, lf_q, code, mul)))
    assert tuple(got.shape) == ref.shape == (32, 32)
    peak = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5 * peak, rtol=0)


@pytest.mark.parametrize("chroma", sorted(tp.CHROMA))
def test_subsampled_u8_within_one_lsb_of_jax(chroma):
    data = tp.ycbcr_stream(64, 64, tp.CHROMA[chroma], seed=1, gabor=True,
                           epf_iters=2)
    assert tp.max_lsb(tp.torch_u8(data), tp.jax_u8(data)) <= 1


def test_subsampled_takes_the_fused_program():
    """The decode of a 4:2:0 stream runs the fused subsampled program:
    it upsamples and filters in the program, and the render tail only
    crops."""
    from jxl_oxide_tpu_torch.render.vardct import decode_vardct_planes

    data = tp.ycbcr_stream(64, 64, tp.CHROMA["420"], seed=2, gabor=True,
                           epf_iters=1)
    host = tp.torch_host_stage(data)
    planes = decode_vardct_planes(host.state, host.hf_global, "cpu")
    assert host.state.chroma_upsampled and host.state.filters_applied
    assert [tuple(p.shape) for p in planes] == [(64, 64)] * 3
