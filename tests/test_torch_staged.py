"""The staged path of the port (render/vardct.py _run_staged and its
stages in ops/vardct_pipeline.py), taken when a frame's dense plan has
more than DENSE_PLAN_MAX_ENTRIES entries, and the render tail that
upsamples and filters its planes (render/render.py), against the JAX
package on the CPU.

Tolerances: the host builders bit for bit; gather and scatter exactly
(they move values); dequant and CfL within 1e-6 of their values' scale,
|x| up to about 40 and 100 here, so atol 4e-5 and 1e-4 (XLA on the CPU
may contract a multiply-add to FMA, and torch divides a scalar by a
tensor through a reciprocal); planes 2e-5 times the peak magnitude (at
least 1), as tests/test_torch_pipeline.py states; u8 within 1 LSB.
"""

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.ops import vardct_pipeline as tvp
from jxl_oxide_tpu_torch.render import vardct as tvmod


def _assert_close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    peak = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=2e-5 * peak, rtol=0)


@pytest.fixture
def cap(monkeypatch):
    """Sets DENSE_PLAN_MAX_ENTRIES in both packages, as the JAX package's
    own tests force the staged path."""
    from jxl_oxide_tpu.render import vardct as jvmod

    def set_cap(n):
        monkeypatch.setattr(jvmod, "DENSE_PLAN_MAX_ENTRIES", n)
        monkeypatch.setattr(tvmod, "DENSE_PLAN_MAX_ENTRIES", n)

    return set_cap


def test_gather_scatter_blocks_match_jax():
    """Indices inside the plane, from its end ([-n, 0)) and outside it:
    a gather outside reads 0, a scatter outside is dropped."""
    import jax.numpy as jnp

    from jxl_oxide_tpu.ops import vardct_pipeline as jvp

    rng = np.random.default_rng(0)
    plane = rng.random((6, 10)).astype(np.float32)
    idx = np.array([[[-61, -60, -1, 0], [7, 59, 60, 1000]]], np.int32)
    got = tvp.gather_blocks(torch.from_numpy(plane), torch.from_numpy(idx))
    want = jvp.gather_blocks(jnp.asarray(plane), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # unique in-range targets, so the order of writes does not matter
    idx = np.array([[[-61, -60, -2, 0], [7, 59, 60, 1000]]], np.int32)
    vals = rng.random(idx.shape).astype(np.float32)
    got = tvp.scatter_blocks(torch.zeros((6, 10)), torch.from_numpy(idx),
                             torch.from_numpy(vals))
    want = jvp.scatter_blocks(jnp.zeros((6, 10)), jnp.asarray(idx),
                              jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dequant_and_cfl_match_jax():
    from jxl_oxide_tpu.ops import vardct_pipeline as jvp

    rng = np.random.default_rng(1)
    raw = rng.integers(-40, 41, (24, 40)).astype(np.int32)
    dmap = rng.random((24, 40)).astype(np.float32)
    got = tvp.dequant_plane(torch.from_numpy(raw), torch.from_numpy(dmap),
                            0.38, 0.145)
    want = jvp.dequant_plane(raw, dmap, 0.38, 0.145)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4e-5,
                               rtol=1e-6)
    x, y, b, kx, kb = (rng.standard_normal((5, 24, 40)) * 10).astype(
        np.float32)
    got = tvp.cfl_plane(*(torch.from_numpy(a) for a in (x, y, b, kx, kb)))
    want = jvp.cfl_plane(x, y, b, kx, kb)
    got_lf = tvp.cfl_lf(*(torch.from_numpy(a) for a in (x, y, b)), -0.3, 1.1)
    want_lf = jvp.cfl_lf(x, y, b, np.float32(-0.3), np.float32(1.1))
    for g, w in zip(got + got_lf, tuple(want) + tuple(want_lf)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-6)


def test_transform_buckets_matches_jax():
    """One channel's bucketed inverse transforms on seeded coefficients,
    over the index plans of a mixed-type stream."""
    import jax.numpy as jnp

    from jxl_oxide_tpu.ops import vardct_pipeline as jvp

    state, _ = tp.torch_host(tp.overflow_stream())
    plan = state.build_transform_buckets(1)
    assert len(plan) >= 15
    rng = np.random.default_rng(2)
    coeff = rng.standard_normal(state.plane_shapes[1]).astype(np.float32)
    lf = rng.standard_normal(state.lf_shapes[1]).astype(np.float32)
    want = jvp.transform_buckets(jnp.asarray(coeff), jnp.asarray(lf),
                                 jnp.zeros(state.plane_shapes[1]), plan)
    tplan = [(sel, torch.from_numpy(ci), torch.from_numpy(li),
              torch.from_numpy(oi)) for sel, ci, li, oi in plan]
    got = tvp.transform_buckets(torch.from_numpy(coeff),
                                torch.from_numpy(lf),
                                torch.zeros(state.plane_shapes[1]), tplan)
    _assert_close(got, want)


@pytest.mark.parametrize("make", [
    lambda: tp.overflow_stream(cfl=True, skip_lf_smoothing=False),
    lambda: tp.ycbcr_stream(64, 64, tp.CHROMA["420"], seed=4),
], ids=["444_cfl_smooth", "420"])
def test_host_builders_bit_identical(make):
    """The staged path's host inputs: dequant maps, CfL maps, index plans
    and the sigma grid."""
    data = make()
    js, jh = tp.jax_host(data)
    ts, th = tp.torch_host(data)
    h = ts.header
    for a, b in zip(js.build_dequant_maps(jh, h.x_qm_scale, h.b_qm_scale),
                    ts.build_dequant_maps(th, h.x_qm_scale, h.b_qm_scale)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(js.build_cfl_maps(), ts.build_cfl_maps()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for c in range(3):
        jb, tb = js.build_transform_buckets(c), ts.build_transform_buckets(c)
        assert [e[0] for e in jb] == [e[0] for e in tb]
        for je, te in zip(jb, tb):
            for a, b in zip(je[1:], te[1:]):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(js._sigma_blocks_grid(), ts._sigma_blocks_grid())


@pytest.mark.parametrize("make", [
    lambda: tp.overflow_stream(cfl=True, skip_lf_smoothing=False),
    lambda: tp.ycbcr_stream(128, 128, tp.CHROMA["420"], seed=6),
], ids=["444_cfl_smooth", "420_cap_forced"])
def test_run_staged_planes_match_jax(make, cap):
    """The staged planes of both packages, with the cap lowered so that
    the plan overflows on both sides (about 40 entries at 256x262; one
    per channel for the all-DCT8 4:2:0 stream)."""
    cap(0)
    data = make()
    js, jh = tp.jax_host(data)
    ts, th = tp.torch_host(data)
    if js.subsampled:
        assert js.fused_subsampled_program_parts(jh) is None
        assert ts.fused_subsampled_program_parts(th) is None
    else:
        assert js.fused_program_parts(jh) is None
        assert ts.fused_program_parts(th) is None
    want = js._run_staged(jh)
    got = ts._run_staged(th, "cpu")
    assert len(got) == 3
    for g, w in zip(got, want):
        _assert_close(g, w)
    assert not ts.filters_applied and not ts._planes_poolable


def test_staged_fixture_overflows_the_real_cap():
    """The committed staged_1030 fixture needs the staged path at the
    cap of 96 entries, in both packages."""
    data, _ = tp.fixture("staged_1030")
    js, jh = tp.jax_host(data)
    ts, th = tp.torch_host(data)
    entries = ts.dense_plan(ts.buckets(0), ts.lf_shapes[0])[0]
    assert len(entries) > tvmod.DENSE_PLAN_MAX_ENTRIES == 96
    assert js.fused_program_parts(jh) is None
    assert ts.fused_program_parts(th) is None


def test_epf_sigma_matches_jax():
    """The render tail's per-pixel sigma (the JAX package's
    _assemble_epf_sigma), at a sample size that is not a whole number of
    blocks."""
    from types import SimpleNamespace

    from jxl_oxide_tpu.render.render import _assemble_epf_sigma
    from jxl_oxide_tpu_torch.ops.filters import sigma_map_from_blocks

    data = tp.overflow_stream(epf_iters=2)
    js, _ = tp.jax_host(data)
    ts, _ = tp.torch_host(data)
    frame = SimpleNamespace(header=js.header, _vardct_state=js)
    want = _assemble_epf_sigma(frame, 256, 262)
    got = sigma_map_from_blocks(ts._sigma_blocks_grid(), 256, 262)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(np.unique(got)) > 2


def _planes(data, device="cpu"):
    r = JxlImage.from_bytes(data, device=device).render_frame(0)
    return torch.stack(r.planes).numpy(), r.to_u8()


@pytest.mark.parametrize("make", [
    # the JAX package's staggered-DCT16 stream
    # (tests/test_vardct_roundtrip.py:934-979): the u8 must be identical
    lambda: _staggered_dct16(),
    lambda: tp.ycbcr_stream(64, 64, tp.CHROMA["420"], seed=61, gabor=True,
                            epf_iters=2),
    lambda: tp.ycbcr_stream(64, 64, tp.CHROMA["422"], seed=62, gabor=True,
                            epf_iters=3),
    lambda: tp.ycbcr_stream(64, 64, tp.CHROMA["440"], seed=62, gabor=True,
                            epf_iters=3),
], ids=["444_staggered", "420", "422", "440"])
def test_fused_equals_staged(make, monkeypatch):
    """The port's fused programs against its own staged path and render
    tail on the same stream (tests/test_vardct_roundtrip.py:934-979 and
    :1070-1154): planes within 2e-5, u8 identical."""
    data = make()
    fused, fused_u8 = _planes(data)
    monkeypatch.setattr(tvmod, "DENSE_PLAN_MAX_ENTRIES", 0)
    staged, staged_u8 = _planes(data)
    assert fused.shape == staged.shape
    np.testing.assert_allclose(fused, staged, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(fused_u8, staged_u8)


def _staggered_dct16():
    """tests/test_vardct_roundtrip.py:934-970's stream: DCT16s at all four
    block-offset residues, one DCT16X8, DCT8 filler."""
    from encoder_vardct import encode_jxl_vardct_mixed

    from jxl_oxide_tpu_torch.models.vardct import TransformType as T

    h = w = 128
    bh = bw = 16
    rng = np.random.default_rng(17)
    sel = np.full((bh, bw), -1, dtype=np.int64)
    covered = np.zeros((bh, bw), dtype=bool)
    for y, x in ((1, 1), (1, 4), (4, 1), (4, 4)):
        sel[y, x] = T.DCT16
        covered[y:y + 2, x:x + 2] = True
    sel[8, 8] = T.DCT16X8
    covered[8:10, 8] = True
    sel[~covered & (sel < 0)] = T.DCT8
    mul = np.ones((bh, bw), dtype=np.int64)
    coeff = rng.integers(-6, 7, (3, h, w)).astype(np.int64)
    coeff[np.abs(coeff) < 5] = 0
    lf_q = rng.integers(-30, 31, (3, bh, bw)).astype(np.int64)
    return encode_jxl_vardct_mixed(h, w, sel, mul, coeff, lf_q)


@pytest.mark.parametrize("make", [
    lambda: tp.overflow_stream(gabor=True, epf_iters=2),
    lambda: tp.overflow_stream(epf_iters=3, cfl=True,
                               skip_lf_smoothing=False),
], ids=["gabor_epf2", "epf3_cfl_smooth"])
def test_staged_u8_within_one_lsb_of_jax(make, cap):
    """End to end through the staged path and the render tail (gaborish
    and the EPF at the 256x262 sample size), the cap lowered in both
    packages."""
    cap(8)
    data = make()
    assert tp.torch_parts(data) is None
    assert tp.max_lsb(tp.torch_u8(data), tp.jax_u8(data)) <= 1


def test_lf_override_raises():
    """The staged path under an LF override. Before the port's LF slice it
    raised rather than decode without the override; now it takes the
    override (pre-dequantized LF planes: identity scale, no LF CfL, no
    smoothing) as the JAX package's staged path does, on the same planes,
    and not the frame's own LF."""
    rng = np.random.default_rng(5)
    data = tp.overflow_stream()
    state, hf_global = tp.torch_host(data)
    jstate, jhf = tp.jax_host(data)
    own = [p.clone() for p in state._run_staged(hf_global, "cpu")]
    override = [(rng.random(s) * 0.2).astype(np.float32)
                for s in state.lf_shapes]
    state.lf_override = [torch.from_numpy(p) for p in override]
    jstate.lf_override = override
    got = state._run_staged(hf_global, "cpu")
    want = jstate._run_staged(jhf)
    for g, w, o in zip(got, want, own):
        _assert_close(g, w)
        assert not torch.equal(g, o)
