"""Render.stream() in the port (api.py ImageStream) against the JAX
package's ImageStream.write_to_buffer, on the CPU.

Given the same float planes, the two write the same samples bit for bit:
u8 and u16 as round(x * 255) and round(x * 65535), half to even, clipped,
f32 as they are; row-major, x-major, c-minor, colour then alpha, oriented;
resumable across buffers of any size. A decoded stream's samples agree
where the decodes do (exactly for lossless Modular and alpha, within
1 LSB where a filter runs). Each call takes from the planes only the rows
its samples lie in.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu import api as jax_api
from jxl_oxide_tpu.headers.image import ExtraChannelType
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch import api as torch_api

DTYPES = [np.uint8, np.uint16, np.float32]


def drain(stream, dtype, size: int) -> np.ndarray:
    """Every sample of `stream`, written through a buffer of `size`."""
    buf = np.zeros(size, dtype=dtype)
    out = []
    while True:
        n = stream.write_to_buffer(buf)
        if n == 0:
            return np.concatenate(out) if out else buf[:0]
        assert 0 < n <= size
        out.append(buf[:n].copy())


def planes_with_edges(h: int, w: int, channels: int, seed: int) -> list:
    """Float32 planes that hold the quantizers' hard cases: exact halves
    of a u8 and a u16 step (round half to even), values below 0 and
    above 1, and plain noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(channels):
        p = rng.uniform(-0.1, 1.1, (h, w)).astype(np.float32)
        flat = p.reshape(-1)
        k = rng.integers(0, 255, flat.size // 4)
        flat[: k.size] = ((k + 0.5) / 255.0).astype(np.float32)
        k16 = rng.integers(0, 65535, flat.size // 4)
        flat[k.size: k.size + k16.size] = (
            (k16 + 0.5) / 65535.0).astype(np.float32)
        out.append(p)
    return out


def both_renders(planes, extra, orientation):
    """The JAX package's Render and the port's over the same planes."""
    # both streams take the extra channels that have an info: alphas
    info = [SimpleNamespace(ty=ExtraChannelType.ALPHA, spot_colour=None)
            for _ in extra]
    jr = jax_api.Render(planes=[p.copy() for p in planes],
                        extra=[e.copy() for e in extra], ec_info=info,
                        orientation=orientation, name="", duration=0)
    tr = torch_api.Render(planes=[torch.from_numpy(p.copy()) for p in planes],
                          extra=[torch.from_numpy(e.copy()) for e in extra],
                          ec_info=info, orientation=orientation, name="",
                          duration=0)
    return jr, tr


@pytest.mark.parametrize("orientation", range(1, 9))
def test_oriented_rows_are_rows_of_the_oriented_plane(orientation):
    plane = torch.arange(7 * 5, dtype=torch.float32).reshape(7, 5)
    full = torch_api._apply_orientation(plane, orientation)
    for r0, r1 in [(0, 1), (0, full.shape[0]), (2, 4), (full.shape[0] - 1,
                                                        full.shape[0])]:
        got = torch_api._oriented_rows(plane, orientation, r0, r1)
        assert torch.equal(got, full[r0:r1]), (r0, r1)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("size", [1, 7, 50, 301])
def test_same_planes_same_samples(orientation, dtype, size):
    """Colour and an alpha over the same floats: the port's stream is the
    JAX package's, sample for sample, through odd buffer sizes."""
    planes = planes_with_edges(13, 11, 4, seed=orientation)
    jr, tr = both_renders(planes[:3], planes[3:], orientation)
    js, ts = jr.stream(), tr.stream()
    assert (ts.width, ts.height, ts.channels) == (js.width, js.height, 4)
    got, want = drain(ts, dtype, size), drain(js, dtype, size)
    assert got.dtype == want.dtype and got.size == 13 * 11 * 4
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_stream_is_the_interleaved_image(dtype):
    """u8 and u16 streams are to_u8() / to_u16() flattened; the f32 one
    is image() flattened."""
    planes = planes_with_edges(9, 14, 3, seed=20)
    _, tr = both_renders(planes, [], 6)
    want = {np.uint8: tr.to_u8, np.uint16: tr.to_u16,
            np.float32: tr.image}[dtype]().reshape(-1)
    np.testing.assert_array_equal(drain(tr.stream(), dtype, 64), want)


def test_no_call_downloads_a_row_it_does_not_write(monkeypatch):
    """Each call's row bands cover only the rows its samples lie in, and
    the full interleaved image is never built."""
    planes = planes_with_edges(40, 30, 3, seed=21)
    _, tr = both_renders(planes, [], 5)
    stream = tr.stream()
    bands = []
    real = torch_api.ImageStream._row_band

    def see(self, r0, r1, scale):
        bands.append((r0, r1))
        return real(self, r0, r1, scale)

    monkeypatch.setattr(torch_api.ImageStream, "_row_band", see)
    row = stream.width * stream.channels
    pos = 0
    for size in [1, 89, 90, 91, 500, 1, 2000, 10_000]:
        bands.clear()
        n = stream.write_to_buffer(np.zeros(size, np.uint8))
        if n == 0:
            break
        first, last = pos // row, (pos + n - 1) // row
        assert bands and all(first <= r0 < r1 <= last + 1
                             for r0, r1 in bands), (size, bands)
        assert sum(r1 - r0 for r0, r1 in bands) == last - first + 1
        pos += n
    assert pos == stream.height * row


@pytest.mark.parametrize("name,exact", [("orient6_512x384", False),
                                        ("modular_alpha_512", True),
                                        ("grey_alpha_512", True)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decoded_fixture_streams(name, exact, dtype):
    """A decoded fixture's stream from both packages: exactly where the
    decodes agree exactly (lossless Modular, alpha); where a filter runs,
    within 1 LSB (u8), 2e-5 (f32) and the u16 steps a 2e-5 float gap can
    make, ceil(2e-5 * 65535) + 1 = 3 LSB (measured on the CPU for
    orient6_512x384: 0 u8, 1 u16, 1.79e-7 f32); the port's stream over
    the JAX package's planes bit for bit."""
    data, _ = tp.fixture(name)
    jr = tp.jax_image(data).render_frame(0)
    tr = JxlImage.from_bytes(data, device="cpu").render_frame(0)
    want = drain(jr.stream(), dtype, 4099)
    got = drain(tr.stream(), dtype, 4099)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        tol = {np.uint8: 1, np.uint16: 3, np.float32: 2e-5}[dtype]
        assert np.abs(got.astype(np.float64) - want).max() <= tol
    same = torch_api.Render(
        planes=[torch.from_numpy(np.asarray(p, np.float32).copy())
                for p in jr.planes],
        extra=[torch.from_numpy(np.asarray(e, np.float32).copy())
               for e in jr.extra],
        ec_info=list(tr.ec_info), orientation=jr.orientation, name="",
        duration=0)
    np.testing.assert_array_equal(drain(same.stream(), dtype, 4099), want)
