"""Metadata boxes, force_wide_buffers, clear_program_caches, the brotli
binding and the PNG writer of the port, against the JAX package on the
same inputs (CPU)."""

import io

import numpy as np
import pytest

import torch_parity as tp
from jxl_oxide_tpu import JxlImage as JaxImage
from jxl_oxide_tpu_torch import JxlImage, clear_program_caches
from jxl_oxide_tpu_torch.utils.errors import JxlError

ACCESSORS = ("raw_exif_data", "raw_xmp", "hdr_gain_map",
             "jpeg_reconstruction_available")
BOXES = (b"Exif", b"xml ", b"jhgm", b"jbrd", b"jxll")


def _box(ty: bytes, content: bytes) -> bytes:
    return (8 + len(content)).to_bytes(4, "big") + ty + content


def synthetic_container() -> bytes:
    """tests/test_container.py test_brob_box_and_metadata_accessors's
    container: an Exif box, a brob-wrapped XMP box, then the codestream."""
    from encoder import encode_jxl_modular
    from test_jbr import brotli_compress

    codestream = encode_jxl_modular(
        [np.zeros((8, 8), dtype=np.int64)], bit_depth=8, grayscale=True)
    return (b"\x00\x00\x00\x0cJXL \x0d\x0a\x87\x0a"
            + _box(b"Exif", (0).to_bytes(4, "big") + b"II*\x00EXIFBODY")
            + _box(b"brob", b"xml " + brotli_compress(b"<x:xmpmeta/>"))
            + _box(b"jxlc", codestream))


def _streams():
    return {"synthetic": synthetic_container(),
            "jbrd_container_256": tp.fixture("jbrd_container_256")[0]}


@pytest.mark.parametrize("name", ["synthetic", "jbrd_container_256"])
def test_aux_accessors_equal_the_jax_package(name):
    data = _streams()[name]
    img = JxlImage.from_bytes(data, device="cpu")
    ref = JaxImage.from_bytes(data)
    for attr in ACCESSORS:
        assert getattr(img, attr) == getattr(ref, attr), attr
    for ty in BOXES:
        assert img.aux_box(ty) == ref.aux_box(ty), ty
    assert img.raw_xmp is not None and img.raw_exif_data is not None


def test_aux_boxes_fed_in_pieces():
    """The boxes come out the same when the container arrives a few bytes
    at a time, split inside the boxes."""
    data = _streams()["jbrd_container_256"]
    whole = JxlImage.from_bytes(data, device="cpu")
    img = JxlImage(device="cpu")
    for i in range(0, len(data), 997):
        img.feed_bytes(data[i:i + 997])
    img.finish()
    for ty in BOXES:
        assert img.aux_box(ty) == whole.aux_box(ty), ty


def test_fixture_payloads_equal_the_committed_jax_payloads():
    data, _ = tp.fixture("jbrd_container_256")
    ref = np.load(f"{tp.TESTDATA}/jbrd_container_256.npz")
    img = JxlImage.from_bytes(data, device="cpu")
    assert img.aux_box(b"Exif") == ref["exif"].tobytes()
    assert img.raw_exif_data == ref["raw_exif"].tobytes()
    assert img.raw_xmp == ref["xmp"].tobytes()
    assert img.hdr_gain_map == ref["jhgm"].tobytes()


def test_bare_codestream_has_no_boxes():
    data = tp.vardct_stream(16, 16, 1)
    img = JxlImage.from_bytes(data, device="cpu")
    assert (img.raw_exif_data, img.raw_xmp, img.hdr_gain_map) == (
        None, None, None)
    assert not img.jpeg_reconstruction_available


def test_brob_without_libbrotlidec_raises_naming_it(monkeypatch):
    """Without the system library a brob box raises a JxlError that names
    it: no undecoded bytes come back."""
    import ctypes

    from jxl_oxide_tpu_torch.utils import brotli

    def missing(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    img = JxlImage.from_bytes(synthetic_container(), device="cpu")
    monkeypatch.setattr(brotli, "_lib", None)
    monkeypatch.setattr(ctypes, "CDLL", missing)
    assert not brotli.available()
    with pytest.raises(JxlError, match="libbrotlidec"):
        img.raw_xmp  # noqa: B018
    assert img.raw_exif_data == b"II*\x00EXIFBODY"


def _dtypes_seen(monkeypatch):
    from jxl_oxide_tpu_torch.render import frame as frame_mod

    seen = []
    real = frame_mod.ModularImage

    def spy(*a, **k):
        seen.append(np.dtype(k.get("dtype", np.int32)))
        return real(*a, **k)

    monkeypatch.setattr(frame_mod, "ModularImage", spy)
    return seen


def test_force_wide_buffers_same_output(monkeypatch):
    """A stream with modular_16bit_buffers decodes through the narrow
    (i16) lane by default and the wide (i32) one with force_wide_buffers,
    to the same samples, equal to the JAX package's with the option."""
    from encoder import encode_jxl_modular

    rng = np.random.default_rng(81)
    chans = [rng.integers(0, 256, (48, 40), dtype=np.int64)
             for _ in range(3)]
    data = encode_jxl_modular(chans, bit_depth=8, squeeze=True, rct=True)
    seen = _dtypes_seen(monkeypatch)
    narrow = JxlImage.from_bytes(data, device="cpu").render_frame(0).to_u8()
    lanes = set(seen)
    seen.clear()
    wide = JxlImage.from_bytes(data, device="cpu", force_wide_buffers=True
                               ).render_frame(0).to_u8()
    assert lanes == {np.dtype(np.int16)} and set(seen) == {
        np.dtype(np.int32)}
    ref = JaxImage.from_bytes(data, force_wide_buffers=True
                              ).render_frame(0).to_u8()
    assert np.array_equal(narrow, wide) and np.array_equal(wide, ref)
    assert np.array_equal(wide, np.stack(chans, -1).astype(np.uint8))


def test_clear_program_caches_then_decode_again():
    """A decode after clear_program_caches equals the one before it, and
    the caches it releases are empty after it."""
    from jxl_oxide_tpu_torch.ops import dct, varblock
    from jxl_oxide_tpu_torch.render import vardct

    data = tp.vardct_stream(64, 64, 5, gabor=True, epf_iters=2)
    before = JxlImage.from_bytes(data, device="cpu").render_frame(0).to_u8()
    assert vardct.VardctFrameState._fused_cache
    clear_program_caches()
    assert not vardct.VardctFrameState._fused_cache
    assert not vardct._PLANE_POOL and not varblock._CONST_CACHE
    assert dct.dct_basis_inverse.cache_info().currsize == 0
    after = JxlImage.from_bytes(data, device="cpu").render_frame(0).to_u8()
    assert np.array_equal(before, after)
    assert tp.max_lsb(after, tp.jax_u8(data)) <= 1


@pytest.mark.parametrize("shape,dtype,icc", [
    ((7, 5), np.uint8, None), ((6, 9, 3), np.uint8, b"profile"),
    ((4, 3, 4), np.uint16, None), ((5, 2, 2), np.uint16, b"p")])
def test_png_bytes_equal_the_jax_writer(tmp_path, shape, dtype, icc):
    from jxl_oxide_tpu.io.png import write_apng as jax_apng
    from jxl_oxide_tpu.io.png import write_png as jax_png
    from jxl_oxide_tpu_torch.io.png import write_apng, write_png

    rng = np.random.default_rng(sum(shape))
    hi = np.iinfo(dtype).max
    frames = [rng.integers(0, hi + 1, shape).astype(dtype) for _ in range(3)]
    write_png(tmp_path / "a.png", frames[0], icc=icc)
    jax_png(tmp_path / "b.png", frames[0], icc=icc)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png"
                                                 ).read_bytes()
    write_apng(tmp_path / "a.apng", frames, [40, 50.5, 60], icc=icc)
    jax_apng(tmp_path / "b.apng", frames, [40, 50.5, 60], icc=icc)
    assert (tmp_path / "a.apng").read_bytes() == (tmp_path / "b.apng"
                                                  ).read_bytes()
    from PIL import Image

    with Image.open(io.BytesIO((tmp_path / "a.png").read_bytes())) as im:
        got = np.asarray(im)
    if dtype == np.uint8:
        assert np.array_equal(got.reshape(frames[0].shape), frames[0])
