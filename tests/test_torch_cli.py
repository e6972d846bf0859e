"""The port's front ends against the JAX package's, in process on the CPU:
both CLIs' `main` on the same files (info JSON equal; PNG, APNG and npy
pixels within 1 LSB, Modular byte for byte; the ICC chunk rules; --crop,
--target-colorspace; progressive, slow-motion, dump-jbrd), --num-devices
raising, one `python -m jxl_oxide_tpu_torch` subprocess, and the Pillow
plugin against the port's to_u8()."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity as tp
from jxl_oxide_tpu import cli as jax_cli
from jxl_oxide_tpu_torch import JxlImage, cli

CPU = ["--device", "cpu"]
# the fixtures whose JAX `info` JSON is committed (frontends.json)
FRONTENDS = ("flagship_1024", "modular_1024", "animation_4f_blend",
             "jbrd_container_256")


def run(main, argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _write(tmp_path, name, data) -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _animation() -> bytes:
    from encoder import encode_jxl_modular

    rng = np.random.default_rng(91)
    frames = [[rng.integers(0, 256, (24, 20), dtype=np.int64)
               for _ in range(3)] for _ in range(3)]
    return encode_jxl_modular(frames[0], bit_depth=8, animation_frames=frames,
                              animation_params=(30, 1, 0, None))


def _streams() -> dict:
    from encoder import encode_jxl_modular

    rng = np.random.default_rng(92)
    grey_alpha = [rng.integers(0, 256, (20, 30), dtype=np.int64)
                  for _ in range(2)]
    return {
        "vardct": tp.vardct_stream(64, 48, 3, gabor=True, epf_iters=2),
        "modular_wp_256": tp.fixture("modular_wp_256")[0],
        "animation": _animation(),
        "grey_alpha": encode_jxl_modular(grey_alpha, bit_depth=8,
                                         grayscale=True, extra_alpha=True),
    }


@pytest.fixture(scope="module")
def streams():
    return _streams()


# (stream, output format, extra arguments, exact): Modular output is byte
# for byte the JAX CLI's file
DECODES = {
    "vardct_png": ("vardct", "png", [], False),
    "vardct_crop_p3": ("vardct", "png", ["--crop", "20x10+5+3",
                                         "--target-colorspace",
                                         "display_p3"], False),
    "vardct_linear_png16": ("vardct", "png16", ["--target-colorspace",
                                                "linear-srgb"], False),
    "modular_png": ("modular_wp_256", "png", [], True),
    "modular_png16": ("modular_wp_256", "png16", [], True),
    "animation_apng": ("animation", "png", [], True),
    "grey_alpha_png": ("grey_alpha", "png8", [], True),
}


@pytest.mark.parametrize("case", sorted(DECODES))
def test_decode_png_as_the_jax_cli(tmp_path, streams, case):
    stream, fmt, extra, exact = DECODES[case]
    src = _write(tmp_path, "in.jxl", streams[stream])
    args = ["decode", src, "--output-format", fmt, *extra]
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    assert run(cli.main, [*args, "-o", ours, *CPU])[0] == 0
    assert run(jax_cli.main, [*args, "-o", ref])[0] == 0
    if exact:
        with open(ours, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
    a, b = tp.read_png(ours), tp.read_png(ref)
    assert a["icc"] == b["icc"] and a["delays"] == b["delays"]
    assert len(a["frames"]) == len(b["frames"])
    for x, y in zip(a["frames"], b["frames"]):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert tp.max_lsb(x, y) <= (0 if exact else 1)
    img = JxlImage.from_bytes(streams[stream], device="cpu")
    if "--crop" not in extra:
        conv = ((lambda r: r.to_u16()) if a["frames"][0].dtype == np.uint16
                else (lambda r: r.to_u8()))
        if "--target-colorspace" in extra:
            return
        for k, x in enumerate(a["frames"]):
            assert np.array_equal(x, conv(img.render_frame(k)))
    if case == "animation_apng":
        # durations in ms as the JAX CLI computes them: 1 tick at 30 tps
        assert a["delays"] == [(33, 1000)] * 3


def test_decode_npy_as_the_jax_cli(tmp_path, streams):
    src = _write(tmp_path, "in.jxl", streams["vardct"])
    ours, ref = str(tmp_path / "ours.npy"), str(tmp_path / "ref.npy")
    args = ["decode", src, "--output-format", "npy"]
    assert run(cli.main, [*args, "-o", ours, *CPU])[0] == 0
    assert run(jax_cli.main, [*args, "-o", ref])[0] == 0
    a, b = np.load(ours), np.load(ref)
    assert a.shape == b.shape == (1, 64, 48, 3) and a.dtype == np.float32

    def u8(x):
        return np.clip(np.round(x * 255), 0, 255).astype(np.uint8)

    assert tp.max_lsb(u8(a), u8(b)) <= 1


def _png_icc_case(case) -> tuple[bytes, object]:
    """(stream, header patch) of an ICC chunk rule (jxl_oxide_tpu/cli.py
    199-230): the sRGB default carries none; an embedded profile of a
    non-XYB image none (its samples leave the CMS as sRGB); an XYB
    image's embedded profile itself; an enum encoding other than sRGB a
    synthesized profile. No in-repo encoder writes the last two (it
    refuses an ICC profile beside XYB): the patch sets them on the parsed
    image, in both packages."""
    from encoder import encode_jxl_modular

    from jxl_oxide_tpu_torch.color.synthesize import colour_encoding_to_icc
    from jxl_oxide_tpu_torch.headers import image as timage

    rng = np.random.default_rng(93)
    chans = [rng.integers(0, 256, (16, 24), dtype=np.int64)
             for _ in range(3)]
    icc = colour_encoding_to_icc(tp.colour_encoding(
        timage, "RGB", prim="p3", intent="PERCEPTUAL"))
    if case == "embedded":
        return encode_jxl_modular(chans, bit_depth=8, embed_icc=icc), None
    if case == "xyb_embedded":
        def patch(img, image):
            img.embedded_icc = icc

        return encode_jxl_modular(chans, bit_depth=8, xyb=True), patch
    if case == "linear_enum":
        def patch(img, image):
            img.image_header.metadata.colour_encoding = tp.colour_encoding(
                image, "RGB", tf="linear")

        return encode_jxl_modular(chans, bit_depth=8), patch
    return encode_jxl_modular(chans, bit_depth=8), None


@pytest.mark.parametrize("case", ["srgb", "embedded", "xyb_embedded",
                                  "linear_enum"])
def test_icc_chunk_rules(tmp_path, monkeypatch, case):
    import jxl_oxide_tpu.api as jax_api
    import jxl_oxide_tpu.headers.image as jimage
    from jxl_oxide_tpu_torch import api as torch_api
    from jxl_oxide_tpu_torch.headers import image as timage

    data, patch = _png_icc_case(case)
    if patch:
        for api, image in ((jax_api, jimage), (torch_api, timage)):
            real = api.JxlImage._try_init

            def try_init(self, real=real, image=image):
                real(self)
                patch(self, image)

            monkeypatch.setattr(api.JxlImage, "_try_init", try_init)
    src = _write(tmp_path, "in.jxl", data)
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    assert run(cli.main, ["decode", src, "-o", ours, *CPU])[0] == 0
    assert run(jax_cli.main, ["decode", src, "-o", ref])[0] == 0
    a, b = tp.read_png(ours), tp.read_png(ref)
    assert a["icc"] == b["icc"]
    assert (a["icc"] is None) == (case in ("srgb", "embedded"))
    assert tp.max_lsb(a["frames"][0], b["frames"][0]) <= 1


def _info(main, path, extra=()) -> dict:
    rc, out, _ = run(main, ["info", path, *extra])
    assert rc == 0
    return json.loads(out)


@pytest.mark.parametrize("name", ["modular_wp_256", "ycbcr422_256",
                                  "patch_alpha_256", "crop_epf_77x45",
                                  "orient6_512x384", "grey_alpha_512",
                                  "ec_blend_premul_512"])
def test_info_equals_the_jax_cli(name):
    path = os.path.join(tp.TESTDATA, f"{name}.jxl")
    assert _info(cli.main, path, CPU) == _info(jax_cli.main, path)


@pytest.mark.parametrize("name", FRONTENDS)
def test_info_equals_the_committed_jax_json(name):
    with open(os.path.join(tp.TESTDATA, "frontends.json")) as f:
        want = json.load(f)["info"][name]
    path = os.path.join(tp.TESTDATA, f"{name}.jxl")
    assert _info(cli.main, path, CPU) == want


def test_module_entry_in_a_subprocess():
    """`python -m jxl_oxide_tpu_torch info` in a fresh interpreter."""
    path = os.path.join(tp.TESTDATA, "jbrd_container_256.jxl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "jxl_oxide_tpu_torch", "info", "--device",
         "cpu", path], cwd=tp.REPO, env=env, capture_output=True, text=True,
        timeout=300, check=True)
    assert json.loads(out.stdout) == _info(jax_cli.main, path)


def test_num_devices_raises_citing_item_13(tmp_path, streams):
    """--device cpu --num-devices 2 decodes over two CPU shards to the
    single-device PNG, byte for byte; --num-devices on CUDA with fewer
    cards than asked raises a clear error. (The name is this test's from
    before the sharded decode was ported, when the option raised.)"""
    src = _write(tmp_path, "in.jxl", streams["vardct"])
    pngs = []
    for extra in ([], ["--num-devices", "2"]):
        out = os.path.join(tmp_path, f"out{len(pngs)}.png")
        rc, _, err = run(cli.main, ["decode", src, "-o", out, *CPU, *extra])
        assert rc == 0, err
        with open(out, "rb") as f:
            pngs.append(f.read())
    assert pngs[0] == pngs[1]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"{cards} CUDA device"):
        cli.main(["decode", src, "-o", os.path.join(tmp_path, "x.png"),
                  "--num-devices", str(cards + 1)])


def test_default_device_is_cuda(tmp_path, streams):
    """With no --device the CLI decodes on CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI would decode on it")
    src = _write(tmp_path, "in.jxl", streams["vardct"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["info", src])


def test_num_reps_prints_the_geomean(tmp_path, streams):
    src = _write(tmp_path, "in.jxl", streams["modular_wp_256"])
    rc, _, err = run(cli.main, ["decode", src, "--num-reps", "2",
                                "--force-wide-buffers", "--num-threads",
                                "2", "--cms", "null", *CPU])
    assert rc == 0 and "decode: geomean" in err and "MP/s" in err


def test_dump_jbrd(tmp_path, streams):
    ref = np.load(os.path.join(tp.TESTDATA, "jbrd_container_256.npz"))
    out = str(tmp_path / "x.jpg")
    src = os.path.join(tp.TESTDATA, "jbrd_container_256.jxl")
    assert run(cli.main, ["dump-jbrd", src, "-o", out, *CPU])[0] == 0
    with open(out, "rb") as f:
        assert f.read() == ref["jpeg"].tobytes()
    none = _write(tmp_path, "in.jxl", streams["vardct"])
    assert run(cli.main, ["dump-jbrd", none, "-o", out, *CPU])[0] == 1


@pytest.fixture(scope="module")
def loading_stream():
    """A lossless stream of four 128² groups, so that its prefixes render
    (every loading render has the frame's shapes: the JAX package compiles
    its render tail once; VarDCT loading renders are held by
    test_torch_progressive.py)."""
    from encoder import encode_jxl_modular

    rng = np.random.default_rng(94)
    chans = [rng.integers(0, 256, (200, 240), dtype=np.int64)
             for _ in range(3)]
    return encode_jxl_modular(chans, bit_depth=8, group_size_shift=0)


def test_progressive_as_the_jax_cli(tmp_path, loading_stream):
    src = _write(tmp_path, "in.jxl", loading_stream)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    argv = ["progressive", src, "--steps", "4", "-o"]
    assert run(cli.main, [*argv, ours, *CPU])[0] == 0
    assert run(jax_cli.main, [*argv, ref])[0] == 0
    names = sorted(f[len("ours"):] for f in os.listdir(tmp_path)
                   if f.startswith("ours"))
    assert names == sorted(f[len("ref"):] for f in os.listdir(tmp_path)
                           if f.startswith("ref"))
    assert "-final.png" in names and len(names) > 2
    for n in names:
        # a lossless stream: the files are the JAX CLI's byte for byte
        with open(ours + n, "rb") as a, open(ref + n, "rb") as b:
            assert a.read() == b.read(), n
    final = tp.read_png(ours + "-final.png")["frames"][0]
    one_shot = JxlImage.from_bytes(loading_stream, device="cpu")
    assert np.array_equal(final, one_shot.render_frame(0).to_u8())


def test_slow_motion_as_the_jax_cli(tmp_path, loading_stream):
    src = _write(tmp_path, "in.jxl", loading_stream)
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    argv = ["slow-motion", src, "--steps", "3", "--frame-ms", "50", "-o"]
    assert run(cli.main, [*argv, ours, *CPU])[0] == 0
    assert run(jax_cli.main, [*argv, ref])[0] == 0
    a = tp.read_png(ours)
    assert len(a["frames"]) > 1
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def test_pillow_plugin_equals_to_u8(tmp_path, streams):
    """Image.open of a still stream (grey + alpha, LA), an oriented one and
    an animation with seek and tell, each frame equal to the port's
    to_u8(); the animation's duration as the JAX plugin gives it."""
    from PIL import Image

    from jxl_oxide_tpu.integration import register as jax_register
    from jxl_oxide_tpu_torch.integration import register

    register(device="cpu")
    still = _write(tmp_path, "a.jxl", streams["grey_alpha"])
    with Image.open(still) as im:
        assert (im.format, im.mode, im.size) == ("JXL", "LA", (30, 20))
        got = np.asarray(im)
    want = JxlImage.from_bytes(streams["grey_alpha"],
                               device="cpu").render_frame(0).to_u8()
    assert np.array_equal(got, want)
    oriented = os.path.join(tp.TESTDATA, "orient6_512x384.jxl")
    with Image.open(oriented) as im:
        # displayed 384 wide, 512 high, before and after the load
        assert im.size == (384, 512)
        assert np.asarray(im).shape == (512, 384, 3)
    anim = _write(tmp_path, "b.jxl", streams["animation"])
    img = JxlImage.from_bytes(streams["animation"], device="cpu")
    durations = []
    with Image.open(anim) as im:
        assert im.n_frames == 3 and im.is_animated
        for k in (2, 0, 1):
            im.seek(k)
            assert im.tell() == k
            assert np.array_equal(np.asarray(im),
                                  img.render_frame(k).to_u8())
            durations.append(im.info["duration"])
        with pytest.raises(EOFError):
            im.seek(3)
    jax_register()
    jax_durations = []
    with Image.open(anim) as im:
        for k in (2, 0, 1):
            im.seek(k)
            im.load()
            jax_durations.append(im.info["duration"])
    assert durations == jax_durations
    register(device="cpu")


def test_jax_plugin_size_before_load_on_orientation_6():
    """The reference's plugin swaps the displayed size of orientations 5-8
    once more, so before the load it reports the coded size (ROADMAP
    Queue 3); the port's reports the displayed size throughout."""
    from PIL import Image

    from jxl_oxide_tpu.integration import register as jax_register
    from jxl_oxide_tpu_torch.integration import register

    oriented = os.path.join(tp.TESTDATA, "orient6_512x384.jxl")
    jax_register()
    try:
        with Image.open(oriented) as im:
            assert im.size == (512, 384)
    finally:
        register(device="cpu")
    with Image.open(oriented) as im:
        assert im.size == (384, 512)
