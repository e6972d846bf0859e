"""Command-line interface of the port: decode, info, progressive,
slow-motion, dump-jbrd and generate-fixture.

The torch counterpart of jxl_oxide_tpu/cli.py (jxl-oxide-cli commands.rs,
decode.rs, info.rs): `decode` renders keyframes to PNG (APNG for an
animation) or NPY with --num-reps timing (geomean + range, MP/s); `info`
dumps header metadata and the frame list; `progressive` and
`slow-motion` render the loading states of growing byte prefixes;
`dump-jbrd` reconstructs the original JPEG; `generate-fixture` writes a
seeded test stream through the port's copies of the in-repo encoders
(encoders/), on the host, the bytes of the JAX CLI's for the same
arguments.

    python -m jxl_oxide_tpu_torch decode x.jxl -o x.png

Every decoding subcommand takes --device: CUDA by default, raising without it;
`--device cpu` runs the plain torch versions. A timed decode waits for
the device before it reads the clock. `decode --num-devices N` shards the
decode over a mesh of N shards (parallel/ decode_mesh): CUDA cards 0..N-1
(it raises when there are fewer), or N shards on the CPU under `--device
cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .utils.errors import JxlError, JxlNotSupportedError

__all__ = ["main"]


def _build_parser():
    p = argparse.ArgumentParser(prog="jxl-oxide-tpu-torch")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v: span timings (DEBUG)")
    sub = p.add_subparsers(dest="command")
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=None,
                     help="torch device of the decode (default: cuda, "
                          "which must exist; 'cpu' for the CPU)")

    d = sub.add_parser("decode", parents=[dev], help="decode a JXL image")
    d.add_argument("input")
    d.add_argument("-o", "--output", help="output PNG path")
    d.add_argument("--output-format", choices=["png", "png8", "png16", "npy"],
                   default="png")
    d.add_argument("--num-reps", type=int, default=1)
    d.add_argument("--target-colorspace", default=None,
                   help="e.g. srgb, display_p3, linear-srgb")
    d.add_argument("--target-icc", default=None,
                   help="path to an ICC profile to convert into")
    d.add_argument("--crop", default=None,
                   help="decode region: WIDTHxHEIGHT+LEFT+TOP")
    d.add_argument("--approx-memory-limit", type=int, default=None,
                   help="approximate decode memory budget in bytes")
    d.add_argument("--cms", choices=["pil", "null"], default="pil",
                   help="color management backend for ICC-described images")
    d.add_argument("--num-devices", type=int, default=None,
                   help="shard the decode over N devices: cuda:0..N-1, or "
                        "N CPU shards with --device cpu")
    d.add_argument("--force-wide-buffers", action="store_true",
                   help="disable the narrow (i16) modular sample lane")
    d.add_argument("--num-threads", type=int, default=None,
                   help="host decode worker threads (default: CPU count)")
    i = sub.add_parser("info", parents=[dev], help="dump image info")
    i.add_argument("input")
    i.add_argument("--with-offset", action="store_true")

    pr = sub.add_parser("progressive", parents=[dev],
                        help="render at increasing byte prefixes")
    pr.add_argument("input")
    pr.add_argument("-o", "--output-prefix", default="progressive")
    pr.add_argument("--steps", type=int, default=6)

    sm = sub.add_parser(
        "slow-motion", parents=[dev],
        help="animate the progressive loading process into an APNG",
    )
    sm.add_argument("input")
    sm.add_argument("-o", "--output", default="slow-motion.png")
    sm.add_argument("--steps", type=int, default=24,
                    help="byte-prefix steps (one APNG frame per step)")
    sm.add_argument("--frame-ms", type=int, default=120,
                    help="per-frame duration in milliseconds")

    dj = sub.add_parser("dump-jbrd", parents=[dev],
                        help="reconstruct the original JPEG")
    dj.add_argument("input")
    dj.add_argument("-o", "--output", required=True)

    gf = sub.add_parser("generate-fixture",
                        help="emit a spec-valid test JXL bitstream")
    gf.add_argument("-o", "--output", required=True)
    gf.add_argument("--kind", choices=["modular", "vardct"], default="modular")
    gf.add_argument("--size", default="64x64", help="WIDTHxHEIGHT")
    gf.add_argument("--seed", type=int, default=0)
    gf.add_argument("--grayscale", action="store_true")
    return p


def _parse_crop(spec: str):
    """WIDTHxHEIGHT+LEFT+TOP -> (left, top, width, height)."""
    import re

    m = re.fullmatch(r"(\d+)x(\d+)(?:\+(\d+)\+(\d+))?", spec)
    if m is None:
        raise SystemExit(f"invalid --crop {spec!r}; expected WxH+L+T")
    w, h, left, top = (int(v or 0) for v in m.groups())
    return left, top, w, h


def _decode_once(data: bytes, args):
    """One decode of every keyframe, finished on the device: the image and
    its renders."""
    from .api import JxlImage

    mesh = None
    if args.num_devices:
        from .parallel import decode_mesh

        cpu = args.device is not None and torch.device(args.device).type == (
            "cpu")
        mesh = decode_mesh(args.num_devices,
                           devices=["cpu"] * args.num_devices if cpu
                           else None)
    img = JxlImage(device=None if mesh is not None else args.device,
                   approx_memory_limit=args.approx_memory_limit,
                   num_threads=args.num_threads,
                   force_wide_buffers=args.force_wide_buffers, mesh=mesh)
    img.feed_bytes(data)
    img.finish()
    if args.cms == "null":
        from .color.cms import NullCms

        img.set_cms(NullCms())
    if args.crop:
        img.set_image_region(*_parse_crop(args.crop))
    if args.target_icc:
        with open(args.target_icc, "rb") as f:
            img.request_icc(f.read())
    elif args.target_colorspace:
        img.request_color_encoding(
            _encoding_from_name(args.target_colorspace))
    renders = [img.render_frame(i) for i in range(img.num_keyframes)]
    if img.device.type == "cuda":
        # renders return with their device work queued: the decode ends
        # when the card has finished it
        torch.cuda.synchronize(img.device)
    return img, renders


def _encoding_from_name(name: str):
    """CLI colorspace names (decode.rs --target-colorspace)."""
    from .headers.image import (
        ColourEncoding,
        Primaries,
        RenderingIntent,
        TransferFunction,
    )

    name = name.lower().replace("_", "-")
    table = {
        "srgb": ColourEncoding(),
        "linear-srgb": ColourEncoding(tf=TransferFunction.LINEAR),
        "display-p3": ColourEncoding(
            primaries=Primaries.P3,
            rendering_intent=RenderingIntent.PERCEPTUAL,
        ),
        "bt2100-pq": ColourEncoding(
            primaries=Primaries.BT2100, tf=TransferFunction.PQ,
        ),
        "bt2100-hlg": ColourEncoding(
            primaries=Primaries.BT2100, tf=TransferFunction.HLG,
        ),
    }
    if name not in table:
        raise SystemExit(
            f"unknown colorspace {name!r}; choices: {', '.join(table)}"
        )
    return table[name]


def _output_icc(img) -> bytes | None:
    """The ICC profile a PNG carries (jxl_oxide_tpu/cli.py:199-230): the
    embedded one of an XYB image; none for ICC-described samples, which
    the CMS converted to sRGB; a synthesized one for a non-sRGB enum
    encoding."""
    meta = img.image_header.metadata
    if img.embedded_icc is not None:
        return img.embedded_icc if meta.xyb_encoded else None
    enc = meta.colour_encoding
    is_srgb = meta.xyb_encoded or (
        enc.primaries.kind == "srgb"
        and enc.white_point.kind == "d65"
        and enc.tf.kind == "srgb"
    )
    if is_srgb or enc.want_icc:
        return None
    from .color.synthesize import colour_encoding_to_icc

    try:
        return colour_encoding_to_icc(enc)
    except JxlError:
        return None


def _loading_u8(render) -> np.ndarray:
    """A loading render's colour as u8, as the JAX CLI quantizes it (on
    the host, in numpy)."""
    planes = torch.stack(render.image_planar(), -1).cpu().numpy()
    return np.clip(np.round(planes * 255), 0, 255).astype(np.uint8)


def cmd_decode(args) -> int:
    with open(args.input, "rb") as f:
        data = f.read()

    times = []
    img = renders = None
    for _ in range(max(1, args.num_reps)):
        t0 = time.perf_counter()
        img, renders = _decode_once(data, args)
        times.append(time.perf_counter() - t0)

    npixels = img.width * img.height * max(1, len(renders))
    if args.num_reps > 1:
        geomean = float(np.exp(np.mean(np.log(times))))
        print(
            f"decode: geomean {geomean * 1e3:.2f} ms "
            f"(range {min(times) * 1e3:.2f}..{max(times) * 1e3:.2f} ms), "
            f"{npixels / geomean / 1e6:.2f} MP/s",
            file=sys.stderr,
        )
    else:
        print(
            f"decoded {img.width}x{img.height}, {len(renders)} keyframe(s) "
            f"in {times[0] * 1e3:.2f} ms "
            f"({npixels / times[0] / 1e6:.2f} MP/s)",
            file=sys.stderr,
        )

    if args.output:
        from .io.png import write_apng, write_png

        if args.output_format == "npy":
            arr = np.stack([r.image_all_channels() for r in renders])
            np.save(args.output, arr.astype(np.float32))
        else:
            bits = 16 if args.output_format == "png16" else 8
            if args.output_format == "png":
                bits = (
                    16
                    if img.image_header.metadata.bit_depth.bits_per_sample > 8
                    else 8
                )

            def conv(r):
                return r.to_u16() if bits == 16 else r.to_u8()

            icc = _output_icc(img)
            if len(renders) > 1 and img.is_animation:
                anim = img.image_header.metadata.animation
                durations = [
                    r.duration * 1000 * anim.tps_denominator / anim.tps_numerator
                    for r in renders
                ]
                write_apng(args.output, [conv(r) for r in renders], durations,
                           icc=icc)
            else:
                write_png(args.output, conv(renders[0]), icc=icc)
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    from .api import JxlImage

    with open(args.input, "rb") as f:
        data = f.read()
    img = JxlImage(device=args.device)
    img.feed_bytes(data)
    img.finish()
    meta = img.image_header.metadata
    info = {
        "width": img.width,
        "height": img.height,
        "bit_depth": meta.bit_depth.bits_per_sample,
        "xyb_encoded": meta.xyb_encoded,
        "grayscale": meta.grayscale,
        "orientation": meta.orientation,
        "animation": meta.animation is not None,
        "extra_channels": [
            {"type": e.ty.name, "name": e.name} for e in meta.ec_info
        ],
        "embedded_icc_bytes": len(img.embedded_icc) if img.embedded_icc else 0,
        "frames": [
            {
                "encoding": f.header.encoding.name,
                "size": [f.header.width, f.header.height],
                "is_last": f.header.is_last,
                "duration": f.header.duration,
                "name": f.header.name,
            }
            for f in img._frames
        ],
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_progressive(args) -> int:
    """Render the image at increasing byte prefixes (devtool `progressive`,
    commands.rs devtools)."""
    from .api import JxlImage
    from .io.png import write_png

    with open(args.input, "rb") as f:
        data = f.read()
    img = JxlImage(device=args.device)
    written = 0
    step = max(1, len(data) // max(1, args.steps))
    for i in range(0, len(data), step):
        img.feed_bytes(data[i : i + step])
        if img.image_header is None or not img._frames:
            continue
        try:
            r = img.render_loading_frame()
        except JxlError as e:
            print(f"{i + step}B: not renderable yet ({e})", file=sys.stderr)
            continue
        path = f"{args.output_prefix}-{written:02d}.png"
        write_png(path, _loading_u8(r))
        print(f"{min(i + step, len(data))}B -> {path}", file=sys.stderr)
        written += 1
    img.finish()
    r = img.render_frame(0)
    path = f"{args.output_prefix}-final.png"
    write_png(path, r.to_u8())
    print(f"final -> {path}", file=sys.stderr)
    return 0


def cmd_slow_motion(args) -> int:
    """Animate the progressive loading process: feed byte prefixes,
    render each loading state, and write one APNG (the reference's
    slow_motion devtool encodes an MP4 via ffmpeg, slow_motion.rs;
    APNG keeps the tool dependency-free here)."""
    from .api import JxlImage
    from .io.png import write_apng

    with open(args.input, "rb") as f:
        data = f.read()
    img = JxlImage(device=args.device)
    frames = []
    step = max(1, len(data) // max(1, args.steps))
    for i in range(0, len(data), step):
        img.feed_bytes(data[i : i + step])
        if img.image_header is None or not img._frames:
            continue
        try:
            r = img.render_loading_frame()
        except JxlError:
            continue
        frames.append(_loading_u8(r))
    img.finish()
    frames.append(JxlImage.from_bytes(data, device=args.device)
                  .render_frame(0).to_u8())
    # hold the final frame a bit longer
    durations = [args.frame_ms] * (len(frames) - 1) + [args.frame_ms * 6]
    write_apng(args.output, frames, durations)
    print(f"{len(frames)} loading states -> {args.output}", file=sys.stderr)
    return 0


def cmd_dump_jbrd(args) -> int:
    from .api import JxlImage

    img = JxlImage.open(args.input, device=args.device)
    if not img.jpeg_reconstruction_available:
        print("no jbrd box in this file", file=sys.stderr)
        return 1
    jpeg = img.reconstruct_jpeg()
    with open(args.output, "wb") as f:
        f.write(jpeg)
    print(f"wrote {args.output} ({len(jpeg)} bytes)", file=sys.stderr)
    return 0


def cmd_generate_fixture(args) -> int:
    """Devtool: a seeded test stream from the port's encoders (encoders/,
    numpy only, on the host), jxl_oxide_tpu/cli.py cmd_generate_fixture
    with the same arguments and the same bytes: random float RGB through
    encode_jxl_vardct, or random 8-bit planes (one with --grayscale,
    which a VarDCT stream ignores) through encode_jxl_modular."""
    w, h = (int(v) for v in args.size.lower().split("x"))
    rng = np.random.default_rng(args.seed)
    if args.kind == "vardct":
        from .encoders.encoder_vardct import encode_jxl_vardct

        data = encode_jxl_vardct(rng.random((h, w, 3)).astype(np.float32))
    else:
        from .encoders.encoder import encode_jxl_modular

        nch = 1 if args.grayscale else 3
        data = encode_jxl_modular(
            [rng.integers(0, 256, (h, w), dtype=np.int64)
             for _ in range(nch)], bit_depth=8)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {args.output} ({len(data)} bytes)", file=sys.stderr)
    return 0


_COMMANDS = {
    "decode": cmd_decode,
    "info": cmd_info,
    "progressive": cmd_progressive,
    "slow-motion": cmd_slow_motion,
    "dump-jbrd": cmd_dump_jbrd,
    "generate-fixture": cmd_generate_fixture,
}


def main(argv=None) -> int:
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.verbose:
        from .utils.trace import set_verbosity

        set_verbosity(args.verbose)
    command = _COMMANDS.get(args.command)
    if command is None:
        parser.print_help()
        return 1
    try:
        return command(args)
    except JxlNotSupportedError as e:
        print(f"{parser.prog}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
