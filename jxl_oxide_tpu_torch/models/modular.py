"""Modular image decoding: header, channel grouping, per-stream sample decode.

Behavioral parity: jxl-modular/src/lib.rs (ModularHeader, local MA header
validation), image.rs (global/LF-group/pass-group channel splitting, stream
decode order, fast paths: RLE fast-lossless, single-node, gradient-table,
general slow path with full property vector).

Host-side stage. Channels are numpy int32 arrays; per-group decode writes into
views of the transformed channel arrays so groups decode independently (the
host-parallel grain). Inverse transforms run once per (sub)image after all
groups land: on the host (numpy and the C++ squeeze), or, for a large frame
decoded on CUDA, on the device (`inverse_transforms_device`, with the
squeeze as a hand-written CUDA kernel; ModularImage.finish selects).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..coding.entropy import Decoder
from ..io.bitstream import Bitstream, U, unpack_signed
from ..utils.errors import JxlEofError, JxlValidationError
from .modular_ma import FlatLeaf, FlatTree, MaConfig
from .modular_predict import PredictorState, WpHeader, grad_clamped, _wrap_i32
from .modular_transform import (
    DELTA_PALETTE,
    ChannelInfo,
    Palette,
    Rct,
    Slot,
    Squeeze,
    TransformInfo,
    parse_transform,
)

__all__ = ["ModularHeader", "ModularImage", "ModularSubimage", "ChannelInfo",
           "inverse_transforms_device"]


def _row_bands(t: torch.Tensor, mesh) -> list:
    """A 2-D plane in row bands over the mesh shards of this process, as
    GSPMD splits a row-sharded array: ceil(h / n) rows each, band k on
    shard k's device (bands past the plane's end are empty and dropped)."""
    devices = [mesh.devices[s] for s in mesh.local]
    chunk = -(-t.shape[0] // len(devices))
    return [t[k * chunk:(k + 1) * chunk].to(d)
            for k, d in enumerate(devices) if k * chunk < t.shape[0]]


def _whole(x, device) -> torch.Tensor:
    """A plane (a tensor or its row bands) whole on `device`."""
    if isinstance(x, list):
        return torch.cat([b.to(device) for b in x])
    return x


def _banded(x, mesh) -> list | None:
    """Row bands of plane `x` under `mesh` (its own if it has them), or
    None for a plane with fewer rows than the mesh has local shards (it
    stays whole, jxl_oxide_tpu/models/modular.py:331-336)."""
    if isinstance(x, list):
        return x
    if x.dim() == 2 and x.shape[0] >= len(mesh.local):
        return _row_bands(x, mesh)
    return None


def inverse_transforms_device(transforms, planes: list, bit_depth: int,
                              mesh=None) -> list:
    """The inverse transforms on int32 tensors (jxl_oxide_tpu/models/
    modular.py _finish_device's chain): `planes` are the transformed
    channel slots in slot order, as tensors on one device; returns the
    original channels. It mirrors the host's slot bookkeeping: residual
    removal for in-place squeezes and the others, the palette meta pop and
    the re-expansion of its members. RCT and palette are torch ops
    (ops/modular_tail.py); each squeeze goes through the kernel's wrapper
    ops/cuda/squeeze.py inv_squeeze_cuda, looked up on its module at each
    call so that a measurement can wrap it in one place.

    Under a decode `mesh` the steps whose rows are independent run per row
    band, each band on its shard's device: RCT, and the horizontal
    squeeze, which launches the kernel once per band. The steps that
    couple rows (the vertical squeeze, palette) gather their operands on
    the planes' device, as GSPMD's resharding does for the JAX package's
    row-sharded slots (jxl_oxide_tpu/models/modular.py:317-345). The
    result is the same bit for bit, whole on the planes' device."""
    from ..ops import modular_tail as mt
    from ..ops.cuda import squeeze as kernel

    home = planes[0].device if planes else None
    dev = list(planes)
    for tr in reversed(transforms):
        if isinstance(tr, Rct):
            b = tr.begin_c
            ops = dev[b:b + 3]
            bands = ([_banded(x, mesh) for x in ops] if mesh is not None
                     else [None])
            if all(x is not None for x in bands):
                outs = [mt.inv_rct(x, y, z, tr.rct_type)
                        for x, y, z in zip(*bands)]
                dev[b], dev[b + 1], dev[b + 2] = (list(o) for o in zip(*outs))
            else:
                dev[b], dev[b + 1], dev[b + 2] = mt.inv_rct(
                    *[_whole(x, home) for x in ops], tr.rct_type)
        elif isinstance(tr, Squeeze):
            for sp in reversed(tr.sp):
                begin, n = sp.begin_c, sp.num_c
                end = begin + n
                if sp.in_place:
                    residuals = dev[end : end + n]
                    del dev[end : end + n]
                else:
                    residuals = dev[len(dev) - n :]
                    del dev[len(dev) - n :]
                for i in range(n):
                    avg, res = dev[begin + i], residuals[i]
                    if mesh is not None and sp.horizontal:
                        bands = [_banded(avg, mesh), _banded(res, mesh)]
                        if all(x is not None for x in bands):
                            dev[begin + i] = [
                                kernel.inv_squeeze_cuda(a, r_, True)
                                for a, r_ in zip(*bands)]
                            continue
                    dev[begin + i] = kernel.inv_squeeze_cuda(
                        _whole(avg, home), _whole(res, home), sp.horizontal
                    )
        else:  # Palette
            palette = _whole(dev.pop(0), home)
            begin = tr.begin_c
            outs = mt.palette_lookup(
                palette, _whole(dev[begin], home),
                torch.from_numpy(DELTA_PALETTE).to(palette.device),
                tr.num_c, tr.nb_colours, tr.nb_deltas, bit_depth,
            )
            dev[begin : begin + 1] = list(outs)
    return [_whole(x, home) for x in dev]


@dataclass
class ModularHeader:
    use_global_tree: bool
    wp_header: WpHeader
    transforms: list[TransformInfo]

    @classmethod
    def parse(cls, bs: Bitstream) -> "ModularHeader":
        use_global_tree = bs.read_bool()
        wp_header = WpHeader(bs)
        nb_transforms = bs.read_u32(0, 1, 2 + U(4), 18 + U(8))
        if nb_transforms > 512:
            raise JxlValidationError("nb_transforms too large")
        transforms = [parse_transform(bs, wp_header) for _ in range(nb_transforms)]
        return cls(use_global_tree, wp_header, transforms)


def _unpack_signed_np(u: np.ndarray) -> np.ndarray:
    return np.where(u & 1, -((u.astype(np.int64) + 1) >> 1), u >> 1).astype(np.int32)


class ModularImage:
    """A full Modular (sub)image: transformed channels + decode plumbing.

    Mirrors ModularImageDestination (image.rs:97+): owns the transformed
    channel buffers; `prepare_groups` hands out per-group views."""

    def __init__(
        self,
        bs: Bitstream,
        channels: list[ChannelInfo],
        group_dim: int,
        bit_depth: int,
        global_ma_config: MaConfig | None,
        views: list[np.ndarray] | None = None,
        dtype=np.int32,
    ):
        """If `views` is given (recursive per-group image), channel buffers
        are the provided views; otherwise fresh arrays are allocated with
        `dtype` (int16 = the narrow sample lane, sample.rs:4-36)."""
        self.group_dim = group_dim
        self.bit_depth = bit_depth
        self.header = ModularHeader.parse(bs)

        # Info-only transform pass (validation; reference
        # read_and_validate_local_modular_header).
        info = [
            ChannelInfo(c.width, c.height, c.hshift, c.vshift,
                        c.original_width, c.original_height)
            for c in channels
        ]
        nb_meta = 0
        for tr in self.header.transforms:
            if isinstance(tr, Squeeze):
                tr.set_default_params(info, nb_meta)
            nb_meta = tr.check(info, nb_meta)
        if len(info) > (1 << 16):
            raise JxlValidationError("too many channels after transform")

        if self.header.use_global_tree:
            if global_ma_config is None:
                raise JxlValidationError("global MA tree not available")
            self.ma_config = global_ma_config
        else:
            local_samples = sum(c.width * c.height for c in info)
            node_limit = min(1024 + local_samples, 1 << 20)
            self.ma_config = MaConfig(bs, node_limit)

        self.original_channels = channels
        # Buffers for the ORIGINAL channels; transforms hand out views.
        if views is not None:
            self.image_channels = views
        else:
            from ..utils.alloc import current_tracker, track_alloc

            itemsize = np.dtype(dtype).itemsize
            nbytes = sum(itemsize * c.height * c.width for c in channels)
            track_alloc(nbytes)
            tracker = current_tracker()
            if tracker is not None:
                # returned to the budget when the modular image is dropped
                # (alloc_tracker.rs drop semantics)
                import weakref

                weakref.finalize(self, tracker.release, nbytes)
            self.image_channels = [
                np.zeros((c.height, c.width), dtype=dtype) for c in channels
            ]
        # Meta channel buffers (palette), in transform parse order; the
        # sample lane is uniform across a stream (Modular<S>), so meta
        # channels use the image dtype.
        if views is not None and views:
            dtype = views[0].dtype
        self.meta_channels: list[np.ndarray] = []
        for tr in self.header.transforms:
            if isinstance(tr, Palette):
                self.meta_channels.append(
                    np.zeros((tr.num_c, tr.nb_colours), dtype=dtype)
                )

        # Grid transform pass: produce transformed (infos, slots).
        infos = [
            ChannelInfo(c.width, c.height, c.hshift, c.vshift,
                        c.original_width, c.original_height)
            for c in channels
        ]
        slots = [Slot(arr) for arr in self.image_channels]
        meta_queue = list(self.meta_channels)
        nb_meta = 0
        for tr in self.header.transforms:
            nb_meta = tr.check(infos, nb_meta, slots, meta_queue)
        self.channels = infos
        self.slots = slots
        self.nb_meta_channels = nb_meta
        self.finished = False

    @property
    def grids(self) -> list[np.ndarray]:
        return [s.arr for s in self.slots]

    # ------------------------------------------------------------------

    def global_channel_count(self) -> int:
        """Channels decoded in the LfGlobal stream (image.rs prepare_gmodular
        take_while): meta channels plus small channels, stopping at the first
        channel exceeding group_dim."""
        n = 0
        for i, c in enumerate(self.channels):
            if i < self.nb_meta_channels or (
                c.width <= self.group_dim and c.height <= self.group_dim
            ):
                n += 1
            else:
                break
        return n

    def subimage_global(self) -> "ModularSubimage":
        n = self.global_channel_count()
        return ModularSubimage(
            self,
            channel_ids=list(range(n)),
            infos=[self.channels[i] for i in range(n)],
            views=[self.slots[i].arr for i in range(n)],
        )

    def subimage_all(self) -> "ModularSubimage":
        """All transformed channels as one stream (recursive group images)."""
        return ModularSubimage(
            self,
            channel_ids=list(range(len(self.channels))),
            infos=list(self.channels),
            views=[s.arr for s in self.slots],
        )

    def prepare_groups(self, pass_shifts: dict[int, tuple[int, int]]):
        """Split large channels into per-LF-group and per-(pass, group)
        subimages (image.rs prepare_groups). pass_shifts: pass_idx ->
        (minshift, maxshift). Returns (lf_groups, pass_groups) where each is a
        list (by group index) of ModularSubimage."""
        num_passes = max(pass_shifts.keys()) + 1
        group_dim = self.group_dim
        gshift = group_dim.bit_length() - 1

        lf_groups: dict[int, ModularSubimage] = {}
        pass_groups: list[dict[int, ModularSubimage]] = [
            {} for _ in range(num_passes)
        ]
        start = self.global_channel_count()
        for i in range(start, len(self.channels)):
            c = self.channels[i]
            assert c.hshift >= 0 and c.vshift >= 0
            if c.hshift < 3 or c.vshift < 3:
                shift = min(c.hshift, c.vshift)
                pass_idx = next(
                    p
                    for p, (mn, mx) in pass_shifts.items()
                    if mn <= shift < mx
                )
                gw = group_dim >> c.hshift
                gh = group_dim >> c.vshift
                if gw == 0 or gh == 0:
                    raise JxlValidationError("channel shift too large")
                count_x = (c.original_width + group_dim - 1) >> gshift
                count_y = (c.original_height + group_dim - 1) >> gshift
                target = pass_groups[pass_idx]
            else:
                gw = group_dim >> (c.hshift - 3)
                gh = group_dim >> (c.vshift - 3)
                if gw == 0 or gh == 0:
                    raise JxlValidationError("channel shift too large")
                count_x = (c.original_width + (group_dim << 3) - 1) >> (gshift + 3)
                count_y = (c.original_height + (group_dim << 3) - 1) >> (gshift + 3)
                target = lf_groups

            grid = self.slots[i].arr
            h, w = grid.shape
            for gy in range(count_y):
                for gx in range(count_x):
                    g_idx = gy * count_x + gx
                    x0, y0 = gx * gw, gy * gh
                    x1, y1 = min(x0 + gw, w), min(y0 + gh, h)
                    if x1 <= x0 or y1 <= y0:
                        continue
                    sub = target.get(g_idx)
                    if sub is None:
                        sub = ModularSubimage(self, [], [], [])
                        target[g_idx] = sub
                    view = grid[y0:y1, x0:x1]
                    sub.channel_ids.append(i)
                    sub.infos.append(
                        ChannelInfo(
                            x1 - x0, y1 - y0, c.hshift, c.vshift,
                            (x1 - x0) << c.hshift, (y1 - y0) << c.vshift,
                        )
                    )
                    sub.views.append(view)
        return lf_groups, pass_groups

    def finish(self, to_device: bool = False) -> list:
        """Apply inverse transforms (reverse order) and return the original
        channels.

        The tail runs on the decode's device when `device_tail_selected`
        (a CUDA decode, transforms the device twins take, a plane of at
        least utils/options.py DEVICE_TAIL_MIN_SAMPLES samples); else on
        the host, in place through the views. With to_device=True a device
        tail returns its int32 tensors on the device and writes nothing
        back: the render leg reads them there. Otherwise the results are
        written back into the original channel buffers, which this
        returns, for host consumers (a group sub-image's parent views, the
        float-sample conversion, tests)."""
        if self.device_tail_selected():
            planes = self._finish_device()
            if to_device:
                return planes
            for target, arr in zip(self.image_channels, planes):
                target[:, :] = arr.cpu().numpy()
            return self.image_channels
        slots = self.slots
        for tr in reversed(self.header.transforms):
            tr.inverse(slots, self.bit_depth)
        self.finished = True
        return self.image_channels

    def device_tail_selected(self) -> bool:
        """finish()'s selection (jxl_oxide_tpu/models/modular.py:269-276,
        without the JXL_TPU_DEVICE_MODULAR override)."""
        from ..utils import options as _opts

        return bool(
            _opts.device_modular_may_engage()
            and self.header.transforms
            and self._device_tail_supported()
            and self._device_tail_worthwhile()
        )

    def _device_tail_worthwhile(self) -> bool:
        """The size gate: the squeeze recurrence is sequential along the
        squeezed axis and parallel across the other, so small planes leave
        the card idle while the host C++ path finishes in microseconds.
        Engage only when at least one transformed plane carries at least
        utils/options.py DEVICE_TAIL_MIN_SAMPLES samples."""
        from ..utils import options as _opts

        return any(
            s.arr is not None and s.arr.size >= _opts.DEVICE_TAIL_MIN_SAMPLES
            for s in self.slots
        )

    def _device_tail_supported(self) -> bool:
        """Device envelope: i32 lane and transforms whose device twins are
        bit-exact (palette predictor-deltas with a non-Zero predictor are
        sample-sequential on the output raster — host only)."""
        if any(
            s.arr.dtype != np.int32
            for s in self.slots
            if s.arr is not None and s.arr.size
        ):
            return False
        for tr in self.header.transforms:
            if isinstance(tr, Palette):
                if tr.nb_deltas > 0 and tr.d_pred != 0:
                    return False
                if self.bit_depth >= 28:
                    # synthetic-palette products exceed i32 (the device
                    # ops have no i64 lane); the host path computes in i64
                    return False
            elif not isinstance(tr, (Rct, Squeeze)):
                return False
        return True

    def _finish_device(self) -> list[torch.Tensor]:
        """Device twin of the host tail: the slots go up to the decode's
        device in one copy, then `inverse_transforms_device` (in row bands
        over the decode mesh, if one is set). Returns the original
        channels as int32 tensors there."""
        from ..parallel import get_decode_mesh
        from ..utils.options import get_decode_device

        arrs = [s.arr for s in self.slots]
        sizes = [a.size for a in arrs]
        flat = np.empty(sum(sizes), dtype=np.int32)
        pos = 0
        for a, n in zip(arrs, sizes):
            flat[pos : pos + n] = a.reshape(-1)
            pos += n
        buf = torch.from_numpy(flat).to(get_decode_device())
        planes = [
            part.view(a.shape)
            for part, a in zip(torch.split(buf, sizes), arrs)
        ]
        out = inverse_transforms_device(self.header.transforms, planes,
                                        self.bit_depth, get_decode_mesh())
        self.finished = True
        return out

    def snapshot(self) -> "ModularImage":
        """Copy of the current decode state whose finish() leaves this
        image untouched: progressive renders finish a snapshot while the
        original keeps accepting newly arrived sections (the reference's
        RenderCache resume contract, jxl-render/src/state.rs:17-44).

        Buffers are copied and the transform grid pass is replayed on the
        copies, rebuilding the slot/view aliasing structure."""
        clone = object.__new__(ModularImage)
        clone.group_dim = self.group_dim
        clone.bit_depth = self.bit_depth
        clone.header = self.header  # parsed, read-only
        clone.ma_config = self.ma_config
        clone.original_channels = self.original_channels
        clone.image_channels = [a.copy() for a in self.image_channels]
        clone.meta_channels = [a.copy() for a in self.meta_channels]
        infos = [
            ChannelInfo(c.width, c.height, c.hshift, c.vshift,
                        c.original_width, c.original_height)
            for c in self.original_channels
        ]
        slots = [Slot(arr) for arr in clone.image_channels]
        meta_queue = list(clone.meta_channels)
        nb_meta = 0
        for tr in self.header.transforms:
            nb_meta = tr.check(infos, nb_meta, slots, meta_queue)
        clone.channels = infos
        clone.slots = slots
        clone.nb_meta_channels = nb_meta
        clone.finished = False
        return clone


class ModularSubimage:
    """A decodable slice of a ModularImage: a set of channel views that share
    one entropy stream (TransformedModularSubimage in the reference)."""

    def __init__(self, image: ModularImage, channel_ids, infos, views):
        self.image = image
        self.channel_ids: list[int] = channel_ids
        self.infos: list[ChannelInfo] = infos
        self.views: list[np.ndarray] = views
        self.partial = True

    @property
    def is_empty(self) -> bool:
        return not self.infos

    def decode(self, bs: Bitstream, stream_index: int, allow_partial: bool = False):
        try:
            self._decode_inner(bs, stream_index)
            self.partial = False
        except JxlEofError:
            if not allow_partial:
                raise

    # ------------------------------------------------------------------

    def _flat_trees(self, stream_index: int) -> list[FlatTree | None]:
        ma = self.image.ma_config
        trees: list[FlatTree | None] = []
        for i, info in enumerate(self.infos):
            if info.width == 0 or info.height == 0:
                trees.append(None)
                continue
            prev = sum(
                1
                for p in self.infos[:i]
                if (p.width, p.height, p.hshift, p.vshift)
                == (info.width, info.height, info.hshift, info.vshift)
            )
            trees.append(ma.make_flat_tree(i, stream_index, prev))
        return trees

    def _prev_lists(self, trees) -> list[list[np.ndarray]]:
        prev_lists: list[list[np.ndarray]] = []
        prev_map: dict[tuple, list[np.ndarray]] = {}
        for info, tree, grid in zip(self.infos, trees, self.views):
            key = (info.width, info.height, info.hshift, info.vshift)
            filtered = prev_map.setdefault(key, [])
            if tree is None:
                prev_lists.append([])
                continue
            prev_lists.append(list(filtered[: tree.max_prev_channel_depth]))
            filtered.insert(0, grid)
        return prev_lists

    def native_record(self, bs: Bitstream, stream_index: int) -> dict:
        """Per-section record for the batched native decode
        (native.decode_modular_batch). The decoder tables serialize once
        per MaConfig (cached on the parsed decoder template)."""
        from .. import native as _native

        trees = self._flat_trees(stream_index)
        tables = _native.DecoderTables.cached(
            self.image.ma_config.decoder_template
        )
        return {
            "data": bs.data,
            "pos": bs.pos,
            "tables": tables,
            "infos": self.infos,
            "trees": trees,
            "views": self.views,
            "prev_lists": self._prev_lists(trees),
            "dist_multiplier": max((c.width for c in self.infos), default=0),
            "wp_header": self.image.header.wp_header,
        }

    def _decode_inner(self, bs: Bitstream, stream_index: int) -> None:
        if self.is_empty:
            # The reference still begins and finalizes the entropy stream for
            # an empty (sub)image (image.rs decode_inner) — the 32-bit ANS
            # state is present in the bitstream and must be consumed.
            decoder = self.image.ma_config.make_decoder()
            decoder.begin(bs)
            decoder.finalize()
            return
        ma = self.image.ma_config
        dist_multiplier = max((c.width for c in self.infos), default=0)
        decoder = ma.make_decoder()
        trees = self._flat_trees(stream_index)

        # Native (C++) host runtime: whole-stream decode in one call.
        from .. import native as _native

        if _native.available():
            _native.decode_modular_native(
                bs, decoder, self.infos, trees, self.views,
                self._prev_lists(trees), dist_multiplier,
                self.image.header.wp_header,
            )
            return

        decoder.begin(bs)

        # fast-lossless: RLE decoder + all trees single Gradient leaf
        if decoder.rle_mode():
            simple = all(
                t is None
                or (
                    t.single_node() is not None
                    and t.single_node().predictor == 5
                    and t.single_node().offset == 0
                    and t.single_node().multiplier == 1
                )
                for t in trees
            )
            if simple:
                self._decode_fast_lossless(bs, decoder, trees)
                return

        wp = self.image.header.wp_header
        state = PredictorState()
        prev_map: dict[tuple, list[np.ndarray]] = {}
        for info, tree, grid in zip(self.infos, trees, self.views):
            if tree is None:
                continue
            key = (info.width, info.height, info.hshift, info.vshift)
            filtered_prev = prev_map.setdefault(key, [])

            single = tree.single_node()
            table = None if single else tree.simple_table()
            if single is not None:
                self._decode_single_node(
                    bs, decoder, dist_multiplier, state, wp, grid, single
                )
            elif table is not None:
                self._decode_simple_table(
                    bs, decoder, dist_multiplier, state, wp, grid, table
                )
            else:
                prevs = filtered_prev[: tree.max_prev_channel_depth]
                state.reset(
                    grid.shape[1],
                    prevs,
                    wp if tree.need_self_correcting else None,
                )
                self._decode_slow(bs, decoder, dist_multiplier, tree, state, grid)
            filtered_prev.insert(0, grid)
        decoder.finalize()

    # -- fast paths ----------------------------------------------------

    def _decode_fast_lossless(self, bs, decoder, trees) -> None:
        """RLE + gradient fast path (image.rs decode_fast_lossless)."""
        rle_value = 0
        rle_repeat = 0
        min_symbol = decoder.lz77_min_symbol
        min_length = decoder.lz77_min_length
        len_config = decoder.lz77.len_config
        from ..coding.entropy import read_uint

        def next_token(cluster: int) -> int:
            nonlocal rle_value, rle_repeat
            if rle_repeat == 0:
                token = decoder._read_symbol(bs, cluster)
                if token >= min_symbol:
                    rle_repeat = (
                        read_uint(bs, len_config, token - min_symbol) + min_length
                    )
                else:
                    rle_value = unpack_signed(read_uint(
                        bs, decoder.configs[cluster], token
                    ))
                    rle_repeat = 1
            rle_repeat -= 1
            return rle_value

        for tree, grid in zip(trees, self.views):
            if tree is None:
                continue
            cluster = tree.single_node().cluster
            h, w = grid.shape
            row = np.zeros(w, dtype=np.int64)
            # first row: cumulative sum of tokens
            prev = None
            for y in range(h):
                if y == 0:
                    wv = 0
                    for x in range(w):
                        wv = _wrap_i32(wv + next_token(cluster))
                        row[x] = wv
                else:
                    wv = _wrap_i32(int(prev[0]) + next_token(cluster))
                    row[0] = wv
                    for x in range(1, w):
                        nw = int(prev[x - 1])
                        n = int(prev[x])
                        pred = grad_clamped(n, wv, nw)
                        wv = _wrap_i32(pred + next_token(cluster))
                        row[x] = wv
                grid[y, :] = row
                prev = row.copy()

    def _decode_single_node(
        self, bs, decoder, dist_multiplier, state, wp, grid, leaf: FlatLeaf
    ) -> None:
        h, w = grid.shape
        cluster = leaf.cluster
        single_token = decoder.single_token(cluster)
        if leaf.predictor == 0 and single_token is not None:
            value = _wrap_i32(
                unpack_signed(single_token) * leaf.multiplier + leaf.offset
            )
            grid[:, :] = value
            return
        if leaf.predictor == 0 and single_token is None:
            mult, off = leaf.multiplier, leaf.offset
            for y in range(h):
                for x in range(w):
                    tok = decoder.read_varint_clustered(bs, cluster, dist_multiplier)
                    grid[y, x] = _wrap_i32(unpack_signed(tok) * mult + off)
            return
        if leaf.predictor == 5 and leaf.offset == 0 and leaf.multiplier == 1:
            self._decode_simple_grad(bs, decoder, cluster, dist_multiplier, grid)
            return
        state.reset(w, [], wp if leaf.predictor == 6 else None)
        self._decode_leaf_slow(bs, decoder, dist_multiplier, leaf, state, grid)

    def _decode_simple_grad(self, bs, decoder, cluster, dist_multiplier, grid) -> None:
        h, w = grid.shape
        prev = None
        rv = decoder.read_varint_clustered
        for y in range(h):
            row = np.zeros(w, dtype=np.int64)
            if y == 0:
                wv = 0
                for x in range(w):
                    wv = _wrap_i32(wv + unpack_signed(rv(bs, cluster, dist_multiplier)))
                    row[x] = wv
            else:
                wv = _wrap_i32(
                    int(prev[0]) + unpack_signed(rv(bs, cluster, dist_multiplier))
                )
                row[0] = wv
                for x in range(1, w):
                    pred = grad_clamped(int(prev[x]), wv, int(prev[x - 1]))
                    wv = _wrap_i32(pred + unpack_signed(rv(bs, cluster, dist_multiplier)))
                    row[x] = wv
            grid[y, :] = row
            prev = row

    def _decode_gradient_table(
        self, bs, decoder, dist_multiplier, grid, value_base, cluster_table
    ) -> None:
        h, w = grid.shape
        n_clusters = len(cluster_table)
        rv = decoder.read_varint_clustered
        prev = None
        for y in range(h):
            row = np.zeros(w, dtype=np.int64)
            if y == 0:
                wv = 0
                for x in range(w):
                    c = cluster_table[min(max(wv - value_base, 0), n_clusters - 1)]
                    wv = _wrap_i32(wv + unpack_signed(rv(bs, c, dist_multiplier)))
                    row[x] = wv
            else:
                p0 = int(prev[0])
                c = cluster_table[min(max(p0 - value_base, 0), n_clusters - 1)]
                wv = _wrap_i32(p0 + unpack_signed(rv(bs, c, dist_multiplier)))
                row[0] = wv
                for x in range(1, w):
                    n = int(prev[x])
                    nw = int(prev[x - 1])
                    prop = _wrap_i32(n + wv - nw)
                    pred = grad_clamped(n, wv, nw)
                    c = cluster_table[min(max(prop - value_base, 0), n_clusters - 1)]
                    wv = _wrap_i32(pred + unpack_signed(rv(bs, c, dist_multiplier)))
                    row[x] = wv
            grid[y, :] = row
            prev = row

    def _decode_simple_table(
        self, bs, decoder, dist_multiplier, state, wp, grid, table
    ) -> None:
        prop, value_base, predictor, offset, multiplier, cluster_table = table
        if offset == 0 and multiplier == 1 and prop == 9 and predictor == 5:
            self._decode_gradient_table(
                bs, decoder, dist_multiplier, grid, value_base, cluster_table
            )
            return
        need_wp = prop == 15 or predictor == 6
        state.reset(grid.shape[1], [], wp if need_wp else None)
        n_clusters = len(cluster_table)
        h, w = grid.shape
        for y in range(h):
            for x in range(w):
                state.compute_properties()
                pv = state.get_property(prop)
                c = cluster_table[min(max(pv - value_base, 0), n_clusters - 1)]
                tok = decoder.read_varint_clustered(bs, c, dist_multiplier)
                diff = _wrap_i32(unpack_signed(tok) * multiplier + offset)
                val = _wrap_i32(diff + state.predict(predictor))
                grid[y, x] = val
                state.record(val)

    def _decode_leaf_slow(
        self, bs, decoder, dist_multiplier, leaf: FlatLeaf, state, grid
    ) -> None:
        h, w = grid.shape
        cluster, predictor = leaf.cluster, leaf.predictor
        mult, off = leaf.multiplier, leaf.offset
        for y in range(h):
            for x in range(w):
                state.compute_properties()
                tok = decoder.read_varint_clustered(bs, cluster, dist_multiplier)
                diff = _wrap_i32(unpack_signed(tok) * mult + off)
                val = _wrap_i32(diff + state.predict(predictor))
                grid[y, x] = val
                state.record(val)

    def _decode_slow(self, bs, decoder, dist_multiplier, tree, state, grid) -> None:
        h, w = grid.shape
        for y in range(h):
            for x in range(w):
                state.compute_properties()
                leaf = tree.get_leaf(state)
                tok = decoder.read_varint_clustered(
                    bs, leaf.cluster, dist_multiplier
                )
                diff = _wrap_i32(unpack_signed(tok) * leaf.multiplier + leaf.offset)
                val = _wrap_i32(diff + state.predict(leaf.predictor))
                grid[y, x] = val
                state.record(val)
