"""VarDCT frame decode orchestration: host entropy stage -> device pipeline.

Behavioral parity: jxl-render/src/vardct/mod.rs (render_vardct) and
jxl-frame/src/data/{lf_group,hf_global,pass_group}.rs. The reference decodes
and transforms per 256x256 group on CPU threads; here the host stage fills
whole-frame coefficient planes (per TOC section, the host-parallel grain)
and then the device stage does everything numeric: LF
dequant+CfL+smoothing, HF dequant, HF CfL, the dense varblock inverse
transforms, gaborish and the EPF (ops/vardct_pipeline.py).

This is jxl_oxide_tpu/render/vardct.py on one device, cut to the port's
envelope. `run_device_pipeline` takes one of three paths, as the JAX
package does:
  - the fused 4:4:4 program;
  - the fused subsampled program (chroma upsample and filters included);
  - the staged path, per-plane dequant and bucketed transforms, when a
    dense plan has more than DENSE_PLAN_MAX_ENTRIES entries; the render
    tail (render/render.py) then upsamples and filters.
A frame that sets use_lf_frame takes the planes of its LF frame (device
tensors, `lf_override`) as its pre-dequantized LF on the fused 4:4:4 and
staged paths, edge-padded on their device. A loading frame keeps its
VarDCT state in a `ProgressiveCache` between renders (render/render.py
`partial_host_stage`): the planes stay with the state until the frame is
complete, and each render runs the device pipeline on them again. Under
a decode region (render/roi.py) both fused programs compute only a
group-aligned rect of the planes (their `rect` legs), embedded in zero
planes of the frame's size. Under a decode mesh (parallel/) both fused
programs run sharded by bands of whole groups (`_run_fused_sharded`,
`_run_fused_subsampled_sharded`), and a rect is ignored as the JAX
package ignores it: the frame renders whole and is cut later.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..headers.frame import Encoding
from ..io.bitstream import Bitstream
from ..models.vardct import (
    DequantMatrixSet,
    HfMetadata,
    HfPass,
    LfCoeff,
    TransformType,
    jpeg_shifts,
    write_hf_coeff,
)
from ..utils.trace import span, traced

__all__ = ["HfGlobal", "LfGroup", "ProgressiveCache", "VardctFrameState"]


# Cap on dense transform-plan entries (each entry is a full-plane pass;
# valid but pathological streams can stagger large transforms across
# hundreds of block-offset residue classes). Above it the decode takes
# the staged gather path, whose work is bounded by the 27 types.
DENSE_PLAN_MAX_ENTRIES = 96


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _ceil_shift(v: int, s: int) -> int:
    return (v + (1 << s) - 1) >> s


@dataclass
class LfGroup:
    lf_coeff: LfCoeff | None
    hf_meta: HfMetadata | None


class HfGlobal:
    """DequantMatrixSet + per-pass HfPass (jxl-frame data/hf_global.rs)."""

    def __init__(self, bs: Bitstream, image_header, frame_header, lf_global):
        self.dequant_matrices = DequantMatrixSet.parse(
            bs,
            image_header.metadata.bit_depth.bits_per_sample,
            frame_header.num_lf_groups,
            lf_global.gmodular.ma_config,
            frame_header.group_dim,
        )
        num_groups = frame_header.num_groups
        bits = max(num_groups - 1, 0).bit_length()
        self.num_hf_presets = bs.read_bits(bits) + 1
        hf_block_ctx = lf_global.vardct.hf_block_ctx
        self.hf_passes = [
            HfPass(bs, hf_block_ctx, self.num_hf_presets)
            for _ in range(frame_header.passes.num_passes)
        ]


def parse_lf_group(
    bs: Bitstream,
    image_header,
    frame_header,
    lf_global,
    lf_group_idx: int,
    mlf_subimage,
) -> LfGroup:
    """Section parser for one LF group (jxl-frame data/lf_group.rs:35-130)."""
    lf_width, lf_height = frame_header.lf_group_size_for(lf_group_idx)
    is_vardct = frame_header.encoding == Encoding.VARDCT
    bits = image_header.metadata.bit_depth.bits_per_sample
    gmodular = lf_global.gmodular

    lf_coeff = None
    if is_vardct and not frame_header.flags.use_lf_frame:
        lf_coeff = LfCoeff.parse(
            bs,
            lf_group_idx,
            lf_width,
            lf_height,
            frame_header.jpeg_upsampling,
            bits,
            gmodular.ma_config,
            frame_header.group_dim,
        )

    if mlf_subimage is not None and not mlf_subimage.is_empty:
        from ..models.modular import ModularImage

        recursive = ModularImage(
            bs,
            mlf_subimage.infos,
            frame_header.group_dim,
            bits,
            gmodular.ma_config,
            views=mlf_subimage.views,
        )
        stream = 1 + frame_header.num_lf_groups + lf_group_idx
        recursive.subimage_all().decode(bs, stream)
        recursive.finish()

    hf_meta = None
    if is_vardct:
        rf = frame_header.restoration_filter
        epf = None
        if rf.epf.enabled:
            epf = (rf.epf.quant_mul, rf.epf.sharp_lut)
        hf_meta = HfMetadata.parse(
            bs,
            num_lf_groups=frame_header.num_lf_groups,
            lf_group_idx=lf_group_idx,
            lf_width=lf_width,
            lf_height=lf_height,
            jpeg_upsampling=frame_header.jpeg_upsampling,
            bits_per_sample=bits,
            global_ma_config=gmodular.ma_config,
            group_dim=frame_header.group_dim,
            epf=epf,
            quantizer_global_scale=lf_global.vardct.quantizer.global_scale,
        )
    return LfGroup(lf_coeff, hf_meta)


class _Bucket:
    """Varblocks of one transform type within a channel plane.

    pos3 is the raw [n, 3] (x, y, hf_mul) array in block units; `indices`
    builds the [n, bh*8, bw*8] coefficient / [n, bh, bw] LF gather plans
    on demand (only the staged path needs them — the fused programs
    expand positions on device)."""

    __slots__ = ("sel", "pos3", "plane_shape", "lf_shape", "_idx")

    def __init__(self, sel, pos3, plane_shape, lf_shape):
        self.sel = sel
        self.pos3 = pos3
        self.plane_shape = plane_shape
        self.lf_shape = lf_shape
        self._idx = None

    @property
    def n(self) -> int:
        return len(self.pos3)

    @property
    def muls(self) -> np.ndarray:
        return self.pos3[:, 2].astype(np.float64)

    def indices(self):
        if self._idx is None:
            bw, bh = TransformType.SELECT_SIZE[self.sel]
            h, w = bh * 8, bw * 8
            _, pw = self.plane_shape
            _, lw = self.lf_shape
            pos = self.pos3
            dy = np.arange(h)[:, None]
            dx = np.arange(w)[None, :]
            rows = pos[:, 1, None, None] * 8 + dy
            cols = pos[:, 0, None, None] * 8 + dx
            coeff_idx = (rows * pw + cols).astype(np.int32)
            ldy = np.arange(bh)[:, None]
            ldx = np.arange(bw)[None, :]
            lrows = pos[:, 1, None, None] + ldy
            lcols = pos[:, 0, None, None] + ldx
            lf_idx = (lrows * lw + lcols).astype(np.int32)
            self._idx = (coeff_idx, lf_idx)
        return self._idx


import threading as _threading

# Plane pool: recycling one frame's coefficient/LF planes between decodes
# turns the fresh-mmap page faults of a big allocation into a parallel
# memset of already-resident pages. Entries are
# recycled ONLY by trim_coeff_planes after a fused decode whose device
# inputs were copies (coeff/lf stacks), so no live view or zero-copy
# device buffer can alias a recycled plane. Capped; JXL_TPU_PLANE_POOL=0
# disables.
_PLANE_POOL: dict = {}
_PLANE_POOL_LOCK = _threading.Lock()
_PLANE_POOL_CAP = 512 << 20


def _pool_acquire(shapes):
    import os

    from .. import native as _native

    key = tuple(shapes)
    if os.environ.get("JXL_TPU_PLANE_POOL") == "0":
        return _native.zeroed_planes(list(shapes))
    with _PLANE_POOL_LOCK:
        arrs = _PLANE_POOL.pop(key, None)
    if arrs is None:
        return _native.zeroed_planes(list(shapes))
    lib = _native.get_lib()
    if lib is not None and hasattr(lib, "jxlhost_memzero_batch"):
        import ctypes

        from ..utils.threads import num_workers

        n = len(arrs)
        ptrs = (ctypes.c_void_p * n)()
        sizes = np.zeros(n, dtype=np.uint64)
        for i, a in enumerate(arrs):
            ptrs[i] = a.ctypes.data
            sizes[i] = a.nbytes
        lib.jxlhost_memzero_batch(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int32(n),
            ctypes.c_int32(num_workers(max(1, int(sizes.sum()) >> 22))),
        )
    else:
        for a in arrs:
            a[...] = 0
    return arrs


def _pool_release(arrays) -> None:
    import os

    if os.environ.get("JXL_TPU_PLANE_POOL") == "0" or not arrays:
        return
    key = tuple(a.shape for a in arrays)
    nbytes = sum(a.nbytes for a in arrays)
    with _PLANE_POOL_LOCK:
        total = sum(
            sum(a.nbytes for a in v) for v in _PLANE_POOL.values()
        )
        if total + nbytes <= _PLANE_POOL_CAP:
            _PLANE_POOL[key] = arrays


def _sparse_upload_enabled() -> bool:
    """Sparse (index, value) coefficient uploads send fewer bytes at the
    cost of an on-device scatter. The size rule in fused_program_parts is
    the JAX package's, so both host stages hand over the same inputs;
    JXL_TPU_SPARSE_UPLOAD=0 forces dense uploads."""
    import os

    return os.environ.get("JXL_TPU_SPARSE_UPLOAD") != "0"


def _pack_sparse_upload(idx_buf, val_buf, nz_count, max_abs,
                        sparse_n: int, size: int):
    """(c_idx, c_val) sparse coefficient upload from the native
    extractor's ascending-unique output: pow2-padded to `sparse_n`,
    values narrowed to i8/i16 when they fit, and indices as u16 DELTAS
    when every gap fits (reconstructed by an on-device cumsum; +1 pads
    continue ascending — zero writes into already-zero positions or OOB
    drops) or as absolute i32 with ascending OUT-OF-BOUNDS pads."""
    if idx_buf.size < sparse_n:
        idx_buf = np.resize(idx_buf, sparse_n)
        val_buf = np.resize(val_buf, sparse_n)
    nz_n = min(int(nz_count), sparse_n)
    vals = val_buf[:sparse_n].copy()
    vals[nz_n:] = 0
    c_val = (
        vals.astype(np.int8) if max_abs < 128
        else vals.astype(np.int16) if max_abs < 32768
        else vals
    )
    c_idx = None
    if nz_n:
        real = idx_buf[:nz_n].astype(np.int64)
        deltas = np.empty(sparse_n, dtype=np.int64)
        deltas[0] = real[0] + 1
        deltas[1:nz_n] = np.diff(real)
        deltas[nz_n:] = 1
        if deltas[:nz_n].max() <= 0xFFFF:
            c_idx = deltas.astype(np.uint16)
    if c_idx is None:
        c_idx = idx_buf[:sparse_n].copy()
        c_idx[nz_n:] = size + np.arange(sparse_n - nz_n, dtype=np.int32)
    return c_idx, c_val


def _release_cell(cell) -> None:
    """weakref.finalize target: return a state's remaining tracked bytes
    to its AllocTracker exactly once (trim may have returned part already)."""
    tracker = cell.get("tracker")
    if tracker is not None:
        tracker.release(cell["n"])
    cell["n"] = 0


class VardctFrameState:
    """Whole-frame VarDCT decode state: LF planes, coefficient planes, and
    per-frame varblock plan feeding the device pipeline."""

    def __init__(self, frame, pooled: bool = True):
        self.frame = frame
        header = frame.header
        self.header = header
        meta = frame.image_header.metadata

        self.width = header.sample_width()
        self.height = header.sample_height()
        jpeg_upsampling = header.jpeg_upsampling
        self.shifts = jpeg_shifts(jpeg_upsampling)
        self.subsampled = any(j != 0 for j in jpeg_upsampling)

        bw = _ceil_div(self.width, 8)
        bh = _ceil_div(self.height, 8)
        h_up = any(j in (1, 2) for j in jpeg_upsampling)
        v_up = any(j in (1, 3) for j in jpeg_upsampling)
        if h_up:
            bw = _ceil_div(bw, 2) * 2
        if v_up:
            bh = _ceil_div(bh, 2) * 2
        self.width_rounded = bw * 8
        self.height_rounded = bh * 8

        # Per-channel (x, y, b) shifted plane geometry.
        self.plane_shapes = []
        self.lf_shapes = []
        for hs, vs in self.shifts:
            self.plane_shapes.append(
                (_ceil_shift(bh, vs) * 8, _ceil_shift(bw, hs) * 8)
            )
            self.lf_shapes.append((_ceil_shift(bh, vs), _ceil_shift(bw, hs)))

        from ..utils.alloc import current_tracker, track_alloc

        # exact plane bytes, returned to the budget when the state is
        # dropped — alloc_tracker.rs drop semantics via weakref.finalize
        nbytes = sum(4 * h_ * w_ for h_, w_ in self.plane_shapes) + sum(
            4 * h_ * w_ for h_, w_ in self.lf_shapes
        )
        track_alloc(nbytes)
        tracker = current_tracker()
        self._alloc_cell = {"n": nbytes, "tracker": tracker}
        if tracker is not None:
            import weakref

            weakref.finalize(self, _release_cell, self._alloc_cell)
        # pre-faulted parallel zero-fill (pooled: recycled pages skip the
        # page faults entirely): a fresh 1024^2 frame allocates ~16 MB of
        # coefficient planes, and lazy calloc pages would fault serially
        # inside the decode's write path. An unpooled state (the JPEG
        # reconstruction's, which keeps its planes) takes fresh ones
        if pooled:
            self.lf_quant_planes = _pool_acquire(tuple(self.lf_shapes))
            self.coeff_planes = _pool_acquire(tuple(self.plane_shapes))
        else:
            from .. import native as _native

            self.lf_quant_planes = _native.zeroed_planes(list(self.lf_shapes))
            self.coeff_planes = _native.zeroed_planes(
                list(self.plane_shapes))
        # set by the fused 4:4:4 path, whose device inputs are COPIES of
        # the planes; gates recycling in trim_coeff_planes
        self._planes_poolable = False
        self.extra_precision = 0
        self.filters_applied = False
        # fused subsampled path: planes already at full resolution
        # (chroma upsample fused into the device program)
        self.chroma_upsampled = False
        # LF planes handed down from a rendered LF frame (use_lf_frame,
        # render/context.py): colour planes on the decode device
        self.lf_override = getattr(frame, "_lf_frame_planes", None)
        self.lf_groups: dict[int, LfGroup] = {}
        self.opsin = meta.opsin_inverse_matrix

    def trim_coeff_planes(self) -> None:
        """Drop the int32 coefficient / LF-quant planes once the device
        pipeline has consumed them, returning their bytes to the budget
        (alloc_tracker.rs drop-on-last-use)."""
        if self.coeff_planes is None:
            return
        freed = sum(p.nbytes for p in self.coeff_planes)
        freed += sum(p.nbytes for p in self.lf_quant_planes)
        if self._planes_poolable:
            # release under the same keys the split acquire used
            _pool_release(self.coeff_planes)
            _pool_release(self.lf_quant_planes)
        self.coeff_planes = None
        self.lf_quant_planes = None
        cell = self._alloc_cell
        take = min(freed, cell["n"])
        cell["n"] -= take
        tracker = cell.get("tracker")
        if tracker is not None:
            tracker.release(take)

    # -- LF group assembly --------------------------------------------------

    def place_lf_group(self, lf_group_idx: int, group: LfGroup) -> None:
        self.lf_groups[lf_group_idx] = group
        header = self.header
        if group.lf_coeff is None:
            return
        lf_per_row = header.lf_groups_per_row
        gx = lf_group_idx % lf_per_row
        gy = lf_group_idx // lf_per_row
        base_x = gx * header.group_dim  # LF-plane samples (= blocks)
        base_y = gy * header.group_dim
        self.extra_precision = group.lf_coeff.extra_precision
        for c, chan in enumerate(group.lf_coeff.lf_quant_xyb()):
            hs, vs = self.shifts[c]
            y0 = base_y >> vs
            x0 = base_x >> hs
            h, w = chan.shape
            self.lf_quant_planes[c][y0 : y0 + h, x0 : x0 + w] = chan

    # -- pass group decode --------------------------------------------------

    def group_plane_views(self, group_idx: int):
        """Per-channel coefficient plane views for one 256x256 group."""
        header = self.header
        gpr = header.groups_per_row
        gx, gy = group_idx % gpr, group_idx // gpr
        gdim = header.group_dim
        views = []
        for c in range(3):
            hs, vs = self.shifts[c]
            x0 = (gx * gdim) >> hs
            y0 = (gy * gdim) >> vs
            ph, pw = self.plane_shapes[c]
            w = min(gdim >> hs, pw - x0)
            h = min(gdim >> vs, ph - y0)
            views.append(self.coeff_planes[c][y0 : y0 + h, x0 : x0 + w])
        return views

    def group_block_grids(self, group_idx: int):
        """(block_sel, block_mul, lf_quant_views) slices for one group."""
        header = self.header
        gpr = header.groups_per_row
        gx, gy = group_idx % gpr, group_idx // gpr
        lf_group_idx = header.lf_group_idx_from_group_idx(group_idx)
        lf_group = self.lf_groups.get(lf_group_idx)
        if lf_group is None or lf_group.hf_meta is None:
            return None
        hf_meta = lf_group.hf_meta
        gdb = header.group_dim // 8
        left = (gx % 8) * gdb
        top = (gy % 8) * gdb
        bh, bw = hf_meta.block_sel.shape
        w = min(bw - left, gdb)
        h = min(bh - top, gdb)
        sel = hf_meta.block_sel[top : top + h, left : left + w]
        mul = hf_meta.block_mul[top : top + h, left : left + w]

        lf_quant = None
        if lf_group.lf_coeff is not None:
            lfg_per_row = header.lf_groups_per_row
            lgx = lf_group_idx % lfg_per_row
            lgy = lf_group_idx // lfg_per_row
            lf_quant = []
            for c in range(3):
                hs, vs = self.shifts[c]
                x0 = ((lgx * header.group_dim) >> hs) + (left >> hs)
                y0 = ((lgy * header.group_dim) >> vs) + (top >> vs)
                lf_quant.append(
                    self.lf_quant_planes[c][
                        y0 : y0 + _ceil_shift(h, vs), x0 : x0 + _ceil_shift(w, hs)
                    ]
                )
        return sel, mul, lf_quant

    def decode_pass_group_hf(
        self, bs: Bitstream, hf_global: HfGlobal, pass_idx: int, group_idx: int
    ) -> None:
        grids = self.group_block_grids(group_idx)
        if grids is None:
            return
        sel, mul, lf_quant = grids
        header = self.header
        lf_vardct = self.frame.lf_global.vardct
        coeff_shift = header.passes.pass_shift(pass_idx)
        write_hf_coeff(
            bs,
            num_hf_presets=hf_global.num_hf_presets,
            hf_block_ctx=lf_vardct.hf_block_ctx,
            block_sel=sel,
            block_mul=mul,
            jpeg_upsampling=header.jpeg_upsampling,
            lf_quant=lf_quant,
            hf_pass=hf_global.hf_passes[pass_idx],
            coeff_shift=coeff_shift,
            hf_coeff_output=self.group_plane_views(group_idx),
        )

    # -- host-built inputs of the device stage -----------------------------

    def _cfl_grids(self):
        """Frame-wide per-64x64 CfL integer grids (x_from_y, b_from_y)."""
        header = self.header
        w64 = _ceil_div(self.width_rounded, 64)
        h64 = _ceil_div(self.height_rounded, 64)
        x_grid = np.zeros((h64, w64), dtype=np.int32)
        b_grid = np.zeros((h64, w64), dtype=np.int32)
        lfg_per_row = header.lf_groups_per_row
        for lf_group_idx, group in self.lf_groups.items():
            if group.hf_meta is None:
                continue
            gx = lf_group_idx % lfg_per_row
            gy = lf_group_idx // lfg_per_row
            x0 = gx * (header.lf_group_dim // 64)
            y0 = gy * (header.lf_group_dim // 64)
            gh, gw = group.hf_meta.x_from_y.shape
            x_grid[y0 : y0 + gh, x0 : x0 + gw] = group.hf_meta.x_from_y
            b_grid[y0 : y0 + gh, x0 : x0 + gw] = group.hf_meta.b_from_y
        return x_grid, b_grid

    def _sigma_blocks_grid(self) -> np.ndarray:
        """Full-resolution per-8x8-block EPF sigma grid assembled from the
        per-LF-group HfMetadata grids."""
        header = self.header
        rf = header.restoration_filter
        bh_all = -(-self.height_rounded // 8)
        bw_all = -(-self.width_rounded // 8)
        sigma_blocks = np.full(
            (bh_all, bw_all),
            rf.epf.sigma_for_modular if rf.epf.enabled else 0.0,
            dtype=np.float32,
        )
        lfg_per_row = header.lf_groups_per_row
        for lf_group_idx, group in self.lf_groups.items():
            if group.hf_meta is None:
                continue
            gx = lf_group_idx % lfg_per_row
            gy = lf_group_idx // lfg_per_row
            sg = group.hf_meta.epf_sigma
            sy0 = gy * header.group_dim
            sx0 = gx * header.group_dim
            sh_ = sigma_blocks[sy0 : sy0 + sg.shape[0], sx0 : sx0 + sg.shape[1]]
            sh_[:, :] = sg[: sh_.shape[0], : sh_.shape[1]]
        return sigma_blocks

    def build_dequant_maps(self, hf_global: HfGlobal | None, x_qm_scale,
                           b_qm_scale):
        """Per-channel full-plane dequant multiplier maps
        (dequant_hf_varblock_grouped, vardct/mod.rs:443-541), built by
        vectorized scatter over the per-type bucket index plans."""
        if hf_global is None:
            return [np.zeros(self.plane_shapes[c], dtype=np.float32)
                    for c in range(3)]
        quantizer = self.frame.lf_global.vardct.quantizer
        qm_scale = [
            0.8 ** (x_qm_scale - 2),
            1.0,
            0.8 ** (b_qm_scale - 2),
        ]
        maps = []
        for c in range(3):
            dmap = np.zeros(self.plane_shapes[c], dtype=np.float32)
            flat = dmap.reshape(-1)
            for b in self.buckets(c):
                matrix = hf_global.dequant_matrices.get(
                    c, b.sel, TransformType.need_transpose(b.sel)
                )
                base = 65536.0 / quantizer.global_scale * qm_scale[c]
                vals = matrix[None, :, :] * (base / b.muls)[:, None, None]
                coeff_idx = b.indices()[0]
                flat[coeff_idx.reshape(-1)] = vals.reshape(-1).astype(np.float32)
            maps.append(dmap)
        return maps

    def build_cfl_maps(self):
        """Full-resolution kx/kb maps from the per-64x64 CfL grids
        (chroma_from_luma_hf_grouped)."""
        corr = self.frame.lf_global.vardct.lf_chan_corr
        h, w = self.plane_shapes[0]
        x_grid, b_grid = self._cfl_grids()
        kx = corr.base_correlation_x + x_grid.astype(np.float32) / corr.colour_factor
        kb = corr.base_correlation_b + b_grid.astype(np.float32) / corr.colour_factor
        kx_map = np.repeat(np.repeat(kx, 64, axis=0), 64, axis=1)[:h, :w]
        kb_map = np.repeat(np.repeat(kb, 64, axis=0), 64, axis=1)[:h, :w]
        return np.ascontiguousarray(kx_map), np.ascontiguousarray(kb_map)

    def buckets(self, channel: int) -> "list[_Bucket]":
        """Cached per-transform-type varblock buckets for one channel.
        Gather/scatter index plans materialize lazily (_Bucket.indices):
        the fused pipeline only needs positions + multipliers, and the
        index arrays are O(n * block_area) memory."""
        cache = getattr(self, "_bucket_cache", None)
        if cache is None:
            cache = self._bucket_cache = {}
        if channel in cache:
            return cache[channel]
        ph, pw = self.plane_shapes[channel]
        lh, lw = self.lf_shapes[channel]
        per_type: dict[int, list] = {}
        # vectorized: pull (x, y, sel, mul) arrays straight off the
        # per-LF-group grids instead of iterating blocks in Python; a
        # subsampled channel keeps only lattice-aligned varblocks whose
        # shifted position also holds an anchor (_iter_varblocks rule,
        # for_each_varblocks vardct/mod.rs:687-730)
        header = self.header
        lfg_per_row = header.lf_groups_per_row
        hs, vs = self.shifts[channel]
        parts = []
        for lf_group_idx, group in self.lf_groups.items():
            if group.hf_meta is None:
                continue
            base_x = (lf_group_idx % lfg_per_row) * header.group_dim
            base_y = (lf_group_idx // lfg_per_row) * header.group_dim
            sel_grid = group.hf_meta.block_sel
            ys, xs = np.nonzero(sel_grid >= 0)
            if hs or vs:
                sbx = xs >> hs
                sby = ys >> vs
                keep = ((sbx << hs) == xs) & ((sby << vs) == ys)
                # the shifted-anchor existence check is PASS-GROUP-local
                # (dequant_hf_varblock_grouped operates on the group
                # subgrid, vardct/mod.rs:487-497): check cell =
                # group_base + (local >> shift), not position >> shift
                gdb = header.group_dim // 8
                cgx = (xs // gdb) * gdb
                cgy = (ys // gdb) * gdb
                keep &= sel_grid[cgy + ((ys - cgy) >> vs),
                                 cgx + ((xs - cgx) >> hs)] >= 0
                xs_c, ys_c = sbx[keep], sby[keep]
                sels = sel_grid[ys[keep], xs[keep]].astype(np.int64)
                muls = group.hf_meta.block_mul[ys[keep], xs[keep]].astype(
                    np.int64)
            else:
                xs_c, ys_c = xs, ys
                sels = sel_grid[ys, xs].astype(np.int64)
                muls = group.hf_meta.block_mul[ys, xs].astype(np.int64)
            parts.append((
                xs_c.astype(np.int64) + (base_x >> hs),
                ys_c.astype(np.int64) + (base_y >> vs),
                sels,
                muls,
            ))
        if parts:
            xs = np.concatenate([p[0] for p in parts])
            ys = np.concatenate([p[1] for p in parts])
            sels = np.concatenate([p[2] for p in parts])
            muls = np.concatenate([p[3] for p in parts])
            for sel in np.unique(sels):
                m = sels == sel
                per_type[int(sel)] = np.stack(
                    [xs[m], ys[m], muls[m]], axis=1
                )
        buckets = []
        for sel, entries in sorted(per_type.items()):
            pos = np.asarray(entries, dtype=np.int64)  # [n, 3]
            buckets.append(_Bucket(int(sel), pos, (ph, pw), (lh, lw)))
        cache[channel] = buckets
        return buckets

    @staticmethod
    def dense_plan(buckets, lf_shape):
        """Dense transform plan from per-type varblock buckets: entry
        list (sel, oy, ox) keyed by block-offset residue class, plus the
        anchor entry-id grid and hf_mul grid consumed by
        ops.vardct_pipeline.dense_transform_channels."""
        bh_g, bw_g = lf_shape
        code = np.full((bh_g, bw_g), -1, dtype=np.int16)
        mul = np.ones((bh_g, bw_g), dtype=np.float32)
        entries: list[tuple[int, int, int]] = []
        eidx: dict[tuple[int, int, int], int] = {}
        for b in buckets:
            tw, th = TransformType.SELECT_SIZE[b.sel]
            p = b.pos3
            if not len(p):
                continue
            x = p[:, 0].astype(np.int64)
            y = p[:, 1].astype(np.int64)
            # drop malformed anchors outside the grid (the parser bounds
            # these for valid streams; fuzz streams may not)
            ok = (x >= 0) & (y >= 0) & (x < bw_g) & (y < bh_g)
            x, y, m = x[ok], y[ok], p[ok, 2]
            res = (y % th) * tw + (x % tw)
            for r in np.unique(res):
                key = (b.sel, int(r) // tw, int(r) % tw)
                eid = eidx.get(key)
                if eid is None:
                    eid = len(entries)
                    eidx[key] = eid
                    entries.append(key)
                sel_m = res == r
                code[y[sel_m], x[sel_m]] = eid
            mul[y, x] = m.astype(np.float32)
        return tuple(entries), code, mul

    def build_transform_buckets(self, channel: int):
        """Gather/scatter index plans (without muls), for the staged
        path."""
        out = []
        for b in self.buckets(channel):
            ci, li = b.indices()
            out.append((b.sel, ci, li, ci))
        return out

    # -- device stage -------------------------------------------------------

    def padded_lf_override(self) -> list:
        """The LF frame's colour planes (device tensors, `lf_override`) as
        this frame's LF: each cut to its channel's LF shape, or
        edge-padded to it on the planes' device (rows below repeat the
        last row, then columns to the right the last column, as the JAX
        package pads in numpy, render/vardct.py:806-814). One pad per
        channel and frame; nothing goes to the host."""
        out = []
        for c in range(3):
            lh, lw = self.lf_shapes[c]
            src = self.lf_override[c].to(torch.float32)
            sh, sw = min(src.shape[0], lh), min(src.shape[1], lw)
            p = src[:sh, :sw]
            if (sh, sw) != (lh, lw):
                p = torch.nn.functional.pad(
                    p[None, None], (0, lw - sw, 0, lh - sh),
                    mode="replicate")[0, 0]
            out.append(p.contiguous())
        return out

    def run_device_pipeline(self, hf_global: HfGlobal | None, device,
                            rect=None):
        """Dequant -> CfL -> inverse transforms (and, on the fused paths,
        the filters), on `device`. Returns [x, y, b] float32 planes: at
        frame sample size from the fused 4:4:4 program, at full
        resolution (still YCbCr) from the fused subsampled one, at the
        shifted rounded plane sizes from the staged path. The flags
        filters_applied and chroma_upsampled say which; both are reset
        first, since a cached loading frame's state runs this again and
        may take another path as its plan grows. `rect` (x0, y0, x1, y1),
        group-aligned in full-resolution plane pixels (render/roi.py
        `device_rect`), restricts a fused program to that rect, embedded
        at its place in zero planes of the usual size; the staged path
        computes the whole planes (its output is cropped to the region
        later, as the JAX package's is).

        Subsampled frames never carry adaptive LF smoothing (rejected at
        FrameHeader.parse) or an LF-frame override (jpeg_upsampling is only
        coded when !use_lf_frame, header.rs:25).

        Under a decode mesh (parallel/ use_decode_mesh) both fused paths
        run sharded over it, on `device` = the mesh's home device, and
        `rect` is ignored (jxl_oxide_tpu/render/vardct.py:756-770)."""
        from ..parallel import get_decode_mesh

        self.filters_applied = False
        self.chroma_upsampled = False
        mesh = get_decode_mesh()
        if self.subsampled:
            assert self.lf_override is None
        if mesh is not None:
            if not self.subsampled:
                return self._run_fused_sharded(hf_global, mesh)
            return self._run_fused_subsampled_sharded(hf_global, mesh)
        if not self.subsampled:
            return self._run_fused(hf_global, device, rect)
        return self._run_fused_subsampled(hf_global, device, rect)

    _fused_cache: dict = {}
    # programs built by `program` since import (a loading frame's key can
    # change as its LF groups arrive; chip_smoke.py counts a feed's builds)
    program_builds = 0

    @classmethod
    def program(cls, key, make_fn, device):
        """The fused program of `key` on `device`, built by make_fn(device)
        once per key and device in the class-wide cache, which the
        per-image and the stacked decodes share."""
        dev_key = (key, str(device))
        fn = cls._fused_cache.get(dev_key)
        if fn is None:
            fn = make_fn(device)
            VardctFrameState.program_builds += 1
            if len(cls._fused_cache) > 32:
                cls._fused_cache.clear()
            cls._fused_cache[dev_key] = fn
        return fn

    def _fused_host_inputs(self, hf_global: HfGlobal | None, rect=None):
        """Host-assembled inputs of the fused pipeline.

        rect = (x0, y0, x1, y1) in plane pixels (group-aligned origin,
        ends clamped to the plane): every grid input is sliced to the
        rect and bucket positions rebase to its origin, so the device
        program computes only the region (ROI pushdown past the host
        stage, jxl-render/src/region.rs semantics)."""
        header = self.header
        quantizer = self.frame.lf_global.vardct.quantizer
        lf_dequant = self.frame.lf_global.lf_dequant
        corr = self.frame.lf_global.vardct.lf_chan_corr

        scale_inv = quantizer.global_scale * quantizer.quant_lf
        precision_scale = 1 << (9 - self.extra_precision)
        lf_scale_arr = np.array(
            [lf_dequant[c] * precision_scale / scale_inv for c in range(3)],
            dtype=np.float32,
        )
        lf_smooth_scale = tuple(
            np.float32(512.0 * lf_dequant[c] / scale_inv) for c in range(3)
        )
        kx = corr.base_correlation_x + (corr.x_factor_lf - 128) / corr.colour_factor
        kb = corr.base_correlation_b + (corr.b_factor_lf - 128) / corr.colour_factor

        skip_smoothing = header.flags.skip_adaptive_lf_smoothing
        lf_override = None
        if self.lf_override is not None:
            # LF comes pre-dequantized from the LF frame: identity scale,
            # no LF CfL, no smoothing (vardct/mod.rs:176-182)
            lf_override = torch.stack(self.padded_lf_override())
            lf_scale_arr = np.ones(3, dtype=np.float32)
            kx, kb = 0.0, 0.0
            skip_smoothing = True

        buckets = self.buckets(0)
        matrices = {}
        qm_scale = (
            0.8 ** (header.x_qm_scale - 2),
            1.0,
            0.8 ** (header.b_qm_scale - 2),
        )
        for sel in (b.sel for b in buckets):
            if hf_global is not None:
                matrices[sel] = np.stack([
                    hf_global.dequant_matrices.get(
                        c, sel, TransformType.need_transpose(sel)
                    )
                    for c in range(3)
                ])
            else:
                bw, bh = TransformType.SELECT_SIZE[sel]
                matrices[sel] = np.zeros((3, bh * 8, bw * 8), dtype=np.float32)

        rf = header.restoration_filter
        gabor_weights = tuple(map(tuple, rf.gab.weights)) if rf.gab.enabled else None
        epf_params = rf.epf if rf.epf.enabled else None

        # frame-wide CfL integer grids + EPF sigma blocks
        x_grid, b_grid = self._cfl_grids()
        sigma_blocks = self._sigma_blocks_grid()

        if rect is not None:
            x0, y0, x1, y1 = rect
            coeff_stack = np.stack(
                [p[y0:y1, x0:x1] for p in self.coeff_planes]
            )
            if lf_override is not None:
                lf_input = lf_override[:, y0 // 8 : -(-y1 // 8),
                                       x0 // 8 : -(-x1 // 8)].contiguous()
            else:
                lf_input = np.stack([
                    p[y0 // 8 : -(-y1 // 8), x0 // 8 : -(-x1 // 8)]
                    for p in self.lf_quant_planes
                ])
            x_grid = np.ascontiguousarray(
                x_grid[y0 // 64 : -(-y1 // 64), x0 // 64 : -(-x1 // 64)]
            )
            b_grid = np.ascontiguousarray(
                b_grid[y0 // 64 : -(-y1 // 64), x0 // 64 : -(-x1 // 64)]
            )
            sigma_blocks = np.ascontiguousarray(
                sigma_blocks[y0 // 8 : -(-y1 // 8), x0 // 8 : -(-x1 // 8)]
            )
            bx0, by0 = x0 // 8, y0 // 8
            bx1, by1 = -(-x1 // 8), -(-y1 // 8)
            rect_shape = (y1 - y0, x1 - x0)
            rect_lf = (-(-(y1 - y0) // 8), -(-(x1 - x0) // 8))
            rbuckets = []
            for b in buckets:
                p3 = b.pos3
                m = (
                    (p3[:, 0] >= bx0) & (p3[:, 0] < bx1)
                    & (p3[:, 1] >= by0) & (p3[:, 1] < by1)
                )
                if m.any():
                    sub = p3[m].copy()
                    sub[:, 0] -= bx0
                    sub[:, 1] -= by0
                    rbuckets.append(_Bucket(b.sel, sub, rect_shape, rect_lf))
            buckets = rbuckets
        else:
            coeff_stack = np.stack(self.coeff_planes)
            lf_input = (lf_override if lf_override is not None
                        else np.stack(self.lf_quant_planes))
        return dict(
            quantizer=quantizer,
            lf_scale_arr=lf_scale_arr,
            lf_smooth_scale=lf_smooth_scale,
            kx=kx, kb=kb,
            skip_smoothing=skip_smoothing,
            buckets=buckets,
            matrices=matrices,
            qm_scale=qm_scale,
            gabor_weights=gabor_weights,
            epf_params=epf_params,
            x_grid=x_grid, b_grid=b_grid,
            sigma_blocks=sigma_blocks,
            coeff_stack=coeff_stack,
            lf_input=lf_input,
            corr=corr,
        )

    def fused_program_parts(self, hf_global: HfGlobal | None, rect=None):
        """(key, make_fn, inputs) for the single-device fused program, or
        None when the dense plan overflows (the staged path). `inputs` are
        host numpy arrays, bit-identical to the JAX package's;
        make_fn(device) builds the torch program for one device."""
        from ..ops.vardct_pipeline import build_fused_pipeline

        hi = self._fused_host_inputs(hf_global, rect=rect)
        if rect is not None:
            rx0, ry0, rx1, ry1 = rect
            plane_shape = (ry1 - ry0, rx1 - rx0)
            lf_shape = (-(-(ry1 - ry0) // 8), -(-(rx1 - rx0) // 8))
            embed = (self.plane_shapes[0][0], self.plane_shapes[0][1],
                     ry0, rx0)
        else:
            plane_shape = self.plane_shapes[0]
            lf_shape = self.lf_shapes[0]
            embed = None
        quantizer = hi["quantizer"]
        corr = hi["corr"]
        buckets = hi["buckets"]
        matrices = hi["matrices"]
        qm_scale = hi["qm_scale"]
        kx, kb = hi["kx"], hi["kb"]
        skip_smoothing = hi["skip_smoothing"]
        lf_smooth_scale = hi["lf_smooth_scale"]
        gabor_weights = hi["gabor_weights"]
        epf_params = hi["epf_params"]
        coeff_stack = hi["coeff_stack"]
        # dense transform plan: the program key depends only on the set of
        # (type, block-offset residue) entries present, so decodes of
        # DIFFERENT images with the same plane geometry and plan share one
        # program (and its device constants) regardless of block counts
        entries, code_grid, mul_grid = self.dense_plan(buckets, lf_shape)
        if len(entries) > DENSE_PLAN_MAX_ENTRIES:
            # Each entry is a full-plane dense pass: a stream that
            # staggers large transforms across hundreds of block-offset
            # residue classes (valid but pathological, incl. adversarial
            # inputs) would run hundreds of passes. The staged gather
            # path's work is bounded by the 27 transform types instead.
            return None

        # sparse coefficient upload when it beats dense int16 (quantized
        # HF coefficients are mostly zero); padded to pow2 to bound the
        # number of compiled program shapes. The native runtime extracts
        # indices/values and the max |coeff| in ONE pass over the planes.
        from .. import native as _native

        dense_bytes = coeff_stack.size * 2
        sparse_n = None
        nz_flat = None
        idx_buf = val_buf = None
        max_abs = None
        if _native.available():
            flat = np.ascontiguousarray(coeff_stack.reshape(-1))
            cap = max(coeff_stack.size // 6, 1024)
            idx_buf = np.zeros(cap, dtype=np.int32)
            val_buf = np.zeros(cap, dtype=np.int32)
            nz_count, max_abs = _native.sparse_extract(flat, idx_buf, val_buf)
            if nz_count * 6 < dense_bytes // 2 and _sparse_upload_enabled():
                sparse_n = 1 << max(10, int(nz_count - 1).bit_length())
        else:
            nz_flat = np.flatnonzero(coeff_stack.reshape(-1))
            if nz_flat.size * 6 < dense_bytes // 2 and _sparse_upload_enabled():
                sparse_n = 1 << max(10, int(nz_flat.size - 1).bit_length())

        # constant CfL factor maps (all-zero correlation grids): the
        # pipeline folds the factors to scalars — no [H, W] maps
        cfl_const = bool(
            not np.asarray(hi["x_grid"]).any()
            and not np.asarray(hi["b_grid"]).any()
        )
        key = (
            sparse_n, cfl_const,
            plane_shape, lf_shape, embed, entries,
            tuple(float(q) for q in self.opsin.quant_bias),
            float(self.opsin.quant_bias_numerator),
            quantizer.global_scale, qm_scale, lf_smooth_scale,
            skip_smoothing,
            (float(kx), float(kb)),
            corr.colour_factor,
            (corr.base_correlation_x, corr.base_correlation_b),
            gabor_weights,
            (epf_params.iters, epf_params.sharp_lut, epf_params.channel_scale,
             epf_params.pass0_sigma_scale, epf_params.pass2_sigma_scale,
             epf_params.border_sad_mul) if epf_params else None,
            tuple(sorted((sel, m.tobytes()) for sel, m in matrices.items())),
            (self.height, self.width),
        )
        def make_fn(device=None):
            return build_fused_pipeline(
                plane_shape, lf_shape, entries,
                matrices,
                tuple(float(q) for q in self.opsin.quant_bias),
                float(self.opsin.quant_bias_numerator),
                quantizer.global_scale, qm_scale, lf_smooth_scale,
                skip_smoothing,
                cfl_lf_k=(float(kx), float(kb)),
                cfl_colour_factor=corr.colour_factor,
                cfl_base=(corr.base_correlation_x, corr.base_correlation_b),
                gabor_weights=gabor_weights,
                epf_params=epf_params,
                sparse_coeff_n=sparse_n,
                crop=(self.height, self.width),
                embed=embed,
                cfl_const=cfl_const,
                device=device,
            )

        if sparse_n is not None:
            # packed by _pack_sparse_upload (pow2 pads, i8/i16 value
            # narrowing, u16 index deltas when gaps fit)
            size = coeff_stack.size
            if idx_buf is not None:
                c_idx, c_val = _pack_sparse_upload(
                    idx_buf, val_buf, nz_count, max_abs, sparse_n, size
                )
            else:
                c_idx = np.empty(sparse_n, dtype=np.int32)
                c_idx[: nz_flat.size] = nz_flat
                c_idx[nz_flat.size:] = size + np.arange(
                    sparse_n - nz_flat.size, dtype=np.int32
                )
                vals = coeff_stack.reshape(-1)[nz_flat]
                c_val = np.zeros(
                    sparse_n,
                    dtype=np.int16
                    if np.abs(vals).max(initial=0) < 32768
                    else np.int32,
                )
                c_val[: nz_flat.size] = vals
            coeff_input = (c_idx, c_val)
        else:
            if max_abs is None:
                max_abs = int(np.abs(coeff_stack).max(initial=0))
            if max_abs < 32768:
                coeff_stack = coeff_stack.astype(np.int16)  # halve the upload
            coeff_input = coeff_stack
        inputs = [
            coeff_input, hi["lf_input"], hi["lf_scale_arr"],
            hi["x_grid"], hi["b_grid"], hi["sigma_blocks"],
            code_grid, mul_grid,
        ]
        return key, make_fn, inputs

    def _run_program(self, make_parts, hf_global: HfGlobal | None, device,
                     rect=None):
        """One fused program: its host inputs (make_parts(hf_global,
        rect=rect)), ONE
        host-to-device copy of all of them (packed into one pinned staging
        buffer on a CUDA device), then the program, built once per key and
        device in the class-wide cache. Returns its three planes on
        `device`, or None when the dense plan overflows."""
        from ..ops.vardct_pipeline import upload_inputs

        with span("Fused program inputs"):
            parts = make_parts(hf_global, rect=rect)
        if parts is None:
            return None
        key, make_fn, inputs = parts
        fn = self.program(key, make_fn, device)
        with span("Upload"):
            placed = upload_inputs(inputs, device)
        with span("Fused program"):
            out = fn(*placed)
        self.filters_applied = True
        return [out[0], out[1], out[2]]

    @traced("Dequant and transform")
    def _run_fused(self, hf_global: HfGlobal | None, device, rect=None):
        """The fused 4:4:4 program (on `rect` only, if given), or the
        staged path when the dense plan overflows. Returns the [x, y, b]
        frame-size planes on `device`."""
        out = self._run_program(self.fused_program_parts, hf_global, device,
                                rect)
        if out is None:
            return self._run_staged(hf_global, device)
        self._planes_poolable = True  # its inputs were plane COPIES
        return out

    def _subsampled_channel_plans(self, hf_global: HfGlobal | None,
                                  rect=None, plan_shapes=None):
        """Per-channel (entries, code_grid, mul_grid, matrices) dense
        plans of the fused subsampled program, with the qm scales; None
        when a channel's plan overflows (the staged path). `rect`
        (full-resolution plane pixels, group-aligned origin) keeps each
        channel's blocks inside it, rebased to its origin at the channel's
        shift (jxl_oxide_tpu/render/vardct.py:1337-1374); `plan_shapes`
        overrides the block-grid shapes (the sharded program plans over
        the padded grid)."""
        header = self.header
        qm_scale = (
            0.8 ** (header.x_qm_scale - 2),
            1.0,
            0.8 ** (header.b_qm_scale - 2),
        )
        plans = []
        for c in range(3):
            buckets = self.buckets(c)
            lf_shape = self.lf_shapes[c]
            if rect is not None:
                hs, vs = self.shifts[c]
                x0, y0, x1, y1 = rect
                bx0, by0 = (x0 >> hs) // 8, (y0 >> vs) // 8
                bx1, by1 = -(-(x1 >> hs) // 8), -(-(y1 >> vs) // 8)
                rect_shape = ((y1 - y0) >> vs, (x1 - x0) >> hs)
                lf_shape = (by1 - by0, bx1 - bx0)
                rbuckets = []
                for b in buckets:
                    p3 = b.pos3
                    m = ((p3[:, 0] >= bx0) & (p3[:, 0] < bx1)
                         & (p3[:, 1] >= by0) & (p3[:, 1] < by1))
                    if m.any():
                        sub = p3[m].copy()
                        sub[:, 0] -= bx0
                        sub[:, 1] -= by0
                        rbuckets.append(_Bucket(b.sel, sub, rect_shape,
                                                lf_shape))
                buckets = rbuckets
            if plan_shapes is not None:
                lf_shape = plan_shapes[c]
            entries, code_grid, mul_grid = self.dense_plan(buckets, lf_shape)
            if len(entries) > DENSE_PLAN_MAX_ENTRIES:
                return None
            matrices = {}
            for b in buckets:
                sel = b.sel
                if hf_global is not None:
                    matrices[sel] = hf_global.dequant_matrices.get(
                        c, sel, TransformType.need_transpose(sel)
                    )
                else:
                    tw, th = TransformType.SELECT_SIZE[sel]
                    matrices[sel] = np.zeros((th * 8, tw * 8), dtype=np.float32)
            plans.append((entries, code_grid, mul_grid, matrices))
        return plans, qm_scale

    def fused_subsampled_program_parts(self, hf_global: HfGlobal | None,
                                       rect=None, copy_inputs: bool = False):
        """(key, make_fn, inputs) for the fused subsampled program, or
        None when the dense plan overflows (the staged path). `inputs`
        are host numpy arrays, bit-identical to the JAX package's (13 of
        them: per channel coefficients — a sparse (index, value) pair or
        a dense plane, chosen per channel —, LF, code and mul grids, then
        the sigma grid); make_fn(device) builds the torch program. With
        `rect` (full-resolution plane pixels, group-aligned), every input
        is cut to the rect at each channel's shift and the program embeds
        its output at the rect's place in zero planes
        (jxl_oxide_tpu/render/vardct.py:1394-1460). With copy_inputs,
        dense plane references are copied so that the caller may pool the
        state's planes."""
        header = self.header
        quantizer = self.frame.lf_global.vardct.quantizer
        lf_dequant = self.frame.lf_global.lf_dequant
        scale_inv = quantizer.global_scale * quantizer.quant_lf
        precision_scale = 1 << (9 - self.extra_precision)
        lf_scale = tuple(
            float(lf_dequant[c] * precision_scale / scale_inv)
            for c in range(3)
        )
        planned = self._subsampled_channel_plans(hf_global, rect=rect)
        if planned is None:
            return None
        plans, qm_scale = planned

        rf = header.restoration_filter
        gabor_weights = (
            tuple(map(tuple, rf.gab.weights)) if rf.gab.enabled else None
        )
        epf_params = rf.epf if rf.epf.enabled else None
        sigma_blocks = self._sigma_blocks_grid()
        if rect is not None:
            x0, y0, x1, y1 = rect
            full_shape = (y1 - y0, x1 - x0)
            embed = (self.height_rounded, self.width_rounded, y0, x0)
            plane_shapes = tuple(((y1 - y0) >> vs, (x1 - x0) >> hs)
                                 for hs, vs in self.shifts)
            sigma_blocks = np.ascontiguousarray(
                sigma_blocks[y0 // 8:-(-y1 // 8), x0 // 8:-(-x1 // 8)])
        else:
            full_shape = (self.height_rounded, self.width_rounded)
            embed = None
            plane_shapes = tuple(self.plane_shapes)
        entries3 = tuple(p[0] for p in plans)
        matrices3 = tuple(p[3] for p in plans)

        # per-channel sparse upload when it beats dense int16
        from .. import native as _native

        inputs = []
        sparse_ns = []
        for c in range(3):
            coeff = self.coeff_planes[c]
            lf_q = self.lf_quant_planes[c]
            if rect is not None:
                hs, vs = self.shifts[c]
                x0, y0, x1, y1 = rect
                coeff = np.ascontiguousarray(
                    coeff[y0 >> vs:y1 >> vs, x0 >> hs:x1 >> hs])
                lf_q = np.ascontiguousarray(
                    lf_q[(y0 >> vs) // 8:-(-(y1 >> vs) // 8),
                         (x0 >> hs) // 8:-(-(x1 >> hs) // 8)])
            sparse_n = None
            if _native.available():
                flat = np.ascontiguousarray(coeff.reshape(-1))
                cap = max(coeff.size // 6, 1024)
                idx_buf = np.zeros(cap, dtype=np.int32)
                val_buf = np.zeros(cap, dtype=np.int32)
                nz_count, max_abs = _native.sparse_extract(flat, idx_buf, val_buf)
                # dense int16 plane = size*2 bytes; sparse entry = 6
                # bytes worst case: go sparse under half the dense bytes
                if nz_count * 6 < coeff.size and _sparse_upload_enabled():
                    sparse_n = 1 << max(10, int(nz_count - 1).bit_length())
                    coeff_input = _pack_sparse_upload(
                        idx_buf, val_buf, nz_count, max_abs, sparse_n,
                        coeff.size,
                    )
                elif max_abs < 32768:
                    coeff_input = coeff.astype(np.int16)
                else:
                    coeff_input = coeff.copy() if copy_inputs else coeff
            elif np.abs(coeff).max(initial=0) < 32768:
                coeff_input = coeff.astype(np.int16)
            else:
                coeff_input = coeff.copy() if copy_inputs else coeff
            sparse_ns.append(sparse_n)
            if copy_inputs and lf_q is self.lf_quant_planes[c]:
                lf_q = lf_q.copy()
            inputs.extend([coeff_input, lf_q, plans[c][1], plans[c][2]])
        inputs.append(sigma_blocks)

        key = (
            "sub_fused", tuple(sparse_ns), plane_shapes, full_shape, embed,
            entries3,
            tuple(float(q) for q in self.opsin.quant_bias),
            float(self.opsin.quant_bias_numerator),
            quantizer.global_scale, qm_scale, lf_scale,
            gabor_weights,
            (epf_params.iters, epf_params.sharp_lut, epf_params.channel_scale,
             epf_params.pass0_sigma_scale, epf_params.pass2_sigma_scale,
             epf_params.border_sad_mul) if epf_params else None,
            tuple(
                tuple(sorted((sel, m.tobytes()) for sel, m in mats.items()))
                for mats in matrices3
            ),
            (self.height, self.width),
        )

        def make_fn(device=None):
            from ..ops.vardct_pipeline import build_fused_pipeline_subsampled

            lf_shapes_eff = tuple(
                (ps[0] // 8, ps[1] // 8) for ps in plane_shapes
            )
            return build_fused_pipeline_subsampled(
                plane_shapes, lf_shapes_eff, full_shape, entries3, matrices3,
                tuple(float(q) for q in self.opsin.quant_bias),
                float(self.opsin.quant_bias_numerator),
                quantizer.global_scale, qm_scale, lf_scale,
                gabor_weights=gabor_weights,
                epf_params=epf_params,
                sparse_coeff_n=tuple(sparse_ns),
                crop=(self.height, self.width),
                embed=embed,
                device=device,
            )

        return key, make_fn, inputs

    @traced("Dequant and transform (subsampled)")
    def _run_fused_subsampled(self, hf_global: HfGlobal | None, device,
                              rect=None):
        """Chroma-subsampled frames (do_ycbcr 4:2:0/4:2:2/4:4:0): ONE
        program runs the three per-channel dequant + inverse transform
        pipelines at their stored geometries, then the JPEG triangle
        chroma upsample and the restoration filters
        (jxl-render/src/vardct/mod.rs:48-385 subsampled path + image.rs:
        448-486 upsample + render.rs filter order); the staged path when
        a dense plan overflows. Output is [3, h, w] at full resolution
        (still YCbCr); sets chroma_upsampled and filters_applied. `rect`
        restricts the program to a plane rect (ROI pushdown)."""
        out = self._run_program(self.fused_subsampled_program_parts,
                                hf_global, device, rect)
        if out is None:
            return self._run_staged(hf_global, device)
        self.chroma_upsampled = True
        return out

    @staticmethod
    def _shard_geometry(mesh, group_dim: int, H: int, W: int) -> dict:
        """How a frame of full-resolution planes H x W shards over `mesh`
        (jxl_oxide_tpu/render/vardct.py:1139-1158): along the dimension
        with more group bands (a wide frame sharded by rows would put all
        work on one shard), in bands of `loc` (whole groups), padded to
        `pad_to`; `last_shard` holds the valid edge at local offset
        `vloc`, later shards only padding."""
        n_sh = mesh.size
        group_rows = _ceil_div(H, group_dim)
        group_cols = _ceil_div(W, group_dim)
        by_rows = group_rows >= group_cols
        S = H if by_rows else W
        loc = _ceil_div(group_rows if by_rows else group_cols,
                        n_sh) * group_dim
        last_shard = min(n_sh - 1, (S - 1) // loc)
        return dict(by_rows=by_rows, loc=loc, pad_to=n_sh * loc,
                    last_shard=last_shard, vloc=S - last_shard * loc)

    @staticmethod
    def _pad_dim(a, size: int, axis: int):
        """`a` (numpy or a tensor) zero-padded to `size` along `axis`."""
        if a.shape[axis] == size:
            return a
        if isinstance(a, torch.Tensor):
            widths = [0, 0] * (a.dim() - 1 - axis % a.dim()) + [
                0, size - a.shape[axis]]
            return torch.nn.functional.pad(a, widths)
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, size - a.shape[axis])
        return np.pad(a, widths)

    @staticmethod
    def _slab(a, s_: int, loc: int, axis: int):
        """Shard s_'s band of `a` along `axis`."""
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(s_ * loc, (s_ + 1) * loc)
        return a[tuple(sl)]

    def _place_shards(self, mesh, per_shard: list) -> list:
        """Each local shard's host inputs on its device, one copy a shard
        (upload_inputs); a tensor input (an LF frame's band) goes to the
        shard's device first."""
        from ..ops.vardct_pipeline import upload_inputs

        placed = []
        with span("Upload"):
            for s_, inputs in zip(mesh.local, per_shard):
                dev = mesh.devices[s_]
                inputs = [x.to(dev) if isinstance(x, torch.Tensor) else x
                          for x in inputs]
                placed.append(upload_inputs(inputs, dev))
        return placed

    @traced("Dequant and transform (sharded)")
    def _run_fused_sharded(self, hf_global: HfGlobal | None, mesh):
        """The fused 4:4:4 program over a decode mesh
        (jxl_oxide_tpu/render/vardct.py:1111-1309): bands of whole 256px
        groups, rows of groups for tall frames, columns for wide ones; the
        sharded dimension padded up to the next mesh multiple, so any
        frame geometry shards, with no single-device fallback. The dense
        plan is made over the padded grid and falls back to the staged
        path (on the home device) over DENSE_PLAN_MAX_ENTRIES; the
        coefficients go up per shard, sparse when that beats dense int16.
        Returns [x, y, b] frame-size planes on the mesh's home device."""
        from ..ops.vardct_pipeline import build_fused_pipeline_sharded
        from ..parallel import mesh_fingerprint

        with span("Fused program inputs"):
            hi = self._fused_host_inputs(hf_global)
        header = self.header
        quantizer = hi["quantizer"]
        corr = hi["corr"]
        n_sh = mesh.size
        H, W = self.plane_shapes[0]
        LH, LW = self.lf_shapes[0]
        g = self._shard_geometry(mesh, header.group_dim, H, W)
        by_rows, loc, pad_to = g["by_rows"], g["loc"], g["pad_to"]
        last_shard, vloc = g["last_shard"], g["vloc"]
        loc_lf = loc // 8
        # H and loc are multiples of 8: the pixel and LF grids agree on
        # the shard index
        vloc_lf = (LH if by_rows else LW) - last_shard * loc_lf
        pax = 1 if by_rows else 2   # sharded axis in [3, H, W] stacks
        gax = 0 if by_rows else 1   # sharded axis in 2-D grids
        pad = self._pad_dim

        coeff_stack = pad(hi["coeff_stack"], pad_to, pax)
        lf_input = pad(hi["lf_input"], n_sh * loc_lf, pax)
        # sparse per-shard coefficient upload when it beats dense int16
        nz_total = int(np.count_nonzero(coeff_stack))
        sparse_n = None
        if nz_total * 6 * n_sh < coeff_stack.size * 2 // 2:
            per_shard_nz = [
                int(np.count_nonzero(self._slab(coeff_stack, s_, loc, pax)))
                for s_ in range(n_sh)
            ]
            sparse_n = 1 << max(
                10, int(max(max(per_shard_nz), 1) - 1).bit_length())
        x_grid = pad(hi["x_grid"], pad_to // 64, gax)
        b_grid = pad(hi["b_grid"], pad_to // 64, gax)
        sigma_blocks = pad(hi["sigma_blocks"], pad_to // 8, gax)
        cfl_const = bool(not x_grid.any() and not b_grid.any())

        # the dense plan over the PADDED block grid; the entry-id and mul
        # grids shard like the sigma grid (band bases are whole group
        # bands, so residues are the same in every band)
        plan_shape = ((pad_to // 8, W // 8) if by_rows
                      else (H // 8, pad_to // 8))
        entries, code_grid, mul_grid = self.dense_plan(hi["buckets"],
                                                       plan_shape)
        if len(entries) > DENSE_PLAN_MAX_ENTRIES:
            return self._run_staged(hf_global, mesh.home_device)

        local_plane = (loc, W) if by_rows else (H, loc)
        local_lf = (loc_lf, LW) if by_rows else (LH, loc_lf)
        qm_scale = hi["qm_scale"]
        kx, kb = hi["kx"], hi["kb"]
        epf_params = hi["epf_params"]
        key = (
            "sharded", sparse_n, cfl_const, mesh_fingerprint(mesh),
            by_rows, local_plane, local_lf, vloc, vloc_lf, last_shard,
            (LH, LW), entries,
            tuple(float(q) for q in self.opsin.quant_bias),
            float(self.opsin.quant_bias_numerator),
            quantizer.global_scale, qm_scale, hi["lf_smooth_scale"],
            hi["skip_smoothing"], (float(kx), float(kb)),
            corr.colour_factor,
            (corr.base_correlation_x, corr.base_correlation_b),
            hi["gabor_weights"],
            (epf_params.iters, epf_params.sharp_lut, epf_params.channel_scale,
             epf_params.pass0_sigma_scale, epf_params.pass2_sigma_scale,
             epf_params.border_sad_mul) if epf_params else None,
            tuple(sorted((sel, m.tobytes())
                         for sel, m in hi["matrices"].items())),
            (self.height, self.width),
        )

        def make_fn(device=None):
            return build_fused_pipeline_sharded(
                mesh, local_plane, local_lf, entries, hi["matrices"],
                tuple(float(q) for q in self.opsin.quant_bias),
                float(self.opsin.quant_bias_numerator),
                quantizer.global_scale, qm_scale, hi["lf_smooth_scale"],
                hi["skip_smoothing"], vloc, vloc_lf, (LH, LW), last_shard,
                cfl_lf_k=(float(kx), float(kb)),
                cfl_colour_factor=corr.colour_factor,
                cfl_base=(corr.base_correlation_x, corr.base_correlation_b),
                gabor_weights=hi["gabor_weights"],
                epf_params=epf_params,
                sparse_coeff_n=sparse_n,
                crop=(self.height, self.width),
                cfl_const=cfl_const,
                shard_dim="rows" if by_rows else "cols",
            )

        fn = self.program(key, make_fn, mesh.home_device)
        if sparse_n is None and np.abs(coeff_stack).max(initial=0) < 32768:
            coeff_stack = coeff_stack.astype(np.int16)
        per_shard = []
        with span("Fused program inputs"):
            for s_ in mesh.local:
                slab = np.ascontiguousarray(
                    self._slab(coeff_stack, s_, loc, pax))
                coeff_input = (slab if sparse_n is None
                               else self._sparse_shard(slab, sparse_n))
                per_shard.append([
                    coeff_input, self._slab(lf_input, s_, loc_lf, pax),
                    hi["lf_scale_arr"],
                    self._slab(x_grid, s_, loc // 64, gax),
                    self._slab(b_grid, s_, loc // 64, gax),
                    self._slab(sigma_blocks, s_, loc // 8, gax),
                    self._slab(code_grid, s_, loc // 8, gax),
                    self._slab(mul_grid, s_, loc // 8, gax),
                ])
        placed = self._place_shards(mesh, per_shard)
        with span("Fused program"):
            out = fn(placed)
        self.filters_applied = True
        self._planes_poolable = True  # the host inputs are plane copies
        return [out[0], out[1], out[2]]

    @staticmethod
    def _sparse_shard(slab: np.ndarray, sparse_n: int) -> tuple:
        """One shard's sparse upload (jxl_oxide_tpu/render/vardct.py:
        1250-1278): i32 flat indices of its nonzero coefficients,
        ascending, padded with ascending out-of-bounds indices (dropped
        on the device), and the values as i16 where they fit."""
        from .. import native as _native

        c_idx = np.zeros(sparse_n, dtype=np.int32)
        c_val = np.zeros(sparse_n, dtype=np.int32)
        if _native.available():
            cnt, max_abs = _native.sparse_extract(slab.reshape(-1), c_idx,
                                                  c_val)
            nzn = min(int(cnt), sparse_n)
        else:
            nzf = np.flatnonzero(slab)
            c_idx[: nzf.size] = nzf
            c_val[: nzf.size] = slab.reshape(-1)[nzf]
            max_abs = int(np.abs(c_val).max(initial=0))
            nzn = nzf.size
        c_idx[nzn:] = slab.size + np.arange(sparse_n - nzn, dtype=np.int32)
        return c_idx, (c_val.astype(np.int16) if max_abs < 32768 else c_val)

    @traced("Dequant and transform (subsampled, sharded)")
    def _run_fused_subsampled_sharded(self, hf_global: HfGlobal | None,
                                      mesh):
        """The fused subsampled program over a decode mesh
        (jxl_oxide_tpu/render/vardct.py:1557-1703): bands of whole groups;
        each channel's stored plane shards at its shifted band size, the
        chroma upsample takes a 1-sample stored-resolution halo, and the
        filter tail is the 4:4:4 sharded program's. Dense coefficient
        uploads; the staged path (on the home device) when a channel's
        plan overflows."""
        from ..ops.vardct_pipeline import (
            build_fused_pipeline_subsampled_sharded,
        )
        from ..parallel import mesh_fingerprint

        header = self.header
        quantizer = self.frame.lf_global.vardct.quantizer
        lf_dequant = self.frame.lf_global.lf_dequant
        scale_inv = quantizer.global_scale * quantizer.quant_lf
        precision_scale = 1 << (9 - self.extra_precision)
        lf_scale = tuple(
            float(lf_dequant[c] * precision_scale / scale_inv)
            for c in range(3)
        )
        H, W = self.height_rounded, self.width_rounded
        g = self._shard_geometry(mesh, header.group_dim, H, W)
        by_rows, loc, pad_to = g["by_rows"], g["loc"], g["pad_to"]
        last_shard, vloc = g["last_shard"], g["vloc"]
        pax = 0 if by_rows else 1  # sharded axis in per-channel 2-D grids
        pad = self._pad_dim

        # per-channel plans over the padded block grid
        plan_shapes = []
        for c in range(3):
            hs, vs = self.shifts[c]
            pad_c = pad_to >> (vs if by_rows else hs)
            Hc, Wc = self.plane_shapes[c]
            plan_shapes.append((pad_c // 8, Wc // 8) if by_rows
                               else (Hc // 8, pad_c // 8))
        with span("Fused program inputs"):
            planned = self._subsampled_channel_plans(
                hf_global, plan_shapes=plan_shapes)
        if planned is None:
            return self._run_staged(hf_global, mesh.home_device)
        plans, qm_scale = planned

        rf = header.restoration_filter
        gabor_weights = (
            tuple(map(tuple, rf.gab.weights)) if rf.gab.enabled else None
        )
        epf_params = rf.epf if rf.epf.enabled else None
        sigma_blocks = pad(self._sigma_blocks_grid(), pad_to // 8, pax)
        entries3 = tuple(p[0] for p in plans)
        matrices3 = tuple(p[3] for p in plans)
        inputs, locs = [], []
        local_plane_shapes, local_lf_shapes = [], []
        for c in range(3):
            hs, vs = self.shifts[c]
            sshift = vs if by_rows else hs
            pad_c = pad_to >> sshift
            loc_c = loc >> sshift
            coeff = pad(self.coeff_planes[c], pad_c, pax)
            if np.abs(coeff).max(initial=0) < 32768:
                coeff = coeff.astype(np.int16)
            lf_q = pad(self.lf_quant_planes[c], pad_c // 8, pax)
            inputs.append((coeff, lf_q, plans[c][1], plans[c][2]))
            locs.append(loc_c)
            Hc, Wc = self.plane_shapes[c]
            if by_rows:
                local_plane_shapes.append((loc_c, Wc))
                local_lf_shapes.append((loc_c // 8, Wc // 8))
            else:
                local_plane_shapes.append((Hc, loc_c))
                local_lf_shapes.append((Hc // 8, loc_c // 8))
        local_full = (loc, W) if by_rows else (H, loc)

        key = (
            "sub_sharded", mesh_fingerprint(mesh), by_rows,
            tuple(local_plane_shapes), local_full, vloc, last_shard,
            entries3,
            tuple(float(q) for q in self.opsin.quant_bias),
            float(self.opsin.quant_bias_numerator),
            quantizer.global_scale, qm_scale, lf_scale,
            gabor_weights,
            (epf_params.iters, epf_params.sharp_lut, epf_params.channel_scale,
             epf_params.pass0_sigma_scale, epf_params.pass2_sigma_scale,
             epf_params.border_sad_mul) if epf_params else None,
            tuple(
                tuple(sorted((sel, m.tobytes()) for sel, m in mats.items()))
                for mats in matrices3
            ),
            (self.height, self.width),
        )

        def make_fn(device=None):
            return build_fused_pipeline_subsampled_sharded(
                mesh, tuple(local_plane_shapes), tuple(local_lf_shapes),
                local_full, entries3, matrices3,
                tuple(float(q) for q in self.opsin.quant_bias),
                float(self.opsin.quant_bias_numerator),
                quantizer.global_scale, qm_scale, lf_scale,
                vloc, last_shard,
                gabor_weights=gabor_weights,
                epf_params=epf_params,
                crop=(self.height, self.width),
                shard_dim="rows" if by_rows else "cols",
            )

        fn = self.program(key, make_fn, mesh.home_device)
        per_shard = []
        for s_ in mesh.local:
            shard = []
            for (coeff, lf_q, code, mul), loc_c in zip(inputs, locs):
                shard += [self._slab(coeff, s_, loc_c, pax),
                          self._slab(lf_q, s_, loc_c // 8, pax),
                          self._slab(code, s_, loc_c // 8, pax),
                          self._slab(mul, s_, loc_c // 8, pax)]
            shard.append(self._slab(sigma_blocks, s_, loc // 8, pax))
            per_shard.append(shard)
        placed = self._place_shards(mesh, per_shard)
        with span("Fused program"):
            out = fn(placed)
        self.filters_applied = True
        self.chroma_upsampled = True
        return [out[0], out[1], out[2]]

    @traced("Dequant and transform (staged)")
    def _run_staged(self, hf_global: HfGlobal | None, device):
        """The staged path: whole-plane LF dequant (+ LF CfL and smoothing
        on 4:4:4 frames), HF dequant against host-built multiplier maps,
        HF CfL, then one batched inverse transform per transform type,
        gathered from and scattered into the planes by host-built index
        plans. Every host input (planes, maps, index plans) goes to
        `device` in ONE copy. Returns [x, y, b] float32 planes at the
        shifted rounded plane sizes on `device`; the render tail does the
        chroma upsample and the filters."""
        from ..ops.vardct_pipeline import (
            adaptive_lf_smoothing,
            cfl_lf,
            cfl_plane,
            dequant_plane,
            transform_buckets,
            upload_inputs,
        )

        header = self.header
        quantizer = self.frame.lf_global.vardct.quantizer
        lf_dequant = self.frame.lf_global.lf_dequant
        corr = self.frame.lf_global.vardct.lf_chan_corr

        with span("Staged inputs"):
            dmaps = self.build_dequant_maps(
                hf_global, header.x_qm_scale, header.b_qm_scale
            )
            plans = [self.build_transform_buckets(c) for c in range(3)]
            host = [*self.lf_quant_planes, *self.coeff_planes, *dmaps]
            for plan in plans:
                for _sel, ci, li, _ in plan:
                    host.extend([ci, li])
            if not self.subsampled:
                host.extend(self.build_cfl_maps())
        with span("Upload"):
            placed = upload_inputs(host, device)
        lf_quant, coeff_q, dmap_t = placed[0:3], placed[3:6], placed[6:9]
        idx_t = iter(placed[9:])
        buckets = [
            [(sel, ci, li, ci)
             for (sel, _, _, _), ci, li in zip(plan, idx_t, idx_t)]
            for plan in plans
        ]

        # LF: dequant (copy_lf_dequant, vardct/mod.rs:387-413)
        scale_inv = quantizer.global_scale * quantizer.quant_lf
        precision_scale = 1 << (9 - self.extra_precision)
        if self.lf_override is not None:
            # LF comes pre-dequantized from the LF frame: identity scale,
            # no LF CfL, no smoothing (vardct/mod.rs:176-182), as on the
            # fused path
            lf_planes = self.padded_lf_override()
        else:
            lf_planes = [
                lf_quant[c].to(torch.float32) * float(np.float32(
                    lf_dequant[c] * precision_scale / scale_inv))
                for c in range(3)
            ]
            if not self.subsampled:
                kx = (corr.base_correlation_x
                      + (corr.x_factor_lf - 128) / corr.colour_factor)
                kb = (corr.base_correlation_b
                      + (corr.b_factor_lf - 128) / corr.colour_factor)
                lf_x, lf_b = cfl_lf(lf_planes[0], lf_planes[1],
                                    lf_planes[2], kx, kb)
                lf_planes = [lf_x, lf_planes[1], lf_b]
            if not header.flags.skip_adaptive_lf_smoothing:
                lf_scale = tuple(
                    np.float32(512.0 * lf_dequant[c] / scale_inv)
                    for c in range(3)
                )
                lf_planes = list(adaptive_lf_smoothing(
                    lf_planes[0], lf_planes[1], lf_planes[2], lf_scale
                ))

        # HF: dequant + CfL + transforms
        coeffs = [
            dequant_plane(coeff_q[c], dmap_t[c],
                          float(self.opsin.quant_bias[c]),
                          float(self.opsin.quant_bias_numerator))
            for c in range(3)
        ]
        if not self.subsampled:
            kx_map, kb_map = placed[-2:]
            cx, cb = cfl_plane(coeffs[0], coeffs[1], coeffs[2],
                               kx_map, kb_map)
            coeffs = [cx, coeffs[1], cb]

        out = []
        for c in range(3):
            out_plane = torch.zeros(self.plane_shapes[c], dtype=torch.float32,
                                    device=device)
            out.append(transform_buckets(coeffs[c], lf_planes[c], out_plane,
                                         buckets[c]))
        return out


class ProgressiveCache:
    """A loading frame's decode state kept across render_loading_frame
    calls (jxl_oxide_tpu/render/vardct.py ProgressiveCache; the
    reference's RenderCache, jxl-render/src/state.rs:17-44): each TOC
    section decodes once, when it is complete. `done` holds the decoded
    sections as ("lf_group", i) and ("group_pass", g, p), as the JAX
    package counts them (HfGlobal is kept, not counted). One class serves
    VarDCT frames (`vardct_state`, `hf_global`) and Modular frames (whose
    ModularImage stays on `lf_global`). The cache owns its LfGlobal,
    parsed afresh when it starts: a one-shot decode of the same frame
    parses and finishes its own, never this one."""

    def __init__(self):
        self.lf_global = None
        self.vardct_state: VardctFrameState | None = None
        self.hf_global: HfGlobal | None = None
        self.done: set = set()
        self.groups_prepared = None  # (mlf_groups, pass_groups)
        self.released = False

    def start(self, frame):
        """The cache's LfGlobal, parsed on the first call, and its group
        split."""
        if self.lf_global is None:
            frame.lf_global = None
            self.lf_global = frame.parse_lf_global()
            modular = self.lf_global.gmodular.modular
            self.groups_prepared = (modular.prepare_groups(frame.pass_shifts)
                                    if modular is not None else ({}, [{}]))
        return self.lf_global

    def take(self, frame, key, after=None) -> bool:
        """Whether section `key` decodes now: it is complete, not decoded
        yet, and the section `after` (if any) is decoded. A section taken
        counts as decoded."""
        if (key in self.done or not frame.section_complete(*key)
                or (after is not None and after not in self.done)):
            return False
        self.done.add(key)
        return True

    def sections_decoded(self) -> int:
        return len(self.done)

    def release(self) -> None:
        """Let go of the state once the complete frame has rendered from
        it: no later section writes into its planes, so they may go back
        to the plane pool. The count stays; the cache renders no more."""
        if self.vardct_state is not None:
            self.vardct_state.trim_coeff_planes()
        self.lf_global = None
        self.vardct_state = None
        self.hf_global = None
        self.groups_prepared = None
        self.released = True


@traced("Render VarDCT")
def decode_vardct_planes(state: VardctFrameState, hf_global, device,
                         rect=None) -> list:
    """The device stage of one VarDCT frame: state.run_device_pipeline
    (on `rect` only, under a decode region), then each plane cropped to
    the frame sample size at its channel's shift (none where the program
    upsampled the chroma already), as jxl_oxide_tpu/render/vardct.py
    decode_vardct_frame crops."""
    planes = state.run_device_pipeline(hf_global, device, rect)
    cropped = []
    for c in range(3):
        hs, vs = (0, 0) if state.chroma_upsampled else state.shifts[c]
        w = _ceil_shift(state.width, hs)
        h = _ceil_shift(state.height, vs)
        p = planes[c]
        cropped.append(p if tuple(p.shape) == (h, w) else p[:h, :w])
    return cropped


def _decode_lf_groups_batch(frame, state, lf_global, lf_jobs, mlf_groups):
    """Decode LF-group sections with ONE native call (C++ modular header
    + MA tree parse + channel decode + varblock placement + EPF sigma,
    jxl-frame data/lf_group.rs re-expressed as a GIL-free batch). Returns
    the set of section indices fully decoded natively; the rest (modular
    LF channels present, use_lf_frame, native errors — Python reproduces
    the exact exception) stay on the Python path."""
    import os

    from .. import native as _native
    from ..models.vardct import HfMetadata, LfCoeff, TransformType

    if os.environ.get("JXL_TPU_NO_LF_BATCH"):
        return set()
    lib = _native.get_lib()
    if lib is None or not hasattr(lib, "jxlhost_decode_lf_groups_batch"):
        return set()
    header = frame.header
    if header.flags.use_lf_frame:
        return set()

    gmodular = lf_global.gmodular
    rf = header.restoration_filter
    epf = (rf.epf.quant_mul, rf.epf.sharp_lut) if rf.epf.enabled else None
    h_up = any(j in (1, 2) for j in header.jpeg_upsampling)
    v_up = any(j in (1, 3) for j in header.jpeg_upsampling)
    lfg_per_row = header.lf_groups_per_row

    sections = []
    idxs = []
    for lf_idx in lf_jobs:
        sub = mlf_groups.get(lf_idx)
        if sub is not None and not sub.is_empty:
            continue  # modular LF channels interleave mid-section
        lf_w, lf_h = header.lf_group_size_for(lf_idx)
        width = -(-lf_w // 8)
        height = -(-lf_h // 8)
        bw, bh = width, height
        if h_up:
            bw = -(-bw // 2) * 2
        if v_up:
            bh = -(-bh // 2) * 2
        w64 = -(-lf_w // 64)
        h64 = -(-lf_h // 64)
        gx = lf_idx % lfg_per_row
        gy = lf_idx // lfg_per_row
        base_x = gx * header.group_dim  # blocks
        base_y = gy * header.group_dim
        lf_views = []
        ok = True
        for c in (1, 0, 2):  # stream order y, x, b
            hs, vs = state.shifts[c]
            w_c = (width + (1 << hs) - 1) >> hs
            h_c = (height + (1 << vs) - 1) >> vs
            x0, y0 = base_x >> hs, base_y >> vs
            plane = state.lf_quant_planes[c]
            if y0 + h_c > plane.shape[0] or x0 + w_c > plane.shape[1]:
                ok = False  # defensive: channel extent exceeds the plane
                break
            lf_views.append(plane[y0 : y0 + h_c, x0 : x0 + w_c])
        if not ok:
            continue
        sections.append(dict(
            data=frame.section_bytes(frame.toc.entry_for("lf_group", lf_idx)),
            lf_idx=lf_idx, bw=bw, bh=bh, w64=w64, h64=h64,
            has_lf_coeff=True,
            lf_views=lf_views,
            xfy=np.zeros((h64, w64), dtype=np.int32),
            bfy=np.zeros((h64, w64), dtype=np.int32),
            sel=np.empty((bh, bw), dtype=np.int8),
            mul=np.empty((bh, bw), dtype=np.int32),
            sigma=np.zeros((bh, bw), dtype=np.float32),
        ))
        idxs.append(lf_idx)
    if not sections:
        return set()

    from ..utils.threads import num_workers

    sec_ret, out_ep = _native.decode_lf_groups_batch(
        ma_config=gmodular.ma_config,
        num_lf_groups=header.num_lf_groups,
        hshifts=[s[0] for s in state.shifts],
        vshifts=[s[1] for s in state.shifts],
        epf=epf,
        quantizer_global_scale=lf_global.vardct.quantizer.global_scale,
        select_sizes=TransformType.SELECT_SIZE_ARR,
        group_blocks=header.group_dim // 8,
        sections=sections,
        n_threads=num_workers(len(sections)),
    )

    done = set()
    for k, lf_idx in enumerate(idxs):
        if sec_ret[k] != 0:
            continue  # Python fallback re-decodes (and re-writes planes)
        s = sections[k]
        hf_meta = HfMetadata(
            x_from_y=s["xfy"], b_from_y=s["bfy"],
            block_sel=s["sel"], block_mul=s["mul"], epf_sigma=s["sigma"],
        )
        state.extra_precision = int(out_ep[k])
        state.lf_groups[lf_idx] = LfGroup(
            LfCoeff(int(out_ep[k]), []), hf_meta
        )
        done.add(lf_idx)
    return done


def _decode_pass_groups_batch(
    frame, state, hf_global, by_group, pass_groups, gmodular
):
    """Decode all (pass x group) HF sections in one native call with a
    C++ thread pool (jxl-render/src/vardct/mod.rs:250-311 pool.scope per
    group, re-expressed as a host-native batch so the stage scales with
    cores, not with the GIL). Modular sub-streams of each section decode
    afterwards from the batch's returned bit positions. Returns the job
    lists the batch could NOT handle (groups with missing hf_meta), for
    the caller's per-section fallback path."""
    import os

    from .. import native as _native
    from ..models.vardct import ensure_packed_orders

    if os.environ.get("JXL_TPU_NO_HF_BATCH"):
        return list(by_group.values())
    lib = _native.get_lib()
    if lib is None or not hasattr(lib, "jxlhost_decode_hf_groups_batch"):
        return list(by_group.values())

    header = frame.header
    shifts = jpeg_shifts(header.jpeg_upsampling)
    hshifts = [s[0] for s in shifts]
    vshifts = [s[1] for s in shifts]
    lf_vardct = frame.lf_global.vardct

    # transform types present, from the per-LF-group grids (one np.unique
    # per LF group instead of one per 256px group — the prep loop below
    # is serial Python in front of the GIL-free batch)
    needed = set()
    for group in state.lf_groups.values():
        if group.hf_meta is None:
            continue
        for s in np.unique(group.hf_meta.block_sel):
            if s >= 0:
                oid = TransformType.ORDER_ID[int(s)]
                needed.update((oid, c) for c in range(3))

    import ctypes

    from ..utils.errors import JxlEofError

    # Vectorized section prep: all per-group view arithmetic (grid
    # slices, plane offsets, section byte ranges) computed as numpy
    # pointer/stride arrays — on a 256-group frame the former per-group
    # Python loops were ~10 ms of serial time in front of the GIL-free
    # batch (Amdahl's bill at 4 threads).
    gpr = header.groups_per_row
    gdim = header.group_dim
    gdb = gdim // 8
    lfg_per_row = header.lf_groups_per_row
    num_passes = header.passes.num_passes

    # per-LF-group bases (few entries; hf_meta presence gates groups)
    n_lfg = header.num_lf_groups
    lf_ok = np.zeros(n_lfg, dtype=bool)
    lf_has_q = np.zeros(n_lfg, dtype=bool)
    sel_base = np.zeros(n_lfg, dtype=np.uint64)
    mul_base = np.zeros(n_lfg, dtype=np.uint64)
    grid_bw = np.zeros(n_lfg, dtype=np.int64)
    grid_bh = np.zeros(n_lfg, dtype=np.int64)
    for li, group in state.lf_groups.items():
        if group.hf_meta is None:
            continue
        bs_g = group.hf_meta.block_sel
        bm_g = group.hf_meta.block_mul
        if (bs_g.dtype != np.int8 or bm_g.dtype != np.int32
                or bs_g.strides != (bs_g.shape[1], 1)
                or bm_g.strides != (4 * bm_g.shape[1], 4)):
            continue  # non-canonical grid layout: per-section fallback
        lf_ok[li] = True
        lf_has_q[li] = group.lf_coeff is not None
        sel_base[li] = bs_g.ctypes.data
        mul_base[li] = bm_g.ctypes.data
        grid_bh[li], grid_bw[li] = bs_g.shape

    group_ids = []
    leftover = []
    sec_pass_l: list[int] = []
    sec_group_l: list[int] = []
    off_l: list[int] = []
    size_l: list[int] = []
    job_start_l: list[int] = []
    job_count_l: list[int] = []
    toc = frame.toc
    # LPT submission order: the native pool claims jobs in order, so
    # biggest-first (total section bytes ~ token count) leaves the small
    # jobs to fill the tail — with few jobs per worker (16 groups on 4
    # threads) dict order left a dense group as the last unit and skewed
    # finish times by a whole section
    ordered = []
    for g, job_list in by_group.items():
        li = header.lf_group_idx_from_group_idx(g)
        if not lf_ok[li]:
            leftover.append(job_list)
            continue
        total = sum(
            toc.entry_for("group_pass", g_idx, p_idx).size
            for p_idx, g_idx in job_list
        )
        ordered.append((total, g, job_list))
    ordered.sort(key=lambda t: -t[0])
    for _total, g, job_list in ordered:
        group_ids.append(g)
        job_start_l.append(len(sec_pass_l))
        job_count_l.append(len(job_list))
        for p_idx, g_idx in job_list:
            e = toc.entry_for("group_pass", g_idx, p_idx)
            off_l.append(e.offset)
            size_l.append(e.size)
            sec_pass_l.append(p_idx)
            sec_group_l.append(g_idx)
    if not group_ids:
        return leftover

    n_sections = len(sec_pass_l)
    offs = np.asarray(off_l, dtype=np.int64) - frame.data_start
    sizes = np.asarray(size_l, dtype=np.int64)
    if int(offs.min()) < 0 or int((offs + sizes).max()) > len(frame.data):
        raise JxlEofError("HF section not fully buffered")

    g_arr = np.asarray(group_ids, dtype=np.int64)
    gx = g_arr % gpr
    gy = g_arr // gpr
    li_arr = (gy // 8) * lfg_per_row + (gx // 8)
    left = (gx % 8) * gdb
    top = (gy % 8) * gdb
    bw_l = grid_bw[li_arr]
    bh_l = grid_bh[li_arr]
    gw = np.minimum(bw_l - left, gdb)
    gh = np.minimum(bh_l - top, gdb)
    g_sel = sel_base[li_arr] + (top * bw_l + left).astype(np.uint64)
    g_mul = mul_base[li_arr] + (4 * (top * bw_l + left)).astype(np.uint64)
    g_stride = bw_l  # element stride, shared by sel (i8) and mul (i32)

    # output plane views + lf_quant views as base + offset
    g_out = np.zeros((len(g_arr), 3), dtype=np.uint64)
    g_out_stride = np.zeros((len(g_arr), 3), dtype=np.int64)
    g_lfq = np.zeros((len(g_arr), 3), dtype=np.uint64)
    g_lfq_stride = np.zeros((len(g_arr), 3), dtype=np.int64)
    lgx = li_arr % lfg_per_row
    lgy = li_arr // lfg_per_row
    has_q = lf_has_q[li_arr]
    for c in range(3):
        hs, vs = state.shifts[c]
        plane = state.coeff_planes[c]
        pw = plane.shape[1]
        x0 = (gx * gdim) >> hs
        y0 = (gy * gdim) >> vs
        g_out[:, c] = plane.ctypes.data + 4 * (y0 * pw + x0).astype(np.uint64)
        g_out_stride[:, c] = pw
        lfp = state.lf_quant_planes[c]
        lw = lfp.shape[1]
        x0l = ((lgx * gdim) >> hs) + (left >> hs)
        y0l = ((lgy * gdim) >> vs) + (top >> vs)
        g_lfq[:, c] = np.where(
            has_q,
            lfp.ctypes.data + 4 * (y0l * lw + x0l).astype(np.uint64),
            np.uint64(0),
        )
        g_lfq_stride[:, c] = lw

    # expand per-group arrays to per-section (jobs are contiguous runs)
    counts = np.asarray(job_count_l, dtype=np.int64)
    rep = np.repeat(np.arange(len(g_arr)), counts)
    data_buf = (ctypes.c_char * len(frame.data)).from_buffer(frame.data)
    base_addr = np.uint64(ctypes.addressof(data_buf))

    pass_tables = []
    pass_orders = []
    pass_shifts_ = []
    for p in range(num_passes):
        hf_pass = hf_global.hf_passes[p]
        pass_tables.append(_native.DecoderTables.cached(hf_pass.hf_dist))
        pass_orders.append(ensure_packed_orders(hf_pass, needed))
        pass_shifts_.append(header.passes.pass_shift(p))

    from ..utils.threads import num_workers

    bit_pos = _native.decode_hf_groups_batch_raw(
        pass_tables=pass_tables,
        pass_orders=pass_orders,
        num_hf_presets=hf_global.num_hf_presets,
        pass_coeff_shifts=pass_shifts_,
        hf_block_ctx=lf_vardct.hf_block_ctx,
        hshifts=hshifts,
        vshifts=vshifts,
        n_sections=n_sections,
        sec_data_ptrs=base_addr + offs.astype(np.uint64),
        sec_len=sizes.astype(np.uint64),
        sec_pass=np.asarray(sec_pass_l, dtype=np.int32),
        sec_sel_ptrs=g_sel[rep],
        sec_mul_ptrs=g_mul[rep],
        sec_gw=gw[rep].astype(np.int32),
        sec_gh=gh[rep].astype(np.int32),
        sec_stride=g_stride[rep],
        sec_lf_ptrs=np.ascontiguousarray(g_lfq[rep]).reshape(-1),
        sec_lf_strides=np.ascontiguousarray(g_lfq_stride[rep]).reshape(-1),
        sec_out_ptrs=np.ascontiguousarray(g_out[rep]).reshape(-1),
        sec_out_strides=np.ascontiguousarray(g_out_stride[rep]).reshape(-1),
        job_start=np.asarray(job_start_l, dtype=np.int32),
        job_count=np.asarray(job_count_l, dtype=np.int32),
        n_threads=num_workers(len(group_ids)),
        keepalive=(data_buf, state.coeff_planes, state.lf_quant_planes,
                   state.lf_groups),
    )
    del data_buf  # release the bytearray buffer export

    # modular sub-streams continue where the HF decode stopped
    has_subs = any(
        not s.is_empty for d in pass_groups for s in d.values()
    )
    if has_subs:
        for k in range(n_sections):
            p_idx = sec_pass_l[k]
            g_idx = sec_group_l[k]
            sub = (
                pass_groups[p_idx].get(g_idx)
                if p_idx < len(pass_groups)
                else None
            )
            if sub is None or sub.is_empty:
                continue
            data = frame.section_bytes(
                toc.entry_for("group_pass", g_idx, p_idx)
            )
            bs = Bitstream(data)
            bs.pos = int(bit_pos[k])
            frame._decode_pass_group(bs, p_idx, g_idx, sub, gmodular)
    return leftover

