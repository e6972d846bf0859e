"""C++ host runtime bindings: builds (once) and loads libjxl_host.so.

The port's own copy of jxl_oxide_tpu/native/__init__.py (the port imports
nothing of the JAX package).

The native library runs the per-sample entropy hot loops (rANS/prefix +
LZ77 + MA-tree modular decode); Python parses all headers/tables and
serializes them to flat arrays here. Falls back to the pure-Python decode
paths when compilation is unavailable (set JXL_TPU_NO_NATIVE=1 to force).

Behavioral parity (bit-exact vs the Python paths, which cite the spec
sites): jxl-coding/src/{ans.rs,prefix.rs,lib.rs} (symbol loops),
jxl-modular/src/{image.rs,predictor.rs,ma.rs} (modular decode + weighted
predictor), jxl-vardct/src/hf_coeff.rs (HF coefficient decode),
jxl-color/src/icc/decode.rs (ICC byte stream). The reference's analog of
this layer is its per-arch SIMD modules (e.g. jxl-modular squeeze.rs
SIMD, jxl-render x86_64/aarch64 kernels).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

from ..utils.trace import span

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
# the same C++ source as the JAX package; the library is built into the
# port's own (gitignored) build directory
_SRC = os.path.join(_REPO_ROOT, "native", "src", "jxl_host.cpp")
_LIB_DIR = os.path.join(_PKG_ROOT, "_build")
_LIB = os.path.join(_LIB_DIR, "libjxl_host.so")

_lib = None
_tried = False
# the first callers wait for the build: a pool thread that found it under
# way would otherwise take the Python path (and other input dtypes)
_load_lock = threading.Lock()


def _lib_path() -> str:
    """Sanitized builds (JXL_TPU_NATIVE_SANITIZE=address|thread) use
    separate libraries: ASan+UBSan for pointer/UB sweeps over the fuzz
    corpus, TSan for the threaded runtime (WorkerPool + batch decoders
    — SURVEY.md §5's 'host C++ under TSAN' line; the reference confines
    unsafe to audited SIMD, our C++ gets sanitizer coverage instead)."""
    san = os.environ.get("JXL_TPU_NATIVE_SANITIZE")
    if san == "thread":
        return os.path.join(_LIB_DIR, "libjxl_host_tsan.so")
    if san:
        return os.path.join(_LIB_DIR, "libjxl_host_asan.so")
    return _LIB


def _build() -> bool:
    os.makedirs(_LIB_DIR, exist_ok=True)
    lib_path = _lib_path()
    try:
        src_mtime = os.path.getmtime(_SRC)
    except OSError:
        return False
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= src_mtime:
        return True
    san = os.environ.get("JXL_TPU_NATIVE_SANITIZE")
    if san == "thread":
        opt = ["-O1", "-g", "-fsanitize=thread"]
    elif san:
        opt = ["-O1", "-g", "-fsanitize=address,undefined",
               "-fno-sanitize-recover=undefined"]
    else:
        # built at runtime on the host it runs on, so native codegen is
        # safe. On x86, AVX-512 is disabled: with it enabled, gcc spills
        # the interleaved decoders' loop-carried state into k-mask
        # registers, and the kmov round-trips sit on the ANS dependency
        # chain (~25% slower). The flag is x86-only; other arches reject
        # it outright.
        import platform

        opt = ["-O3", "-march=native"]
        if platform.machine().lower() in ("x86_64", "amd64", "i686"):
            opt.append("-mno-avx512f")
    # per-process temporary: concurrent first imports (test workers) each
    # build and the last atomic rename wins
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", *opt, "-shared", "-fPIC", "-std=c++17", "-pthread",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, lib_path)
        return True
    except Exception as e:  # pragma: no cover - toolchain issues
        print(f"jxl_oxide_tpu_torch: native build failed: {e}", file=sys.stderr)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _tried:
        return _lib
    with _load_lock:
        if not _tried:
            try:
                if not os.environ.get("JXL_TPU_NO_NATIVE") and _build():
                    lib = ctypes.CDLL(_lib_path())
                    lib.jxlhost_decode_modular.restype = ctypes.c_int
                    _lib = lib
            finally:
                _tried = True
    return _lib


def available() -> bool:
    return get_lib() is not None


def mem_stats() -> tuple[int, int]:
    """(current, peak) native scratch bytes — LZ77 windows, alias-bucket
    stores, HF offset tables (jxl-grid alloc_tracker.rs:8-51 parity for
    the C++ stage). (0, 0) when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return (0, 0)
    cur = ctypes.c_int64()
    peak = ctypes.c_int64()
    lib.jxlhost_mem_stats(ctypes.byref(cur), ctypes.byref(peak))
    return (cur.value, peak.value)


class native_budget:
    """Scope one native call under the active AllocTracker: on entry the
    native limit becomes the tracker's remaining headroom (so the C++
    stage fails with ret 12 -> JxlOutOfMemoryError instead of allocating
    past the budget), and on exit the native scratch PEAK reached during
    the call is folded into the tracker's peak. The native counters are
    process-global, so concurrent decodes share one budget — the
    conservative direction for enforcement."""

    def __enter__(self):
        from ..utils.alloc import current_tracker

        self._tracker = t = current_tracker()
        self._lib = lib = get_lib()
        if t is None or lib is None:
            return self
        lib.jxlhost_mem_reset_peak()
        cur = ctypes.c_int64()
        peak = ctypes.c_int64()
        lib.jxlhost_mem_stats(ctypes.byref(cur), ctypes.byref(peak))
        self._base_peak = peak.value
        # headroom on top of whatever native scratch is already live
        lib.jxlhost_mem_set_limit(
            ctypes.c_int64(max(0, t.limit - t.used) + cur.value)
        )
        return self

    def __exit__(self, *exc):
        t, lib = self._tracker, self._lib
        if t is None or lib is None:
            return False
        lib.jxlhost_mem_set_limit(ctypes.c_int64(0))
        cur = ctypes.c_int64()
        peak = ctypes.c_int64()
        lib.jxlhost_mem_stats(ctypes.byref(cur), ctypes.byref(peak))
        delta = peak.value - self._base_peak
        if delta > 0 and t.used + delta > t.peak:
            t.peak = t.used + delta
        return False


# ---------------------------------------------------------------------------
# Serialization


class DecoderTables:
    """Flat-array serialization of a parsed Decoder (entropy.py) for C++."""

    @classmethod
    def cached(cls, decoder) -> "DecoderTables":
        """Memoized on the decoder: per-frame specs (e.g. the shared HF
        distribution set) serialize once, not once per group section."""
        tables = getattr(decoder, "_native_tables", None)
        if tables is None:
            tables = cls(decoder)
            decoder._native_tables = tables
        return tables

    def __init__(self, decoder):
        lz = decoder.lz77 is not None
        if lz:
            lc = decoder.lz77.len_config
            len_cfg = (lc.split_exponent, lc.msb_in_token, lc.lsb_in_token)
        else:
            len_cfg = (0, 0, 0)
        self.header = np.array([
            1 if lz else 0,
            decoder.lz77_min_symbol,
            decoder.lz77_min_length,
            *len_cfg,
            len(decoder.clusters),
            decoder.num_clusters,
            1 if decoder.use_prefix_code else 0,
            decoder.log_alphabet_size,
        ], dtype=np.int32)
        self.cluster_map = np.ascontiguousarray(decoder.clusters, dtype=np.int32)
        self.cfgs = np.array(
            [
                v
                for c in decoder.configs
                for v in (c.split_exponent, c.msb_in_token, c.lsb_in_token)
            ],
            dtype=np.int32,
        )
        if decoder.use_prefix_code:
            metas = []
            blobs = []
            off = 0
            for h in decoder.prefix_hists:
                if h.single is not None:
                    metas += [0, off]
                    blobs.append(np.array([h.single, 0], dtype=np.int32))
                    off += 2
                else:
                    metas += [h.max_len, off]
                    blobs.append(np.ascontiguousarray(h.table_sym, dtype=np.int32))
                    blobs.append(np.ascontiguousarray(h.table_len, dtype=np.int32))
                    off += 2 * (1 << h.max_len)
            self.pfx_meta = np.array(metas, dtype=np.int32)
            self.pfx_blob = (
                np.concatenate(blobs) if blobs else np.zeros(1, dtype=np.int32)
            )
            self.ans_meta = np.zeros(2, dtype=np.int32)
            self.ans_blob = np.zeros(1, dtype=np.int32)
        else:
            metas = []
            blobs = []
            off = 0
            for h in decoder.ans_hists:
                # packed AnsBucket wire layout (2 i32 words = one u64 per
                # bucket): cutoff[0:13) | alias_symbol[13:25) |
                # alias_offset[25:37) | dist_self[37:50) |
                # dist_alias[50:63) — ONE 8-byte load per symbol in C++
                alphabet = 1 << (12 - h.log_bucket_size)
                metas += [h.log_bucket_size, off]
                dist = np.asarray(h.dist[:alphabet], dtype=np.uint64)
                sym = np.asarray(h.alias_symbol, dtype=np.uint64)
                v = (
                    np.asarray(h.alias_cutoff, dtype=np.uint64)
                    | (sym << 13)
                    | (np.asarray(h.alias_offset, dtype=np.uint64) << 25)
                    | (dist << 37)
                    | (dist[sym] << 50)
                )
                blobs.append(v.view(np.int32))
                off += 2 * alphabet
            self.ans_meta = np.array(metas, dtype=np.int32)
            self.ans_blob = (
                np.concatenate(blobs) if blobs else np.zeros(1, dtype=np.int32)
            )
            self.pfx_meta = np.zeros(2, dtype=np.int32)
            self.pfx_blob = np.zeros(1, dtype=np.int32)


def serialize_tree(tree) -> np.ndarray:
    """FlatTree -> int32 [n, 5]: leaf (1, cluster, pred, offset, mult) or
    decision (0, prop, value, left, right). Cached on the tree (flat trees
    are shared across sections via MaConfig's flat-tree cache)."""
    cached = getattr(tree, "_native_arr", None)
    if cached is not None:
        return cached

    from ..models.modular_ma import FlatLeaf

    out = np.zeros((len(tree.nodes), 5), dtype=np.int32)
    for i, nd in enumerate(tree.nodes):
        if isinstance(nd, FlatLeaf):
            out[i] = (1, nd.cluster, nd.predictor, nd.offset, nd.multiplier)
        else:
            prop, value, left, right = nd
            out[i] = (0, prop, value, left, right)
    tree._native_arr = out
    return out


def decode_modular_native(
    bs, decoder, infos, trees, views, prev_lists, dist_multiplier, wp_header
) -> None:
    """Run the whole sub-stream decode in C++. Mutates `views` in place and
    advances `bs.pos`. Raises JxlBitstreamError on stream errors."""
    from ..utils.errors import JxlBitstreamError

    lib = get_lib()
    tables = DecoderTables.cached(decoder)

    n = len(infos)
    # narrow (i16) lane: all real views of one stream share a dtype
    dtype = next(
        (v.dtype for i, v in enumerate(views)
         if trees[i] is not None and infos[i].width and infos[i].height),
        np.dtype(np.int32),
    )
    assert dtype in (np.int16, np.int32), dtype
    is16 = dtype == np.int16
    isz = 2 if is16 else 4
    chan_bufs = (ctypes.c_void_p * n)()
    chan_strides = np.zeros(n, dtype=np.int64)
    chan_dims = np.zeros(n * 2, dtype=np.int32)
    tree_meta = np.zeros(n * 2, dtype=np.int32)
    tree_arrays = []
    tree_ptrs = (ctypes.c_void_p * n)()
    prev_counts = np.zeros(n, dtype=np.int32)
    prev_offsets = np.zeros(n, dtype=np.int32)
    flat_prev_ptrs = []
    flat_prev_strides = []

    keepalive = []
    for i, (info, tree, view) in enumerate(zip(infos, trees, views)):
        if tree is None or info.width == 0 or info.height == 0:
            chan_dims[i * 2] = 0
            chan_dims[i * 2 + 1] = 0
            tree_arrays.append(np.zeros((1, 5), dtype=np.int32))
            tree_ptrs[i] = tree_arrays[-1].ctypes.data
            continue
        assert view.dtype == dtype
        assert view.strides[1] == isz, "row-contiguous views required"
        chan_bufs[i] = view.ctypes.data
        chan_strides[i] = view.strides[0] // isz
        chan_dims[i * 2] = info.width
        chan_dims[i * 2 + 1] = info.height
        ta = serialize_tree(tree)
        tree_arrays.append(ta)
        tree_ptrs[i] = ta.ctypes.data
        tree_meta[i * 2] = len(ta)
        tree_meta[i * 2 + 1] = 1 if tree.need_self_correcting else 0
        prevs = prev_lists[i]
        prev_counts[i] = len(prevs)
        prev_offsets[i] = len(flat_prev_ptrs)
        for p in prevs:
            assert p.dtype == dtype and p.strides[1] == isz
            keepalive.append(p)
            flat_prev_ptrs.append(p.ctypes.data)
            flat_prev_strides.append(p.strides[0] // isz)

    np_prev_ptrs = np.array(flat_prev_ptrs or [0], dtype=np.uint64)
    np_prev_strides = np.array(flat_prev_strides or [0], dtype=np.int64)

    wp = wp_header
    wp_arr = np.array(
        [wp.p1, wp.p2, wp.p3a, wp.p3b, wp.p3c, wp.p3d, wp.p3e, *wp.w],
        dtype=np.int32,
    )

    bit_pos = ctypes.c_uint64(bs.pos)
    data = bs.data

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    with native_budget():
        ret = lib.jxlhost_decode_modular(
        ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(len(data)),
        ctypes.byref(bit_pos),
        ip(tables.header), ip(tables.cluster_map), ip(tables.cfgs),
        ip(tables.ans_meta), ip(tables.ans_blob),
        ip(tables.pfx_meta), ip(tables.pfx_blob),
        ctypes.c_int32(n),
        ctypes.cast(chan_bufs, ctypes.POINTER(ctypes.c_void_p)),
        chan_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ip(chan_dims),
        ctypes.cast(tree_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ip(tree_meta),
        ip(prev_counts), ip(prev_offsets),
        np_prev_ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        np_prev_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(dist_multiplier),
        ip(wp_arr),
        ctypes.c_int32(1 if is16 else 0),
    )
    if ret != 0:
        raise_modular_ret(ret)
    bs.pos = bit_pos.value


def _jbr_table_arrays(table):
    """BuiltHuffmanTable -> (bits u64[256] MSB-aligned, lens i32[256]),
    cached on the table object."""
    cached = getattr(table, "_native_arrs", None)
    if cached is not None:
        return cached
    lens = np.asarray(table.lengths, dtype=np.int32)
    bits = np.asarray(table.bits, dtype=np.uint64)
    table._native_arrs = (bits, lens)
    return bits, lens


def jbr_encode_scan(comps_data, scan_type: int, has_dc: bool, ss: int,
                    se: int, al: int, w8: int, h8: int,
                    restart_interval: int, reset_points, extra_zero_runs,
                    nat8, padding_bits: bytes | None,
                    padding_pos: int, n_threads: int | None = None) -> tuple[bytes, int]:
    """Encode one JPEG scan in C++ (jxlhost_jbr_encode_scan).

    comps_data: list of (lf_plane i32, hf_plane i32, dc_offset, hs, vs,
    dc_table | None, ac_table | None). Returns (encoded bytes, new
    padding bit position). Raises JxlError on missing huffman codes and
    JxlEofError when the padding bit stream runs out."""
    from ..utils.errors import JxlEofError, JxlError

    lib = get_lib()
    if n_threads is None:
        from ..utils.threads import num_workers

        # one worker per restart segment (sequential scans parallelize
        # at restart boundaries; see jxlhost_jbr_encode_scan)
        segs = (
            (w8 * h8 + restart_interval - 1) // restart_interval
            if restart_interval else 1
        )
        n_threads = num_workers(segs)
    n = len(comps_data)
    comp_meta = np.zeros(n * 10, dtype=np.int64)
    plane_ptrs = (ctypes.c_void_p * (n * 2))()
    bits_ptrs = (ctypes.c_void_p * (n * 2))()
    lens_ptrs = (ctypes.c_void_p * (n * 2))()
    keepalive = []
    for i, (lf, hf, dco, hs, vs, dc_t, ac_t) in enumerate(comps_data):
        lf = np.ascontiguousarray(lf, dtype=np.int32)
        hf = np.ascontiguousarray(hf, dtype=np.int32)
        keepalive += [lf, hf]
        comp_meta[i * 10 : i * 10 + 9] = (
            dco, hs, vs,
            lf.shape[0], lf.shape[1], lf.strides[0] // 4,
            hf.shape[0], hf.shape[1], hf.strides[0] // 4,
        )
        plane_ptrs[i * 2] = lf.ctypes.data
        plane_ptrs[i * 2 + 1] = hf.ctypes.data
        for j, t in enumerate((dc_t, ac_t)):
            if t is not None:
                b, ln = _jbr_table_arrays(t)
                keepalive += [b, ln]
                bits_ptrs[i * 2 + j] = b.ctypes.data
                lens_ptrs[i * 2 + j] = ln.ctypes.data
    resets = np.asarray(sorted(reset_points), dtype=np.int64)
    ezr_items = sorted(extra_zero_runs.items())
    ezr_idx = np.asarray([k for k, _ in ezr_items], dtype=np.int64)
    ezr_n = np.asarray([v for _, v in ezr_items], dtype=np.int32)
    nat8_arr = np.asarray(
        [v for xy in nat8 for v in xy], dtype=np.int32
    )
    pad_pos = ctypes.c_uint64(padding_pos)
    out_ptr = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64(0)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    ret = lib.jxlhost_jbr_encode_scan(
        ctypes.c_int32(n),
        comp_meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.cast(plane_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(bits_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(lens_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.c_int32(scan_type), ctypes.c_int32(1 if has_dc else 0),
        ctypes.c_int32(ss), ctypes.c_int32(se), ctypes.c_int32(al),
        ctypes.c_int32(w8), ctypes.c_int32(h8),
        ctypes.c_int32(restart_interval or 0),
        resets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(len(resets)),
        ezr_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ip(ezr_n), ctypes.c_int64(len(ezr_idx)),
        ip(nat8_arr),
        ctypes.c_char_p(padding_bits) if padding_bits is not None else None,
        ctypes.c_uint64(len(padding_bits) * 8 if padding_bits else 0),
        ctypes.byref(pad_pos),
        ctypes.byref(out_ptr), ctypes.byref(out_len),
        ctypes.c_int32(n_threads),
    )
    if ret == 1:
        raise JxlError("JPEG huffman symbol has no code")
    if ret == 3:
        raise JxlEofError("jbrd: padding bit stream exhausted")
    if ret != 0:
        raise JxlError(f"native jbr scan encode error {ret}")
    try:
        encoded = ctypes.string_at(out_ptr, out_len.value)
    finally:
        lib.jxlhost_buf_free(out_ptr)
    return encoded, int(pad_pos.value)


def inverse_squeeze_h(avg: np.ndarray, res: np.ndarray,
                      h: int, aw: int, rw: int) -> np.ndarray:
    """Horizontal un-squeeze in C++ (squeeze.rs inverse_h_i32_base
    wrapping semantics). avg/res are int32 [h, aw] / [h, rw]; returns
    int32 [h, aw+rw]."""
    lib = get_lib()
    assert avg.dtype == np.int32 and res.dtype == np.int32
    out = np.empty((h, aw + rw), dtype=np.int32)

    def sp(a, i):  # stride in elements along axis i
        return ctypes.c_int64(a.strides[i] // 4)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    lib.jxlhost_inverse_squeeze_h(
        ip(avg), sp(avg, 0), sp(avg, 1),
        ip(res) if rw else ip(avg), sp(res, 0) if rw else sp(avg, 0),
        sp(res, 1) if rw else sp(avg, 1),
        ctypes.c_int32(h), ctypes.c_int32(aw), ctypes.c_int32(rw),
        ip(out), sp(out, 0), sp(out, 1),
    )
    return out


def sparse_extract(flat_i32: np.ndarray, out_idx: np.ndarray,
                   out_val: np.ndarray) -> tuple[int, int]:
    """One-pass nonzero extraction: fills out_idx/out_val (both int32, up
    to their length) and returns (nonzero_count, max_abs). When count
    exceeds the capacity only capacity entries are written — callers use
    that as the dense-fallback signal."""
    lib = get_lib()
    lib.jxlhost_sparse_extract_i32.restype = ctypes.c_int64
    assert flat_i32.dtype == np.int32 and flat_i32.flags.c_contiguous
    max_abs = ctypes.c_int32(0)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    with span("Native", fn="sparse_extract"):
        cnt = lib.jxlhost_sparse_extract_i32(
            ip(flat_i32), ctypes.c_int64(flat_i32.size),
            ctypes.c_int64(len(out_idx)), ip(out_idx), ip(out_val),
            ctypes.byref(max_abs),
        )
    return int(cnt), int(max_abs.value)


def place_varblocks(block_info_raw, bh: int, bw: int, group_blocks: int,
                    select_sizes: np.ndarray):
    """Native varblock placement (hf_metadata.rs BlockInfo): returns
    (sel_grid i8 [bh,bw] with -1 holes, mul_grid i32 origins,
    mul_full i32 coverage) or raises JxlValidationError."""
    from ..utils.errors import JxlValidationError

    lib = get_lib()
    info = np.ascontiguousarray(block_info_raw, dtype=np.int32)
    n_raw = info.shape[1]
    sel_grid = np.full((bh, bw), -1, dtype=np.int8)
    mul_grid = np.zeros((bh, bw), dtype=np.int32)
    mul_full = np.zeros((bh, bw), dtype=np.int32)
    sizes = np.ascontiguousarray(select_sizes, dtype=np.int32)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    with span("Native", fn="place_varblocks"):
        ret = lib.jxlhost_place_varblocks(
            ip(info), ctypes.c_int64(n_raw),
            ctypes.c_int32(bh), ctypes.c_int32(bw),
            ctypes.c_int32(group_blocks),
            ip(sizes), ctypes.c_int32(len(sizes) // 2),
            sel_grid.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ip(mul_grid), ip(mul_full),
        )
    if ret != 0:
        msgs = {
            1: "invalid TransformType",
            2: "non-positive HfMul",
            3: "varblock placed across pass group border",
            4: "varblock doesn't fit in LF group",
            5: "varblocks overlap",
            6: "BlockInfo doesn't fill LF group",
        }
        raise JxlValidationError(msgs.get(ret, f"varblock placement error {ret}"))
    return sel_grid, mul_grid, mul_full


def raise_native_oom(ret: int) -> None:
    """Raise if the native return code signals a scratch-budget failure
    (ret 12 = 10 + DecoderState error 2, set when an LZ77 window or HF
    offset table would exceed the jxlhost_mem_set_limit budget)."""
    if ret == 12:
        from ..utils.alloc import JxlOutOfMemoryError

        raise JxlOutOfMemoryError("native scratch memory budget exceeded")


def raise_modular_ret(ret: int) -> None:
    """Map a native modular-decode return code to the library exception."""
    if ret == 0:
        return
    from ..utils.errors import JxlBitstreamError, JxlEofError

    if ret == 4:
        raise JxlEofError("stream truncated (native)")
    if ret == 2:
        raise JxlBitstreamError("ANS final state mismatch (native)")
    raise_native_oom(ret)
    raise JxlBitstreamError(f"native modular decode error {ret}")


def decode_modular_batch(records, num_threads: int) -> np.ndarray:
    """Decode many independent modular sub-streams in ONE native call with
    a C++ thread pool (no GIL in the fan-out; the modular twin of
    decode_hf_groups_batch). Each record is a dict with keys
    data/pos/tables/infos/trees/views/prev_lists/dist_multiplier/wp_header,
    produced by ModularSubimage.native_record. Mutates the record views in
    place; returns the per-section return codes (0 = ok; use
    raise_modular_ret to surface errors)."""
    lib = get_lib()
    n_sec = len(records)

    # decoder spec table, deduplicated by the DecoderTables object (all
    # global-tree sections of a frame share one)
    spec_ids: dict[int, int] = {}
    spec_tables = []
    sec_spec = np.zeros(n_sec, dtype=np.int32)
    for k, rec in enumerate(records):
        t = rec["tables"]
        idx = spec_ids.get(id(t))
        if idx is None:
            idx = len(spec_tables)
            spec_ids[id(t)] = idx
            spec_tables.append(t)
        sec_spec[k] = idx
    spec_ptrs = (ctypes.c_void_p * (len(spec_tables) * 7))()
    for i, t in enumerate(spec_tables):
        for j, arr in enumerate((t.header, t.cluster_map, t.cfgs, t.ans_meta,
                                 t.ans_blob, t.pfx_meta, t.pfx_blob)):
            spec_ptrs[i * 7 + j] = arr.ctypes.data

    # flattened channels
    n_chan = sum(len(r["infos"]) for r in records)
    chan_bufs = (ctypes.c_void_p * max(n_chan, 1))()
    chan_strides = np.zeros(max(n_chan, 1), dtype=np.int64)
    chan_dims = np.zeros(max(n_chan, 1) * 2, dtype=np.int32)
    tree_meta = np.zeros(max(n_chan, 1) * 2, dtype=np.int32)
    tree_ptrs = (ctypes.c_void_p * max(n_chan, 1))()
    prev_counts = np.zeros(max(n_chan, 1), dtype=np.int32)
    prev_offsets = np.zeros(max(n_chan, 1), dtype=np.int32)
    flat_prev_ptrs: list[int] = []
    flat_prev_strides: list[int] = []
    keepalive = []

    sec_data = (ctypes.c_char_p * n_sec)()
    sec_len = np.zeros(n_sec, dtype=np.uint64)
    sec_bit_pos = np.zeros(n_sec, dtype=np.uint64)
    sec_chan_start = np.zeros(n_sec, dtype=np.int32)
    sec_chan_count = np.zeros(n_sec, dtype=np.int32)
    sec_dist_mul = np.zeros(n_sec, dtype=np.int32)
    sec_wp = np.zeros(n_sec * 11, dtype=np.int32)
    sec_is16 = np.zeros(n_sec, dtype=np.int32)
    sec_ret = np.zeros(n_sec, dtype=np.int32)

    dummy_tree = np.zeros((1, 5), dtype=np.int32)
    keepalive.append(dummy_tree)

    ci = 0
    for k, rec in enumerate(records):
        data = rec["data"]
        sec_data[k] = data
        keepalive.append(data)
        sec_len[k] = len(data)
        sec_bit_pos[k] = rec["pos"]
        sec_chan_start[k] = ci
        infos, trees, views = rec["infos"], rec["trees"], rec["views"]
        sec_chan_count[k] = len(infos)
        sec_dist_mul[k] = rec["dist_multiplier"]
        wp = rec["wp_header"]
        sec_wp[k * 11:(k + 1) * 11] = (
            wp.p1, wp.p2, wp.p3a, wp.p3b, wp.p3c, wp.p3d, wp.p3e, *wp.w
        )
        dtype = next(
            (v.dtype for i, v in enumerate(views)
             if trees[i] is not None and infos[i].width and infos[i].height),
            np.dtype(np.int32),
        )
        assert dtype in (np.int16, np.int32), dtype
        is16 = dtype == np.int16
        isz = 2 if is16 else 4
        sec_is16[k] = 1 if is16 else 0
        for i, (info, tree, view) in enumerate(zip(infos, trees, views)):
            if tree is None or info.width == 0 or info.height == 0:
                tree_ptrs[ci] = dummy_tree.ctypes.data
                ci += 1
                continue
            assert view.dtype == dtype
            assert view.strides[1] == isz, "row-contiguous views required"
            chan_bufs[ci] = view.ctypes.data
            chan_strides[ci] = view.strides[0] // isz
            chan_dims[ci * 2] = info.width
            chan_dims[ci * 2 + 1] = info.height
            ta = serialize_tree(tree)
            keepalive.append(ta)
            tree_ptrs[ci] = ta.ctypes.data
            tree_meta[ci * 2] = len(ta)
            tree_meta[ci * 2 + 1] = 1 if tree.need_self_correcting else 0
            prevs = rec["prev_lists"][i]
            prev_counts[ci] = len(prevs)
            prev_offsets[ci] = len(flat_prev_ptrs)
            for p in prevs:
                assert p.dtype == dtype and p.strides[1] == isz
                keepalive.append(p)
                flat_prev_ptrs.append(p.ctypes.data)
                flat_prev_strides.append(p.strides[0] // isz)
            ci += 1

    np_prev_ptrs = np.array(flat_prev_ptrs or [0], dtype=np.uint64)
    np_prev_strides = np.array(flat_prev_strides or [0], dtype=np.int64)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    with native_budget():
        ret = lib.jxlhost_decode_modular_batch(
        ctypes.c_int32(len(spec_tables)),
        ctypes.cast(spec_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(chan_bufs, ctypes.POINTER(ctypes.c_void_p)),
        chan_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ip(chan_dims),
        ctypes.cast(tree_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ip(tree_meta),
        ip(prev_counts), ip(prev_offsets),
        np_prev_ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        np_prev_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(n_sec),
        ctypes.cast(sec_data, ctypes.POINTER(ctypes.c_char_p)),
        sec_len.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        sec_bit_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ip(sec_spec), ip(sec_chan_start), ip(sec_chan_count),
        ip(sec_dist_mul), ip(sec_wp), ip(sec_is16),
        ctypes.c_int32(num_threads),
        ip(sec_ret),
    )
    if ret != 0:
        from ..utils.errors import JxlBitstreamError

        raise JxlBitstreamError(f"native modular batch error {ret}")
    return sec_ret


def decode_icc_native(bs, decoder, enc_size: int) -> bytes:
    """Decode the ICC byte stream in C++; advances bs.pos."""
    from ..utils.errors import JxlBitstreamError

    lib = get_lib()
    lib.jxlhost_decode_icc.restype = ctypes.c_int
    tables = DecoderTables.cached(decoder)
    out = np.zeros(enc_size, dtype=np.uint8)
    bit_pos = ctypes.c_uint64(bs.pos)
    data = bs.data

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    ret = lib.jxlhost_decode_icc(
        ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(len(data)),
        ctypes.byref(bit_pos),
        ip(tables.header), ip(tables.cluster_map), ip(tables.cfgs),
        ip(tables.ans_meta), ip(tables.ans_blob),
        ip(tables.pfx_meta), ip(tables.pfx_blob),
        ctypes.c_uint64(enc_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if ret != 0:
        from ..utils.errors import JxlEofError

        if ret == 4:
            raise JxlEofError("ICC stream truncated (native)")
        raise JxlBitstreamError(f"native ICC decode error {ret}")
    bs.pos = bit_pos.value
    return out.tobytes()


def decode_hf_group_native(
    bs, hf_dist, ctx_offset: int, *, hf_block_ctx, block_sel, block_mul,
    hshifts, vshifts, lf_quant, orders_packed, coeff_shift, out_planes
) -> None:
    """Native write_hf_coeff inner loop. Mutates out_planes; advances bs.pos.

    orders_packed: (offsets [13*3] i32, lengths [13*3] i32, blob i32) —
    concatenated (x, y) coefficient-order pairs per (order_id, channel),
    prebuilt once per HfPass (models/vardct.write_hf_coeff).
    """
    from ..utils.errors import JxlBitstreamError, JxlEofError

    lib = get_lib()
    lib.jxlhost_decode_hf_group.restype = ctypes.c_int
    tables = DecoderTables.cached(hf_dist)

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    packed_ctx = getattr(hf_block_ctx, "_native_packed", None)
    if packed_ctx is None:
        qf_thr = np.asarray(hf_block_ctx.qf_thresholds, dtype=np.int32)
        lf_thr_counts = np.array(
            [len(t) for t in hf_block_ctx.lf_thresholds], dtype=np.int32
        )
        lf_thr_all = np.asarray(
            [v for t in hf_block_ctx.lf_thresholds for v in t] or [0],
            dtype=np.int32,
        )
        bcm = np.asarray(hf_block_ctx.block_ctx_map, dtype=np.int32)
        packed_ctx = (qf_thr, lf_thr_counts, lf_thr_all, bcm)
        hf_block_ctx._native_packed = packed_ctx
    qf_thr, lf_thr_counts, lf_thr_all, bcm = packed_ctx

    sel = np.ascontiguousarray(block_sel, dtype=np.int8)
    mul = np.ascontiguousarray(block_mul, dtype=np.int32)
    gh, gw = sel.shape

    hs_arr = np.asarray(hshifts, dtype=np.int32)
    vs_arr = np.asarray(vshifts, dtype=np.int32)

    lf_ptrs = (ctypes.POINTER(ctypes.c_int32) * 3)()
    lf_strides = np.zeros(3, dtype=np.int64)
    keep = []
    if lf_quant is not None:
        for c in range(3):
            p = np.ascontiguousarray(lf_quant[c], dtype=np.int32) \
                if lf_quant[c].strides[1] != 4 else lf_quant[c]
            keep.append(p)
            lf_ptrs[c] = p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            lf_strides[c] = p.strides[0] // 4

    offsets, lengths, blob = orders_packed

    out_ptrs = (ctypes.POINTER(ctypes.c_int32) * 3)()
    out_strides = np.zeros(3, dtype=np.int64)
    for c in range(3):
        v = out_planes[c]
        assert v.dtype == np.int32 and v.strides[1] == 4
        out_ptrs[c] = v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        out_strides[c] = v.strides[0] // 4

    bit_pos = ctypes.c_uint64(bs.pos)
    data = bs.data
    with native_budget(), span("Native", fn="decode_hf_group_native"):
        ret = lib.jxlhost_decode_hf_group(
        ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(len(data)),
        ctypes.byref(bit_pos),
        ip(tables.header), ip(tables.cluster_map), ip(tables.cfgs),
        ip(tables.ans_meta), ip(tables.ans_blob),
        ip(tables.pfx_meta), ip(tables.pfx_blob),
        ctypes.c_int64(ctx_offset),
        ip(qf_thr), ctypes.c_int32(len(qf_thr)),
        ip(lf_thr_all), ip(lf_thr_counts),
        ip(bcm), ctypes.c_int32(hf_block_ctx.num_block_clusters),
        sel.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
        ip(mul),
        ctypes.c_int32(gw), ctypes.c_int32(gh),
        ctypes.c_int64(sel.strides[0]),
        ip(hs_arr), ip(vs_arr),
        lf_ptrs, lf_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ip(offsets), ip(blob), ip(lengths),
        ctypes.c_int32(coeff_shift),
        out_ptrs, out_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if ret != 0:
        if ret == 4:
            raise JxlEofError("HF stream truncated (native)")
        raise_native_oom(ret)
        raise JxlBitstreamError(f"native HF decode error {ret}")
    bs.pos = bit_pos.value


def decode_hf_groups_batch(
    *, pass_tables, pass_orders, num_hf_presets: int, pass_coeff_shifts,
    hf_block_ctx, hshifts, vshifts, sections, jobs, n_threads: int,
):
    """Decode ALL pass-group HF sections of a frame in ONE native call
    with a C++ thread pool (jxlhost_decode_hf_groups_batch): groups fan
    out across threads, passes within a group stay sequential. No Python
    runs between symbols, so the host stage scales with cores instead of
    with the GIL.

    pass_tables: DecoderTables per pass. pass_orders: (offsets, lengths,
    blob) per pass (all order_ids used by ANY group). sections: list of
    (data: bytes, pass_idx, sel_i8, mul_i32, gw, gh, grid_stride,
    lf_quant_list_or_None, out_planes) in job order; jobs: (start, count)
    runs of sections sharing a group. Returns the per-section end bit
    positions (uint64 array) for the modular sub-streams; raises on the
    first failed section.
    """
    from ..utils.errors import JxlBitstreamError, JxlEofError, JxlValidationError

    lib = get_lib()
    lib.jxlhost_decode_hf_groups_batch.restype = ctypes.c_int

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    n_passes = len(pass_tables)
    n = len(sections)
    VP = ctypes.c_void_p

    pass_specs = (VP * (n_passes * 7))()
    pass_ord = (VP * (n_passes * 3))()
    for p, t in enumerate(pass_tables):
        for i, arr in enumerate((t.header, t.cluster_map, t.cfgs,
                                 t.ans_meta, t.ans_blob,
                                 t.pfx_meta, t.pfx_blob)):
            pass_specs[p * 7 + i] = arr.ctypes.data
        offsets, lengths, blob = pass_orders[p]
        pass_ord[p * 3] = offsets.ctypes.data
        pass_ord[p * 3 + 1] = blob.ctypes.data
        pass_ord[p * 3 + 2] = lengths.ctypes.data
    nhp_arr = np.full(n_passes, num_hf_presets, dtype=np.int32)
    shift_arr = np.asarray(pass_coeff_shifts, dtype=np.int32)

    packed_ctx = getattr(hf_block_ctx, "_native_packed", None)
    if packed_ctx is None:
        qf_thr = np.asarray(hf_block_ctx.qf_thresholds, dtype=np.int32)
        lf_thr_counts = np.array(
            [len(t) for t in hf_block_ctx.lf_thresholds], dtype=np.int32
        )
        lf_thr_all = np.asarray(
            [v for t in hf_block_ctx.lf_thresholds for v in t] or [0],
            dtype=np.int32,
        )
        bcm = np.asarray(hf_block_ctx.block_ctx_map, dtype=np.int32)
        packed_ctx = (qf_thr, lf_thr_counts, lf_thr_all, bcm)
        hf_block_ctx._native_packed = packed_ctx
    qf_thr, lf_thr_counts, lf_thr_all, bcm = packed_ctx
    hs_arr = np.asarray(hshifts, dtype=np.int32)
    vs_arr = np.asarray(vshifts, dtype=np.int32)

    sec_data = (ctypes.c_char_p * n)()
    sec_len = np.zeros(n, dtype=np.uint64)
    sec_bit_pos = np.zeros(n, dtype=np.uint64)
    sec_pass = np.zeros(n, dtype=np.int32)
    sec_sel = (VP * n)()
    sec_mul = (VP * n)()
    sec_gw = np.zeros(n, dtype=np.int32)
    sec_gh = np.zeros(n, dtype=np.int32)
    sec_stride = np.zeros(n, dtype=np.int64)
    sec_lf_ptrs = (VP * (n * 3))()
    sec_lf_strides = np.zeros(n * 3, dtype=np.int64)
    sec_out_ptrs = (VP * (n * 3))()
    sec_out_strides = np.zeros(n * 3, dtype=np.int64)
    sec_ret = np.zeros(n, dtype=np.int32)
    keep = []  # pin every converted array for the call's lifetime

    for k, (data, p_idx, sel, mul, gw, gh, stride, lf_quant, outs) in (
        enumerate(sections)
    ):
        sec_data[k] = data
        keep.append(data)
        sec_len[k] = len(data)
        sec_pass[k] = p_idx
        sec_sel[k] = sel.ctypes.data
        sec_mul[k] = mul.ctypes.data
        keep.append(sel)
        keep.append(mul)
        sec_gw[k] = gw
        sec_gh[k] = gh
        sec_stride[k] = stride
        if lf_quant is not None:
            for c in range(3):
                q = lf_quant[c]
                if q.strides[1] != 4:
                    q = np.ascontiguousarray(q, dtype=np.int32)
                keep.append(q)
                sec_lf_ptrs[k * 3 + c] = q.ctypes.data
                sec_lf_strides[k * 3 + c] = q.strides[0] // 4
        for c in range(3):
            v = outs[c]
            assert v.dtype == np.int32 and v.strides[1] == 4
            keep.append(v)
            sec_out_ptrs[k * 3 + c] = v.ctypes.data
            sec_out_strides[k * 3 + c] = v.strides[0] // 4

    job_start = np.asarray([s for s, _ in jobs], dtype=np.int32)
    job_count = np.asarray([c for _, c in jobs], dtype=np.int32)

    with native_budget():
        ret = lib.jxlhost_decode_hf_groups_batch(
        ctypes.c_int32(n_passes),
        pass_specs, pass_ord,
        ip(nhp_arr), ip(shift_arr),
        ip(qf_thr), ctypes.c_int32(len(qf_thr)),
        ip(lf_thr_all), ip(lf_thr_counts),
        ip(bcm), ctypes.c_int32(hf_block_ctx.num_block_clusters),
        ip(hs_arr), ip(vs_arr),
        ctypes.c_int32(n),
        sec_data, sec_len.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        sec_bit_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ip(sec_pass),
        sec_sel, sec_mul,
        ip(sec_gw), ip(sec_gh),
        sec_stride.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sec_lf_ptrs,
        sec_lf_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sec_out_ptrs,
        sec_out_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(len(jobs)), ip(job_start), ip(job_count),
        ctypes.c_int32(n_threads),
        ip(sec_ret),
    )
    del keep
    if ret != 0:  # pragma: no cover - ABI-level failure only
        raise JxlBitstreamError(f"native HF batch error {ret}")
    bad = np.nonzero(sec_ret > 0)[0]
    if bad.size:
        code = int(sec_ret[bad[0]])
        if code == 4:
            raise JxlEofError("HF stream truncated (native)")
        if code == 7:
            raise JxlValidationError("selected HF preset out of bounds")
        raise_native_oom(code)
        raise JxlBitstreamError(f"native HF decode error {code}")
    return sec_bit_pos


class _ParsedTables:
    """DecoderTables-compatible views over a native parse buffer."""

    __slots__ = ("header", "cluster_map", "cfgs", "ans_meta", "ans_blob",
                 "pfx_meta", "pfx_blob", "_buf")


def parse_decoder_native(bs, num_dist: int, allow_lz77: bool):
    """Parse entropy-decoder tables (lz77 config, cluster map, ANS/prefix
    histograms) in C++ (jxlhost_parse_decoder). Returns a dict of decoder
    fields + a _ParsedTables ready for the decode entry points, or raises
    JxlBitstreamError. Advances bs.pos.

    Buffer layout (i32): [lz77, min_symbol, min_length, len_cfg*3,
    num_dist_total, num_clusters, use_prefix, log_alphabet] then
    cluster_map[num_dist_total], cfgs[num_clusters*3],
    per-histogram meta pairs[num_clusters*2], blob_len, blob[...]."""
    from ..utils.errors import JxlBitstreamError, JxlEofError

    lib = get_lib()
    lib.jxlhost_parse_decoder.restype = ctypes.c_int
    out_buf = ctypes.POINTER(ctypes.c_int32)()
    out_len = ctypes.c_int64()
    bit_pos = ctypes.c_uint64(bs.pos)
    data = bs.data
    with span("Native", fn="parse_decoder_native"):
        ret = lib.jxlhost_parse_decoder(
            ctypes.cast(ctypes.c_char_p(data),
                        ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_uint64(len(data)),
            ctypes.byref(bit_pos),
            ctypes.c_int32(num_dist),
            ctypes.c_int32(1 if allow_lz77 else 0),
            ctypes.byref(out_buf),
            ctypes.byref(out_len),
        )
    if ret == 4:
        raise JxlEofError("entropy header truncated (native)")
    if ret == 150:
        raise JxlBitstreamError("LZ77 not allowed in this stream")
    if ret != 0:
        raise JxlBitstreamError(f"entropy header parse error {ret} (native)")
    try:
        buf = np.ctypeslib.as_array(out_buf, shape=(out_len.value,)).copy()
    finally:
        lib.jxlhost_free_i32(out_buf)
    bs.pos = bit_pos.value

    header = buf[:10]
    lz77, min_symbol, min_length = int(header[0]), int(header[1]), int(header[2])
    len_cfg = (int(header[3]), int(header[4]), int(header[5]))
    num_dist_total = int(header[6])
    num_clusters = int(header[7])
    use_prefix = bool(header[8])
    log_alphabet = int(header[9])
    off = 10
    cluster_map = buf[off : off + num_dist_total]
    off += num_dist_total
    cfgs = buf[off : off + num_clusters * 3].reshape(num_clusters, 3)
    off += num_clusters * 3
    meta = buf[off : off + num_clusters * 2]
    off += num_clusters * 2
    blob_len = int(buf[off])
    off += 1
    blob = buf[off : off + blob_len]

    t = _ParsedTables()
    t._buf = buf
    t.header = np.ascontiguousarray(header)
    t.cluster_map = np.ascontiguousarray(cluster_map)
    t.cfgs = np.ascontiguousarray(buf[10 + num_dist_total
                                      : 10 + num_dist_total + num_clusters * 3])
    t.ans_meta = np.zeros(2, dtype=np.int32)
    t.ans_blob = np.zeros(1, dtype=np.int32)
    t.pfx_meta = np.zeros(2, dtype=np.int32)
    t.pfx_blob = np.zeros(1, dtype=np.int32)
    if use_prefix:
        t.pfx_meta = np.ascontiguousarray(meta)
        t.pfx_blob = np.ascontiguousarray(blob)
    else:
        t.ans_meta = np.ascontiguousarray(meta)
        t.ans_blob = np.ascontiguousarray(blob)

    return {
        "lz77_enabled": bool(lz77),
        "min_symbol": min_symbol,
        "min_length": min_length,
        "len_cfg": len_cfg,
        "num_clusters": num_clusters,
        "use_prefix": use_prefix,
        "log_alphabet_size": log_alphabet,
        "cluster_map": cluster_map,
        "cfgs": cfgs,
        "meta": meta.reshape(num_clusters, 2),
        "blob": blob,
        "tables": t,
    }


def serialize_ma_raw_nodes(ma_config) -> np.ndarray:
    """MaConfig raw tree -> int32 [n, 8] (property, value, left, right,
    cluster, predictor, offset, multiplier) for the C++ flattener
    (jxlhost_decode_lf_groups_batch). Cached on the config."""
    cached = getattr(ma_config, "_native_raw_nodes", None)
    if cached is not None:
        return cached
    nodes = ma_config.nodes
    out = np.zeros((max(len(nodes), 1), 8), dtype=np.int32)
    for i, nd in enumerate(nodes):
        out[i] = (nd.property, nd.value, nd.left, nd.right,
                  nd.cluster, nd.predictor, nd.offset, nd.multiplier)
    ma_config._native_raw_nodes = out
    return out


def decode_lf_groups_batch(
    *, ma_config, num_lf_groups: int, hshifts, vshifts,
    epf, quantizer_global_scale: int, select_sizes, group_blocks: int,
    sections, n_threads: int,
):
    """Decode many LF-group sections (LfCoeff + HfMetadata) in ONE native
    call: modular header + local MA tree parse + channel decode + varblock
    placement + EPF sigma all happen in C++ on the worker pool (the stage
    that capped host thread scaling under the GIL; VERDICT r3 item 2).

    sections: list of dicts with keys
      data (bytes), lf_idx, bw, bh, w64, h64, has_lf_coeff,
      lf_views (3 int32 strided views, STREAM order y/x/b),
      xfy, bfy (int32 [h64, w64]), sel (int8 [bh, bw]),
      mul (int32 [bh, bw]), sigma (float32 [bh, bw]).
    epf: None or (quant_mul, sharp_lut).
    Returns (sec_ret, extra_precision) int32 arrays — ret 0 = decoded,
    anything else = re-decode that section in Python."""
    lib = get_lib()
    n = len(sections)

    if ma_config is not None:
        gnodes = serialize_ma_raw_nodes(ma_config)
        n_gnodes = len(ma_config.nodes)
        gt = DecoderTables.cached(ma_config.decoder_template)
    else:
        gnodes = np.zeros((1, 8), dtype=np.int32)
        n_gnodes = 0
        gt = None

    sec_data = (ctypes.c_char_p * n)()
    sec_len = np.zeros(n, dtype=np.uint64)
    sec_meta = np.zeros(n * 6, dtype=np.int32)
    lf_dims = np.zeros(n * 6, dtype=np.int32)
    lf_bufs = (ctypes.c_void_p * (n * 3))()
    lf_strides = np.zeros(n * 3, dtype=np.int64)
    xfy_bufs = (ctypes.c_void_p * n)()
    bfy_bufs = (ctypes.c_void_p * n)()
    sel_bufs = (ctypes.c_void_p * n)()
    mul_bufs = (ctypes.c_void_p * n)()
    sigma_bufs = (ctypes.c_void_p * n)()
    out_ep = np.zeros(n, dtype=np.int32)
    out_bit_pos = np.zeros(n, dtype=np.uint64)
    sec_ret = np.zeros(n, dtype=np.int32)
    keepalive = []

    for k, s in enumerate(sections):
        data = s["data"]
        keepalive.append(data)
        sec_data[k] = data
        sec_len[k] = len(data)
        sec_meta[k * 6: k * 6 + 6] = (
            s["lf_idx"], s["bw"], s["bh"], s["w64"], s["h64"],
            1 if s["has_lf_coeff"] else 0,
        )
        for j, v in enumerate(s["lf_views"]):
            assert v.dtype == np.int32 and v.strides[1] == 4
            lf_dims[k * 6 + j * 2] = v.shape[1]
            lf_dims[k * 6 + j * 2 + 1] = v.shape[0]
            lf_bufs[k * 3 + j] = v.ctypes.data
            lf_strides[k * 3 + j] = v.strides[0] // 4
        xfy_bufs[k] = s["xfy"].ctypes.data
        bfy_bufs[k] = s["bfy"].ctypes.data
        sel_bufs[k] = s["sel"].ctypes.data
        mul_bufs[k] = s["mul"].ctypes.data
        sigma_bufs[k] = s["sigma"].ctypes.data

    hsh = np.asarray(hshifts, dtype=np.int32)
    vsh = np.asarray(vshifts, dtype=np.int32)
    if epf is not None:
        quant_mul, sharp_lut = epf
        sigma_base = float(quant_mul) * 65536.0 / quantizer_global_scale
        lut = np.asarray(sharp_lut, dtype=np.float64)
        epf_enabled = 1
    else:
        sigma_base = 0.0
        lut = np.zeros(8, dtype=np.float64)
        epf_enabled = 0
    sizes = np.ascontiguousarray(
        np.asarray(select_sizes, dtype=np.int32).reshape(-1)
    )

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def zt():
        z = np.zeros(1, dtype=np.int32)
        keepalive.append(z)
        return ip(z)

    if gt is not None:
        g_args = (ip(gt.header), ip(gt.cluster_map), ip(gt.cfgs),
                  ip(gt.ans_meta), ip(gt.ans_blob), ip(gt.pfx_meta),
                  ip(gt.pfx_blob))
    else:
        g_args = (zt(), zt(), zt(), zt(), zt(), zt(), zt())

    with native_budget(), span("Native", fn="decode_lf_groups_batch"):
        lib.jxlhost_decode_lf_groups_batch(
            ip(gnodes), ctypes.c_int64(n_gnodes),
            *g_args,
            ctypes.c_int32(num_lf_groups),
            hsh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vsh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(epf_enabled), ctypes.c_double(sigma_base),
            lut.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ip(sizes), ctypes.c_int32(len(sizes) // 2),
            ctypes.c_int32(group_blocks),
            ctypes.c_int32(n),
            ctypes.cast(sec_data, ctypes.POINTER(ctypes.c_char_p)),
            sec_len.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ip(sec_meta),
            ip(lf_dims),
            ctypes.cast(lf_bufs, ctypes.POINTER(ctypes.c_void_p)),
            lf_strides.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.cast(xfy_bufs, ctypes.POINTER(ctypes.c_void_p)),
            ctypes.cast(bfy_bufs, ctypes.POINTER(ctypes.c_void_p)),
            ctypes.cast(sel_bufs, ctypes.POINTER(ctypes.c_void_p)),
            ctypes.cast(mul_bufs, ctypes.POINTER(ctypes.c_void_p)),
            ctypes.cast(sigma_bufs, ctypes.POINTER(ctypes.c_void_p)),
            ip(out_ep),
            out_bit_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ip(sec_ret),
            ctypes.c_int32(n_threads),
        )
    del keepalive
    return sec_ret, out_ep


def zeroed_planes(shapes, dtype=np.int32):
    """Allocate + zero a list of planes, pre-faulting the pages with the
    worker pool when the native library is available (a fresh multi-
    hundred-MB np.zeros otherwise pays its page faults lazily inside the
    decode's write path). Falls back to np.zeros."""
    lib = get_lib()
    arrays = [np.empty(s, dtype=dtype) for s in shapes]
    if lib is None or not hasattr(lib, "jxlhost_memzero_batch"):
        for a in arrays:
            a[...] = 0
        return arrays
    from ..utils.threads import num_workers

    n = len(arrays)
    ptrs = (ctypes.c_void_p * n)()
    sizes = np.zeros(n, dtype=np.uint64)
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data
        sizes[i] = a.nbytes
    total_mb = int(sizes.sum() >> 20)
    with span("Native", fn="zeroed_planes"):
        lib.jxlhost_memzero_batch(
            ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int32(n),
            ctypes.c_int32(num_workers(max(1, total_mb // 4))),
        )
    return arrays


def decode_hf_groups_batch_raw(
    *, pass_tables, pass_orders, num_hf_presets: int, pass_coeff_shifts,
    hf_block_ctx, hshifts, vshifts,
    n_sections: int,
    sec_data_ptrs, sec_len, sec_pass,
    sec_sel_ptrs, sec_mul_ptrs, sec_gw, sec_gh, sec_stride,
    sec_lf_ptrs, sec_lf_strides, sec_out_ptrs, sec_out_strides,
    job_start, job_count, n_threads: int, keepalive=(),
):
    """decode_hf_groups_batch with PRE-COMPUTED numpy pointer/geometry
    arrays (uint64 pointers, int64 strides, int32 meta): the caller
    vectorizes the per-group view arithmetic instead of building 9-tuple
    sections in a Python loop — on a 256-group frame the old prep +
    marshalling loops were ~10 ms of serial Python in front of the
    GIL-free batch. Returns per-section end bit positions."""
    from ..utils.errors import JxlBitstreamError, JxlEofError, JxlValidationError

    lib = get_lib()
    lib.jxlhost_decode_hf_groups_batch.restype = ctypes.c_int

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def pp(a):  # uint64 pointer array -> void**
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p))

    def lp(a):  # int64 array
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def up(a):  # uint64 array
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))

    n_passes = len(pass_tables)
    VP = ctypes.c_void_p
    pass_specs = (VP * (n_passes * 7))()
    pass_ord = (VP * (n_passes * 3))()
    for p, t in enumerate(pass_tables):
        for i, arr in enumerate((t.header, t.cluster_map, t.cfgs,
                                 t.ans_meta, t.ans_blob,
                                 t.pfx_meta, t.pfx_blob)):
            pass_specs[p * 7 + i] = arr.ctypes.data
        offsets, lengths, blob = pass_orders[p]
        pass_ord[p * 3] = offsets.ctypes.data
        pass_ord[p * 3 + 1] = blob.ctypes.data
        pass_ord[p * 3 + 2] = lengths.ctypes.data
    nhp_arr = np.full(n_passes, num_hf_presets, dtype=np.int32)
    shift_arr = np.asarray(pass_coeff_shifts, dtype=np.int32)

    packed_ctx = getattr(hf_block_ctx, "_native_packed", None)
    if packed_ctx is None:
        qf_thr = np.asarray(hf_block_ctx.qf_thresholds, dtype=np.int32)
        lf_thr_counts = np.array(
            [len(t) for t in hf_block_ctx.lf_thresholds], dtype=np.int32
        )
        lf_thr_all = np.asarray(
            [v for t in hf_block_ctx.lf_thresholds for v in t] or [0],
            dtype=np.int32,
        )
        bcm = np.asarray(hf_block_ctx.block_ctx_map, dtype=np.int32)
        packed_ctx = (qf_thr, lf_thr_counts, lf_thr_all, bcm)
        hf_block_ctx._native_packed = packed_ctx
    qf_thr, lf_thr_counts, lf_thr_all, bcm = packed_ctx
    hs_arr = np.asarray(hshifts, dtype=np.int32)
    vs_arr = np.asarray(vshifts, dtype=np.int32)
    sec_bit_pos = np.zeros(n_sections, dtype=np.uint64)
    sec_ret = np.zeros(n_sections, dtype=np.int32)

    with native_budget(), span("Native", fn="decode_hf_groups_batch_raw"):
        ret = lib.jxlhost_decode_hf_groups_batch(
            ctypes.c_int32(n_passes),
            pass_specs, pass_ord,
            ip(nhp_arr), ip(shift_arr),
            ip(qf_thr), ctypes.c_int32(len(qf_thr)),
            ip(lf_thr_all), ip(lf_thr_counts),
            ip(bcm), ctypes.c_int32(hf_block_ctx.num_block_clusters),
            ip(hs_arr), ip(vs_arr),
            ctypes.c_int32(n_sections),
            pp(sec_data_ptrs), up(sec_len), up(sec_bit_pos),
            ip(sec_pass),
            pp(sec_sel_ptrs), pp(sec_mul_ptrs),
            ip(sec_gw), ip(sec_gh), lp(sec_stride),
            pp(sec_lf_ptrs), lp(sec_lf_strides),
            pp(sec_out_ptrs), lp(sec_out_strides),
            ctypes.c_int32(len(job_start)), ip(job_start), ip(job_count),
            ctypes.c_int32(n_threads),
            ip(sec_ret),
        )
    del keepalive
    if ret != 0:  # pragma: no cover - ABI-level failure only
        raise JxlBitstreamError(f"native HF batch error {ret}")
    bad = np.nonzero(sec_ret > 0)[0]
    if bad.size:
        code = int(sec_ret[bad[0]])
        if code == 4:
            raise JxlEofError("HF stream truncated (native)")
        if code == 7:
            raise JxlValidationError("selected HF preset out of bounds")
        raise_native_oom(code)
        raise JxlBitstreamError(f"native HF decode error {code}")
    return sec_bit_pos
