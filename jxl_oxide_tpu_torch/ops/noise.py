"""The noise field's plain version: the XorShift128+ walk of every
noise group's 8 lanes, in numpy (jxl-render features/noise.rs:403-452;
jxl_oxide_tpu/render/features.py `_split_mix_64`, `_xorshift_batches`,
`_noise_field`).

K12 (csrc/noise.cu, wrapper ops/cuda/noise.py) computes the same field on
the card; this module is what the CPU path and the tests run, and what
chip_smoke.py holds K12 against. The state stays numpy uint64: torch's
uint64 lacks shifts and xor on several backends, and int64 arithmetic
shifts would sign-extend.

It also builds K12's jump tables. The XorShift128+ step is a linear map
T of the 128-bit state over GF(2) (only the output sum is nonlinear, and
it never feeds back), so with chi its characteristic polynomial (degree
128) the state n steps on is sum_i q_i T^i s for q = x^n mod chi
(Cayley-Hamilton): 128 steps from s and an XOR of the states q selects.
`characteristic_polynomial` finds chi from the recurrence itself
(Berlekamp-Massey over one state bit); `jump_table` lists q for every
segment start j * seg of a lane's walk.
"""

from __future__ import annotations

import functools
import threading

import numpy as np

__all__ = ["N_LANES", "characteristic_polynomial", "jump_table",
           "noise_field_plain", "noise_groups", "noise_seed0", "noise_steps",
           "xorshift_state_step"]

N_LANES = 8
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _split_mix_64(z: np.ndarray) -> np.ndarray:
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def noise_groups(width: int, height: int, group_dim: int) -> list:
    """(x0, y0, gw, gh, wn2) of every group in raster order: wn2 batches
    of 16 u32s cover one row of the group (noise.rs:403-452)."""
    out = []
    for y0 in range(0, height, group_dim):
        for x0 in range(0, width, group_dim):
            gw = min(group_dim, width - x0)
            gh = min(group_dim, height - y0)
            out.append((x0, y0, gw, gh, -(-gw // (N_LANES * 2))))
    return out


def noise_steps(width: int, height: int, group_dim: int) -> int:
    """The serial XorShift128+ steps of the longest lane: wn2 * gh * 3 of
    the first group (the largest)."""
    _, _, _, gh, wn2 = noise_groups(width, height, group_dim)[0]
    return wn2 * gh * 3


def noise_seed0(visible: int, invisible: int) -> int:
    """The frame's seed: visible frames before and at this one, and
    invisible frames since the last keyframe (noise.rs)."""
    return ((visible << 32) + invisible) & 0xFFFFFFFFFFFFFFFF


def noise_field_plain(width: int, height: int, group_dim: int,
                      seed0: int) -> np.ndarray:
    """[3, height, width] float32 uniform noise in [1, 2): the plain
    version of K12, bit for bit the JAX package's `_noise_field`.

    Every group's 8 lanes are one uint64 state array [groups, 8], seeded
    with SplitMix64 from seed0 and the group's (x0, y0), and stepped
    together: one Python loop over the longest group's batches (a group
    with fewer batches ignores the rest). Batch b of a group is 16 u32s
    (each lane's sum, low half first) at flat position 16 b of its
    [3, gh, 16 wn2] block; each u32 becomes the float (bits >> 9) |
    0x3F800000."""
    groups = noise_groups(width, height, group_dim)
    seed1 = np.array([((x0 << 32) + y0) & 0xFFFFFFFFFFFFFFFF
                      for x0, y0, *_ in groups], dtype=np.uint64)
    counts = [wn2 * gh * 3 for _, _, _, gh, wn2 in groups]
    s0 = np.zeros((len(groups), N_LANES), dtype=np.uint64)
    s1 = np.zeros((len(groups), N_LANES), dtype=np.uint64)
    with np.errstate(over="ignore"):
        s0[:, 0] = _split_mix_64(np.uint64(seed0) + _GOLDEN)
        s1[:, 0] = _split_mix_64(seed1 + _GOLDEN)
        for i in range(1, N_LANES):
            s0[:, i] = _split_mix_64(s0[:, i - 1])
            s1[:, i] = _split_mix_64(s1[:, i - 1])
        walk = np.empty((max(counts), len(groups), N_LANES), dtype=np.uint64)
        sh23, sh18, sh5 = np.uint64(23), np.uint64(18), np.uint64(5)
        for b in range(walk.shape[0]):
            np.add(s0, s1, out=walk[b])
            t1 = s0 ^ (s0 << sh23)
            s0, s1 = s1, t1 ^ (s1 ^ (t1 >> sh18) ^ (s1 >> sh5))
    field_arr = np.empty((3, height, width), dtype=np.float32)
    for g, (x0, y0, gw, gh, wn2) in enumerate(groups):
        # little-endian u64 -> 2 u32s each, lane by lane
        bits = np.ascontiguousarray(walk[:counts[g], g]).view("<u4").reshape(
            3, gh, wn2 * N_LANES * 2)
        f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
        field_arr[:, y0:y0 + gh, x0:x0 + gw] = f[:, :, :gw]
    return field_arr


# -- jump-ahead ----------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def xorshift_state_step(s0: int, s1: int) -> tuple[int, int]:
    """The state map of one XorShift128+ step on Python ints (the sum
    s0 + s1 it outputs is left out: it never feeds back)."""
    t1 = s0 ^ ((s0 << 23) & _MASK64)
    return s1, t1 ^ s1 ^ (t1 >> 18) ^ (s1 >> 5)


def _berlekamp_massey(bits: list) -> tuple[int, int]:
    """The connection polynomial C (bit i the coefficient of x^i, C(0) = 1)
    and length of the shortest LFSR over GF(2) that makes `bits`:
    bits[n] = sum_{i=1..length} C_i bits[n - i]."""
    c, b, length, m = 1, 1, 0, 1
    past = 0  # bit i: bits[n - i]
    for n, s in enumerate(bits):
        past = (past << 1) | s
        if (c & past).bit_count() & 1 == 0:
            m += 1
        elif 2 * length <= n:
            c, b = c ^ (b << m), c
            length, m = n + 1 - length, 1
        else:
            c ^= b << m
            m += 1
    return c, length


@functools.cache
def characteristic_polynomial() -> int:
    """chi, the characteristic polynomial of the XorShift128+ state map, as
    an int (bit i the coefficient of x^i; bit 128 set): Berlekamp-Massey
    over the low bit of s0 along 512 steps of a SplitMix64-seeded state.
    The step's minimal polynomial is irreducible of degree 128, so the
    sequence's own has that degree and is chi."""
    with np.errstate(over="ignore"):
        s0 = int(_split_mix_64(np.uint64(1) + _GOLDEN))
        s1 = int(_split_mix_64(np.uint64(2) + _GOLDEN))
    bits = []
    for _ in range(512):
        bits.append(s0 & 1)
        s0, s1 = xorshift_state_step(s0, s1)
    c, length = _berlekamp_massey(bits)
    if length != 128:
        raise AssertionError(f"XorShift128+ recurrence of degree {length}")
    # chi(x) = x^128 C(1/x): C's 129 coefficients reversed
    return int(f"{c:0129b}"[::-1], 2)


_TABLES: dict = {}  # seg -> [q_0, q_seg, q_2seg, ...] as ints
_TABLES_LOCK = threading.Lock()


def jump_table(seg: int, segments: int) -> np.ndarray:
    """[segments, 2] uint64: row j is q = x^(j seg) mod chi, the jump to
    batch j * seg of a lane's walk, its bits 0-63 then 64-127. It depends
    only on seg; each seg's list is kept and extended when a frame needs
    more segments. Each row is the last times x^seg mod chi, reduced one
    set bit above x^127 at a time."""
    if seg <= 0 or segments < 0:
        raise ValueError(f"jump table of {segments} segments of {seg}")
    chi = characteristic_polynomial()
    with _TABLES_LOCK:
        qs = _TABLES.setdefault(seg, [1])
        while len(qs) < segments:
            v = qs[-1] << seg
            while v >> 128:
                v ^= chi << (v.bit_length() - 129)
            qs.append(v)
        rows = qs[:segments]
    out = np.empty((segments, 2), dtype=np.uint64)
    out[:, 0] = [q & _MASK64 for q in rows]
    out[:, 1] = [q >> 64 for q in rows]
    return out
