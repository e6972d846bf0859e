"""The noise field's plain version: the XorShift128+ walk of every
noise group's 8 lanes, in numpy (jxl-render features/noise.rs:403-452;
jxl_oxide_tpu/render/features.py `_split_mix_64`, `_xorshift_batches`,
`_noise_field`).

K12 (csrc/noise.cu, wrapper ops/cuda/noise.py) computes the same field on
the card; this module is what the CPU path and the tests run, and what
chip_smoke.py holds K12 against. The state stays numpy uint64: torch's
uint64 lacks shifts and xor on several backends, and int64 arithmetic
shifts would sign-extend.
"""

from __future__ import annotations

import numpy as np

__all__ = ["N_LANES", "noise_field_plain", "noise_groups", "noise_seed0",
           "noise_steps"]

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
