"""The modular inverse transforms on int32 tensors: RCT, palette, squeeze.

Behavioral parity: jxl-modular/src/transform/{rct.rs, palette.rs,
squeeze.rs}; the torch twins of jxl_oxide_tpu/ops/modular_tail.py, bit
for bit: every sum and product wraps at i32 (torch's int32 ops wrap
two's-complement, as jnp's do), the tendency's divisions truncate toward
zero, and `//` and `%` floor, as in jnp.

RCT and palette are elementwise work and a gather, and stay torch ops.
The squeeze recurrence is sequential along the squeezed axis (out[2x+1]
feeds the tendency at x+1): `inv_squeeze_h` / `inv_squeeze_v` here walk it
in a Python loop over the axis, one column of ops per step. That is the
plain version of the hand-written CUDA kernel (csrc/modular_squeeze.cu,
wrapper ops/cuda/squeeze.py), which the decode calls; these run only for
tensors on the CPU and to check the kernel on the card.
"""

from __future__ import annotations

import torch

__all__ = [
    "inv_rct",
    "inv_squeeze_h",
    "inv_squeeze_v",
    "palette_lookup",
]


def _trunc_div2(v: torch.Tensor) -> torch.Tensor:
    # trunc-toward-zero division by 2 on i32: add the sign bit, then
    # arithmetic shift (exact for every value incl. INT32_MIN)
    return (v + ((v >> 31) & 1)) >> 1


def _trunc_div_i32(v: torch.Tensor, d: int) -> torch.Tensor:
    """Exact trunc-toward-zero division of i32 by a positive constant:
    floor-divide, then bump negative inexact quotients (valid for every
    i32 incl. INT32_MIN)."""
    q = torch.div(v, d, rounding_mode="floor")
    r = v - q * d
    return q + ((v < 0) & (r != 0)).to(v.dtype)


def _tendency(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """squeeze.rs tendency_i32 on i32 tensors (wrapping mul/add; the /12
    divisions truncate toward zero)."""
    two_ab = 2 * (a - b)
    two_bc = 2 * (b - c)

    num1 = 4 * a - 3 * c - b + 6
    x1 = _trunc_div_i32(num1, 12)
    x1 = torch.where((x1 - (x1 & 1)) > two_ab, two_ab + 1, x1)
    x1 = torch.where((x1 + (x1 & 1)) > two_bc, two_bc, x1)

    num2 = 4 * a - 3 * c - b - 6
    x2 = _trunc_div_i32(num2, 12)
    x2 = torch.where((x2 + (x2 & 1)) < two_ab, two_ab - 1, x2)
    x2 = torch.where((x2 - (x2 & 1)) < two_bc, two_bc, x2)

    return torch.where(
        (a >= b) & (b >= c), x1,
        torch.where((a <= b) & (b <= c), x2, torch.zeros_like(a)),
    )


def _inv_squeeze_h_core(avg, residu, next_cols):
    """avg [h, aw] i32, residu [h, rw], next_cols [h, rw] (= avg[:, x+1]
    clamped); returns (firsts, seconds), each [h, rw]: the recurrence of
    jxl_oxide_tpu's lax.scan, one column per step."""
    left = avg[:, 0]
    firsts, seconds = [], []
    for x in range(residu.shape[1]):
        a = avg[:, x]
        diff = residu[:, x] + _tendency(left, a, next_cols[:, x])
        first = a + _trunc_div2(diff)
        second = first - diff
        firsts.append(first)
        seconds.append(second)
        left = second
    return torch.stack(firsts, dim=1), torch.stack(seconds, dim=1)


def inv_squeeze_h(avg: torch.Tensor, residu: torch.Tensor) -> torch.Tensor:
    """Horizontal un-squeeze (squeeze.rs inverse_h): avg (w+1)//2 wide,
    residu w//2 wide -> [h, w] int32 on their device."""
    avg = avg.to(torch.int32)
    residu = residu.to(torch.int32)
    h, aw = avg.shape
    rw = residu.shape[1]
    w = aw + rw
    if rw == 0:
        return avg
    if aw > rw:
        next_cols = avg[:, 1 : rw + 1]
    else:
        next_cols = torch.cat([avg[:, 1:rw], avg[:, rw - 1 : rw]], dim=1)
    firsts, seconds = _inv_squeeze_h_core(avg, residu, next_cols)
    out = torch.stack([firsts, seconds], dim=2).reshape(h, 2 * rw)
    if w % 2 == 1:
        out = torch.cat([out, avg[:, aw - 1 : aw]], dim=1)
    return out


def inv_squeeze_v(avg: torch.Tensor, residu: torch.Tensor) -> torch.Tensor:
    """Vertical un-squeeze: the horizontal recurrence on transposed planes
    (squeeze.rs inverse_v)."""
    return inv_squeeze_h(avg.t(), residu.t()).t().contiguous()


def inv_rct(a, b, c, rct_type: int):
    """Inverse RCT (transform/rct.rs:15-201): permutation(6) x kind(7),
    wrapping i32. Returns the 3 output planes in slot order."""
    perm, ty = rct_type // 7, rct_type % 7
    a = a.to(torch.int32)
    bb = b.to(torch.int32)
    c = c.to(torch.int32)
    if ty == 6:  # YCoCg
        tmp = a - (c >> 1)
        e = c + tmp
        f = tmp - (bb >> 1)
        d = f + bb
    else:
        d = a
        f = c + a if (ty & 1) else c
        if (ty >> 1) == 1:
            e = bb + a
        elif (ty >> 1) == 2:
            e = bb + ((a + f) >> 1)
        else:
            e = bb
    out = [d, e, f]
    # inverse permutation (rct.rs inverse_permute; the swap sequence of
    # models/modular_transform.py Rct.inverse)
    if perm == 1:
        out[0], out[1] = out[1], out[0]
        out[0], out[2] = out[2], out[0]
    elif perm == 2:
        out[0], out[1] = out[1], out[0]
        out[1], out[2] = out[2], out[1]
    elif perm == 3:
        out[1], out[2] = out[2], out[1]
    elif perm == 4:
        out[0], out[1] = out[1], out[0]
    elif perm == 5:
        out[0], out[2] = out[2], out[0]
    return out[0], out[1], out[2]


def palette_lookup(palette, index_grid, delta_palette, num_c: int,
                   nb_colours: int, nb_deltas: int, bit_depth: int):
    """Inverse palette WITHOUT predictor-assisted deltas (d_pred == 0: the
    Zero predictor contributes nothing, so delta entries reduce to the
    plain delta-palette lookup): in-range gather + the synthetic small and
    large palettes + kDeltaPalette (transform/palette.rs:27-173).

    palette [num_c, nb_colours], index_grid [h, w] and delta_palette
    [72, 3], int32 on one device. Returns num_c [h, w] int32 planes.
    nb_deltas is part of the signature of the JAX twin and unused there
    too."""
    idx = index_grid.to(torch.int32)
    palette = palette.to(torch.int32)
    zeros = torch.zeros_like(idx)
    in_pal = (idx >= 0) & (idx < nb_colours)
    hi = idx >= nb_colours
    neg = idx < 0
    safe_idx = torch.clamp(idx, 0, max(nb_colours - 1, 0)).long()
    outs = []
    for c in range(num_c):
        # jnp's gather clamps; torch's raises on an empty palette, where
        # no index is in range anyway
        if nb_colours > 0:
            out = torch.where(in_pal, palette[c][safe_idx], zeros)
        else:
            out = zeros
        # synthetic palettes for indices >= nb_colours. hidx < 2^31, so
        # for channel indices whose shift / power-of-5 exceeds the i32
        # range the quotient is statically zero
        hidx = torch.clamp_min(idx - nb_colours, 0)
        small = hidx < 64
        sh = 2 * c
        shifted = (hidx >> sh) if sh <= 30 else torch.zeros_like(hidx)
        # multiply-then-divide grouping matches the host exactly; the
        # products stay inside i32 because the device envelope caps
        # bit_depth < 28 (models/modular.py _device_tail_supported)
        vs = (shifted % 4) * ((1 << bit_depth) - 1) // 4 + (
            1 << max(0, bit_depth - 3)
        )
        hb = torch.clamp_min(hidx - 64, 0)
        p5 = 5 ** c
        if p5 < (1 << 31):
            vb = ((hb // p5) % 5) * ((1 << bit_depth) - 1) // 4
        else:
            vb = torch.zeros_like(hb)
        out = torch.where(hi, torch.where(small, vs, vb).to(torch.int32), out)
        if c < 3:
            nidx = (-(idx + 1)) % 143
            v = delta_palette[((nidx + 1) >> 1).long(), c].to(torch.int32)
            v = torch.where(nidx & 1 == 0, -v, v)
            if bit_depth > 8:
                v = v << (min(bit_depth, 24) - 8)
            out = torch.where(neg, v, out)
        else:
            out = torch.where(neg, zeros, out)
        outs.append(out)
    return tuple(outs)
