"""The port's modular inverse transforms (jxl_oxide_tpu_torch/ops/
modular_tail.py) against their JAX twins (jxl_oxide_tpu/ops/
modular_tail.py), bit for bit, on the same numpy-seeded int32 inputs:
the truncating divisions and the tendency at the INT32 edges, the squeeze
recurrence on odd and even widths (no residual included), all 42 RCT
types on values that wrap, and the palette's in-range, synthetic and
delta entries at bit depths 8, 12, 16 and 27. Also the kernel wrapper
(ops/cuda/squeeze.py) on the CPU: the plain version, uncounted, and a
raise for tensors that are neither on the CPU nor on CUDA.

Tolerance: none; integer arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jxl_oxide_tpu.models.modular_transform import DELTA_PALETTE
from jxl_oxide_tpu.ops import modular_tail as jmt
from jxl_oxide_tpu_torch.ops import modular_tail as mt
from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq

I32 = np.iinfo(np.int32)
EDGES = np.array([I32.min, I32.min + 1, I32.min // 2, -13, -12, -1, 0, 1,
                  11, 12, 13, I32.max // 2, I32.max - 1, I32.max],
                 dtype=np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x, dtype=jnp.int32)


def _eq(ours, ref):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _wide(shape, seed):
    """int32 samples over the whole range, a tenth of them at the edges."""
    rng = np.random.default_rng(seed)
    v = rng.integers(I32.min, I32.max, shape, dtype=np.int64).astype(np.int32)
    edge = rng.random(shape) < 0.1
    v[edge] = rng.choice(EDGES, int(edge.sum()))
    return v


def test_trunc_divisions_match_jax():
    v = np.concatenate([EDGES, _wide(4096, 1)])
    _eq(mt._trunc_div2(_t(v)), jmt._trunc_div2(_j(v)))
    for d in (2, 3, 12):
        _eq(mt._trunc_div_i32(_t(v), d), jmt._trunc_div_i32(_j(v), d))
    # and they truncate toward zero
    want = np.trunc(v.astype(np.float64) / 12).astype(np.int64)
    np.testing.assert_array_equal(mt._trunc_div_i32(_t(v), 12).numpy(), want)


def test_tendency_matches_jax_at_int32_edges():
    a, b, c = (x.ravel() for x in np.meshgrid(EDGES, EDGES, EDGES,
                                               indexing="ij"))
    a, b, c = (np.concatenate([x, _wide(4096, s)])
               for s, x in enumerate((a, b, c)))
    _eq(mt._tendency(_t(a), _t(b), _t(c)),
        jmt._tendency(_j(a), _j(b), _j(c)))


# w odd and even, one row, one column (no residual), two columns
@pytest.mark.parametrize("h,w", [(7, 13), (5, 12), (1, 9), (1, 1), (6, 1),
                                 (4, 2), (33, 70)])
@pytest.mark.parametrize("wide", [False, True])
def test_squeeze_matches_jax(h, w, wide):
    aw, rw = (w + 1) // 2, w // 2
    seed = h * 100 + w
    if wide:
        avg, res = _wide((h, aw), seed), _wide((h, rw), seed + 1)
    else:
        rng = np.random.default_rng(seed)
        avg = rng.integers(-300, 300, (h, aw)).astype(np.int32)
        res = rng.integers(-300, 300, (h, rw)).astype(np.int32)
    _eq(mt.inv_squeeze_h(_t(avg), _t(res)),
        jmt.inv_squeeze_h_device(avg, res))
    # the vertical squeeze on the transposed planes
    _eq(mt.inv_squeeze_v(_t(avg.T), _t(res.T)),
        jmt.inv_squeeze_v_device(avg.T, res.T))


@pytest.mark.parametrize("rct_type", range(42))
def test_rct_matches_jax(rct_type):
    a, b, c = (_wide((9, 11), 10 * rct_type + i) for i in range(3))
    ours = mt.inv_rct(_t(a), _t(b), _t(c), rct_type)
    ref = jmt.inv_rct_device(_j(a), _j(b), _j(c), rct_type)
    for o, r in zip(ours, ref):
        _eq(o, r)


def _palette_case(num_c, nb_colours, bit_depth, seed):
    rng = np.random.default_rng(seed)
    palette = rng.integers(-(1 << 20), 1 << 20,
                           (num_c, nb_colours)).astype(np.int32)
    idx = np.concatenate([
        rng.integers(0, max(nb_colours, 1), 64),             # in range
        nb_colours + rng.integers(0, 64, 64),                # small synthetic
        nb_colours + 64 + rng.integers(0, 1 << 20, 64),      # large synthetic
        rng.integers(-300, 0, 64),                           # delta entries
        [I32.min, I32.min + 1, -1, I32.max - 1, I32.max, nb_colours,
         nb_colours + 63, nb_colours + 64],
    ]).astype(np.int64)
    idx = np.clip(idx, I32.min, I32.max).astype(np.int32)
    return palette, rng.permutation(idx).reshape(8, -1)


# channel counts that reach the delta-free channels (c >= 3) and the
# statically zero synthetic quotients (2c > 30, 5^c >= 2^31)
@pytest.mark.parametrize("bit_depth", [8, 12, 16, 27])
@pytest.mark.parametrize("num_c,nb_colours,nb_deltas", [
    (3, 7, 2), (1, 1, 0), (4, 300, 0), (17, 5, 3), (3, 0, 0)])
def test_palette_matches_jax(bit_depth, num_c, nb_colours, nb_deltas):
    palette, idx = _palette_case(num_c, nb_colours, bit_depth,
                                 bit_depth + num_c + nb_colours)
    ours = mt.palette_lookup(_t(palette), _t(idx), _t(DELTA_PALETTE), num_c,
                             nb_colours, nb_deltas, bit_depth)
    # the JAX twin cannot gather from an empty palette (it raises); every
    # index is out of its range then, so one column it never reads stands in
    ref_palette = palette if nb_colours else np.zeros((num_c, 1), np.int32)
    ref = jmt.palette_lookup_device(
        _j(ref_palette), _j(idx), jnp.asarray(DELTA_PALETTE), num_c,
        nb_colours, nb_deltas, bit_depth)
    assert len(ours) == num_c
    for o, r in zip(ours, ref):
        _eq(o, r)


@pytest.mark.parametrize("horizontal", [True, False])
def test_wrapper_takes_the_plain_version_on_cpu(horizontal):
    rng = np.random.default_rng(3)
    avg = _t(rng.integers(-500, 500, (9, 6)).astype(np.int32))
    res = _t(rng.integers(-500, 500, (9, 5)).astype(np.int32))
    if not horizontal:
        avg, res = avg.t().contiguous(), res.t().contiguous()
    before = sq.inv_squeeze_cuda.launches
    got = sq.inv_squeeze_cuda(avg, res, horizontal)
    plain = mt.inv_squeeze_h if horizontal else mt.inv_squeeze_v
    assert torch.equal(got, plain(avg, res))
    assert got.shape == ((9, 11) if horizontal else (11, 9))
    assert sq.inv_squeeze_cuda.launches == before


def test_wrapper_raises_off_the_cpu_without_a_kernel():
    """A tensor that is not on the CPU never reaches the plain version:
    here (no CUDA) the wrapper raises before any launch."""
    avg = torch.empty((4, 3), dtype=torch.int32, device="meta")
    res = torch.empty((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sq.inv_squeeze_cuda(avg, res, True)
    with pytest.raises(ValueError, match="CUDA"):
        sq.inv_squeeze_cuda(avg, torch.zeros((4, 3), dtype=torch.int32),
                            True)
