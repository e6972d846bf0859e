"""The port's mesh pieces (jxl_oxide_tpu_torch/parallel/, the halo forms of
ops/filters.py, K1's band route ops/cuda/epf.py epf_step_bands and
ops/vardct_pipeline.py _smooth_local) against the JAX package's, which run
under shard_map on the 8-device virtual CPU mesh (tests/conftest.py).

Halo padding is data movement: bit for bit. The filters are float32 in
the same operation order: the halo forms as tests/test_torch_filters.py
holds the whole-plane ones (gaborish 1e-6, EPF 2e-5); the smoothing
within 1e-6. K1's band route on the CPU runs the plain epf_step on each
haloed band: bit for bit the prepad form of the port's own epf_step.
"""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import jxl_oxide_tpu.ops.filters as jf
import jxl_oxide_tpu.ops.vardct_pipeline as jvp
import jxl_oxide_tpu.parallel.sharded as js
import jxl_oxide_tpu_torch.ops.filters as tf
from jxl_oxide_tpu_torch import JxlImage
from jxl_oxide_tpu_torch.ops import vardct_pipeline as tvp
from jxl_oxide_tpu_torch.ops.cuda.epf import BAND_HALO, epf_step_bands
from jxl_oxide_tpu_torch.parallel import (
    decode_mesh,
    decode_mesh_multihost,
    halo_pad_cols,
    halo_pad_rows,
    mesh_fingerprint,
    sharded,
)

CS = (40.0, 5.0, 3.5)
BSM = 2.0 / 3.0
STEPS = [(0, 1.65), (1, 1.0), (2, 2.35)]


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("g",))


def _cpu_mesh(n):
    return decode_mesh(n, devices=["cpu"] * n)


def _split(x, n, dim):
    return [torch.from_numpy(np.ascontiguousarray(b))
            for b in np.split(x, n, axis=dim)]


def _jax_sharded(fn, x, n, spec):
    body = shard_map(fn, mesh=_jax_mesh(n), in_specs=spec, out_specs=spec)
    return np.asarray(jax.jit(body)(x))


# (shards, local size, halo, valid extent of the last shard, last shard):
# an exact fit, a valid edge inside a shard, a trailing pure-padding
# shard (3 shards, the last empty), and 8 shards with the edge in shard 5
HALO_CASES = [(2, 16, 3, 16, 1), (2, 24, 8, 8, 1), (3, 16, 1, 8, 1),
              (3, 16, 3, 16, 0), (8, 8, 3, 4, 5), (8, 16, 8, 16, 7),
              (8, 16, 1, 1, 2)]


@pytest.mark.parametrize("rows", [True, False], ids=["rows", "cols"])
@pytest.mark.parametrize("n,loc,halo,vloc,last", HALO_CASES)
def test_halo_pad_matches_jax(rows, n, loc, halo, vloc, last):
    rng = np.random.default_rng(n * 100 + loc)
    other = 7
    shape = (3, n * loc, other) if rows else (3, other, n * loc)
    x = rng.random(shape).astype(np.float32)
    dim = 1 if rows else 2
    jfn = js.halo_pad_rows if rows else js.halo_pad_cols
    spec = P(None, "g", None) if rows else P(None, None, "g")
    want = _jax_sharded(lambda b: jfn(b, halo, "g", vloc, last), x, n, spec)
    tfn = halo_pad_rows if rows else halo_pad_cols
    got = tfn(_split(x, n, dim), halo, _cpu_mesh(n), vloc, last)
    np.testing.assert_array_equal(torch.cat(got, dim).numpy(), want)


def test_halo_exchange_is_counted():
    x = np.zeros((3, 32, 8), dtype=np.float32)
    sharded.reset_exchanged()
    halo_pad_rows(_split(x, 4, 1), 3, _cpu_mesh(4), 8, 3)
    # three borders, 3 rows each way, 3 x 8 floats a row
    assert sharded.exchanged["bytes"] == 3 * 2 * 3 * 3 * 8 * 4
    assert sharded.exchanged["device_bytes"] == 0


@pytest.mark.parametrize("rows", [True, False], ids=["rows", "cols"])
@pytest.mark.parametrize("n,vloc,last", [(2, 5, 1), (3, 6, 1), (8, 3, 6)])
def test_smooth_local_matches_jax(rows, n, vloc, last):
    loc = 6
    rng = np.random.default_rng(7 + n)
    lf = (rng.random((3, n * loc, 9) if rows else (3, 9, n * loc))
          .astype(np.float32) * 4 - 2)
    lf_scale = (np.float32(0.6), np.float32(0.9), np.float32(1.3))
    valid = last * loc + vloc
    lh, lw = (valid, 9) if rows else (9, valid)
    dim = 1 if rows else 2
    shard_dim = "rows" if rows else "cols"
    spec = P(None, "g", None) if rows else P(None, None, "g")
    want = _jax_sharded(
        lambda b: jvp._smooth_local(b, lf_scale, "g", vloc, last, lh, lw,
                                    shard_dim), lf, n, spec)
    got = tvp._smooth_local(_split(lf, n, dim), lf_scale, _cpu_mesh(n),
                            vloc, last, lh, lw, shard_dim)
    np.testing.assert_allclose(torch.cat(got, dim).numpy(), want, atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("step,mult", STEPS)
@pytest.mark.parametrize("rows", [True, False], ids=["rows", "cols"])
def test_epf_prepad_forms_match_jax(step, mult, rows):
    rng = np.random.default_rng(step)
    shape = (3, 22, 17) if rows else (3, 17, 22)
    planes = rng.random(shape).astype(np.float32)
    sigma = (rng.random((16, 17) if rows else (17, 16)) * 3 + 0.2).astype(
        np.float32)
    kw = {"prepad_rows": 3} if rows else {"prepad_cols": 3}
    want = np.asarray(jf.epf_step(planes, sigma, step, CS, mult, BSM, **kw))
    got = tf.epf_step(torch.from_numpy(planes), torch.from_numpy(sigma),
                      step, CS, mult, BSM, **kw).numpy()
    assert got.shape == want.shape == sigma.shape[:0] + (3, *sigma.shape)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("rows", [True, False], ids=["rows", "cols"])
def test_gabor_prepad_forms_match_jax(rows):
    rng = np.random.default_rng(11)
    plane = rng.random((12, 9) if rows else (9, 12)).astype(np.float32)
    w = (0.115169525, 0.061248592)
    kw = {"prepad_rows": 1} if rows else {"prepad_cols": 1}
    want = np.asarray(jf.gabor(plane, w, **kw))
    got = tf.gabor(torch.from_numpy(plane), w, **kw).numpy()
    assert got.shape == want.shape == ((10, 9) if rows else (9, 10))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("step,mult", STEPS)
@pytest.mark.parametrize("rows", [True, False], ids=["rows", "cols"])
@pytest.mark.parametrize("n,loc,vloc,last", [(2, 16, 16, 1), (3, 16, 8, 1),
                                             (4, 24, 16, 2)])
def test_k1_band_route_is_the_prepad_form(step, mult, rows, n, loc, vloc,
                                          last):
    """epf_step_bands (an 8-wide halo, the plain epf_step on each haloed
    band, the middle kept) equals epf_step(prepad_rows=3) (prepad_cols)
    on a 3-wide halo of the same bands, bit for bit, on every valid sample
    (a band's padding past the valid edge, and a pure-padding shard, are
    cropped away and read other padding in the two forms); and no kernel
    launch is counted on the CPU."""
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    rng = np.random.default_rng(step * 10 + n)
    other = 20
    shape = (3, n * loc, other) if rows else (3, other, n * loc)
    planes = rng.random(shape).astype(np.float32)
    sigma = (rng.random(shape[1:]) * 3 + 0.1).astype(np.float32)
    dim = 1 if rows else 2
    mesh = _cpu_mesh(n)
    bands = _split(planes, n, dim)
    sig = _split(sigma[None], n, dim)
    pad = halo_pad_rows if rows else halo_pad_cols
    sig8 = [s[0] for s in pad(sig, BAND_HALO, mesh, vloc, last)]
    before = epf_step_cuda.launches
    got = epf_step_bands(bands, sig8, step, CS, mult, BSM, mesh, vloc, last,
                         -2 if rows else -1)
    assert epf_step_cuda.launches == before
    kw = {"prepad_rows": 3} if rows else {"prepad_cols": 3}
    want = [tf.epf_step(p, s[0], step, CS, mult, BSM, **kw)
            for p, s in zip(pad(bands, 3, mesh, vloc, last), sig)]
    for s_, (g, w_) in enumerate(zip(got, want)):
        valid = loc if s_ < last else vloc if s_ == last else 0
        assert torch.equal(g.narrow(dim, 0, valid), w_.narrow(dim, 0, valid))


def test_decode_mesh_raises_with_too_few_devices():
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        decode_mesh(count + 1)
    with pytest.raises(RuntimeError, match="device"):
        decode_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        decode_mesh_multihost(2, count + 1)


def test_meshes_and_their_fingerprints():
    m = _cpu_mesh(3)
    assert (m.size, m.shape, m.axis_names, m.local) == (3, (3,), ("groups",),
                                                         (0, 1, 2))
    assert m.home_device == torch.device("cpu")
    m2 = decode_mesh_multihost(2, 2, devices=["cpu"] * 4)
    assert (m2.shape, m2.axis_names, m2.size) == ((2, 2), ("hosts", "chips"),
                                                  4)
    assert mesh_fingerprint(m2) != mesh_fingerprint(_cpu_mesh(4))
    assert mesh_fingerprint(_cpu_mesh(3)) == mesh_fingerprint(m)


def test_image_device_must_agree_with_the_mesh():
    with pytest.raises(ValueError, match="home device"):
        JxlImage(device="meta", mesh=_cpu_mesh(2))
    img = JxlImage(mesh=_cpu_mesh(2))
    assert img.device == torch.device("cpu")
