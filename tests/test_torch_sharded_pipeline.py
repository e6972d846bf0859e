"""The port's sharded fused programs (jxl_oxide_tpu_torch/ops/
vardct_pipeline.py build_fused_pipeline_sharded and
build_fused_pipeline_subsampled_sharded) against the JAX package's, which
run under shard_map on the 8-device virtual CPU mesh: the JAX decode over a
mesh is caught where it builds its program, and the port's program is
built from the same constructor arguments and fed the same host inputs, shard by shard.

Tolerance: 2e-5 times the plane's peak magnitude (at least 1), as
tests/test_torch_pipeline.py holds the single-device programs: float32 in
the same operation order, but XLA and torch sum the transforms' einsums in
different orders.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jxl_oxide_tpu.ops.vardct_pipeline as jvp
import torch_parity as tp
from jxl_oxide_tpu.models.vardct import TransformType as T
from jxl_oxide_tpu.render.vardct import VardctFrameState as JaxState
from jxl_oxide_tpu_torch.ops import vardct_pipeline as tvp
from jxl_oxide_tpu_torch.parallel import decode_mesh


def _catch(monkeypatch, name: str) -> dict:
    """The constructor arguments, host inputs and output of the JAX
    sharded program that the next decode builds with `name`."""
    caught = {}
    real = getattr(jvp, name)

    def build(*args, **kwargs):
        fn, shardings = real(*args, **kwargs)
        caught["args"], caught["kwargs"] = args, kwargs

        def run(*placed):
            caught["inputs"] = [
                tuple(np.array(a) for a in x) if isinstance(x, tuple)
                else np.array(x) for x in placed]
            out = fn(*placed)
            caught["out"] = np.asarray(out)
            return out

        return run, shardings

    monkeypatch.setattr(jvp, name, build)
    monkeypatch.setattr(JaxState, "_fused_cache", {})
    return caught


def _jax_decode(data: bytes, n: int) -> None:
    from jxl_oxide_tpu import JxlImage

    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("groups",))
    JxlImage.from_bytes(data, mesh=mesh).render_frame(0)


def _shard(x, n: int, axis: int, s: int):
    """Shard s of a global program input, as torch tensors: a sparse pair
    by row, a replicated vector whole, the rest split along `axis`."""
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(a[s]) for a in x)
    if x.ndim == 1:
        return torch.from_numpy(x)
    return torch.from_numpy(np.ascontiguousarray(
        np.split(x, n, axis=axis if x.ndim == 3 else axis - 1)[s]))


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tier-1 run has six workers on the
    machine's cores, and torch's default (one thread a core in each
    worker) oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _compare(got, want):
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    peak = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-5 * peak, rtol=0)


# (stream, shards): row bands with per-tile CfL, LF smoothing and EPF
# steps 0-2 (dense upload); a smooth frame on 3 shards (the third pure
# padding); column bands of a smooth wide frame (sparse upload) at 2 and
# 4. The mixed stream's types: the DCT8x4 tile path and a multi-block DCT
# whose LF tiles take a K = 4 product
TYPES = [T.DCT8, T.DCT8X4, T.DCT32]
STREAMS_444 = {
    "mixed_rows": lambda: tp.tiled_stream(
        512, 256, 3, types=TYPES, cfl=True, skip_lf_smoothing=False,
        gabor=True, epf_iters=3),
    "rows": lambda: tp.vardct_stream(512, 256, 5, gabor=True, epf_iters=2),
    "wide_cols": lambda: tp.vardct_stream(256, 512, 4, gabor=True,
                                          epf_iters=2),
}


@pytest.mark.parametrize("name,n", [("mixed_rows", 2), ("rows", 3),
                                    ("wide_cols", 2), ("wide_cols", 4)])
def test_sharded_program_matches_jax(monkeypatch, name, n):
    caught = _catch(monkeypatch, "build_fused_pipeline_sharded")
    _jax_decode(STREAMS_444[name](), n)
    args, kwargs = caught["args"], caught["kwargs"]
    assert kwargs["shard_dim"] == ("cols" if name == "wide_cols" else "rows")
    axis = 1 if kwargs["shard_dim"] == "rows" else 2
    prog = tvp.build_fused_pipeline_sharded(
        decode_mesh(n, devices=["cpu"] * n), *args[2:], **kwargs)
    got = prog([[_shard(x, n, axis, s) for x in caught["inputs"]]
                for s in range(n)])
    _compare(got, caught["out"])


@pytest.mark.parametrize("h,w,ups,n", [(512, 256, (0, 1, 0), 2),
                                       (256, 512, (0, 1, 0), 2),
                                       (256, 768, (0, 2, 0), 4)])
def test_sharded_subsampled_program_matches_jax(monkeypatch, h, w, ups, n):
    """4:2:0 by rows and by columns, and 4:2:2 by columns (the horizontal
    upsample across the band boundary) with a pure-padding shard."""
    caught = _catch(monkeypatch, "build_fused_pipeline_subsampled_sharded")
    _jax_decode(tp.ycbcr_stream(h, w, ups, seed=5, gabor=True, epf_iters=2),
                n)
    args, kwargs = caught["args"], caught["kwargs"]
    axis = 1 if kwargs["shard_dim"] == "rows" else 2
    assert kwargs["shard_dim"] == ("rows" if h > w else "cols")
    prog = tvp.build_fused_pipeline_subsampled_sharded(
        decode_mesh(n, devices=["cpu"] * n), *args[2:], **kwargs)
    got = prog([[_shard(x, n, axis, s) for x in caught["inputs"]]
                for s in range(n)])
    _compare(got, caught["out"])
