"""The port's host stage (jxl_oxide_tpu_torch: headers, C++ entropy decode,
VardctFrameState.fused_program_parts) hands its device program inputs
that are bit-identical, dtype included, to the JAX package's host stage
(serving._host_stage_fast + fused_program_parts) on the same stream."""

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import STREAMS


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


def _assert_inputs_identical(jin, tin):
    assert len(jin) == len(tin)
    for i, (j, t) in enumerate(zip(jin, tin)):
        assert isinstance(j, tuple) == isinstance(t, tuple), i
        for a, b in zip(_flat(j), _flat(t)):
            assert a.dtype == b.dtype, (i, a.dtype, b.dtype)
            assert a.shape == b.shape, (i, a.shape, b.shape)
            assert np.array_equal(a, b), f"input {i} differs"


@pytest.mark.parametrize("upload", ["sparse", "dense"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_fused_inputs_bit_identical(name, upload, monkeypatch):
    monkeypatch.setenv("JXL_TPU_SPARSE_UPLOAD",
                       "0" if upload == "dense" else "1")
    data = STREAMS[name]()
    _, _, jin = tp.jax_parts(data)
    _, _, tin = tp.torch_parts(data)
    _assert_inputs_identical(jin, tin)
    if upload == "dense":
        assert not isinstance(tin[0], tuple)


@pytest.mark.parametrize("name", tp.FUSED_FIXTURES)
def test_fixture_inputs_bit_identical(name):
    data, _ = tp.fixture(name)
    _, _, jin = tp.jax_parts(data)
    _, _, tin = tp.torch_parts(data)
    _assert_inputs_identical(jin, tin)


def test_roi_rect_inputs_bit_identical():
    data = STREAMS["tiled_cfl_smooth_epf3"]()
    rect = (256, 0, 320, 128)
    _, _, jin = tp.jax_parts(data, rect=rect)
    _, _, tin = tp.torch_parts(data, rect=rect)
    _assert_inputs_identical(jin, tin)


def test_callers_wait_for_the_native_build(monkeypatch):
    """A pool thread that asks for the native library while another thread
    builds it waits for that build (before, it took the Python path, and
    the stream other program-input dtypes); the build runs once."""
    import threading
    import time

    from jxl_oxide_tpu_torch import native

    builds, done, got = [], [], []

    def slow_build():
        builds.append(1)
        time.sleep(0.3)
        done.append(time.perf_counter())
        return False  # no library: both callers read None after the build

    monkeypatch.setattr(native, "_build", slow_build)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("JXL_TPU_NO_NATIVE", raising=False)

    def call():
        lib = native.get_lib()
        got.append((time.perf_counter(), lib))

    threads = [threading.Thread(target=call) for _ in range(2)]
    threads[0].start()
    time.sleep(0.05)
    threads[1].start()
    for t in threads:
        t.join(timeout=30)
    assert builds == [1]
    assert len(got) == 2 and all(lib is None for _, lib in got)
    assert all(t >= done[0] for t, _ in got)
