"""The port on the card: the hand-written EPF kernel (csrc/epf.cu), on one
image and on stacks, and the squeeze kernel (csrc/modular_squeeze.cu)
against their plain torch versions, the squeeze pyramid against the host
tail, the committed fixtures decoded on CUDA, and the stacked serving
path against per-image decodes.

Marked `cuda`: where torch.cuda.is_available() is false these skip (the
kernels have no CPU mode; their arithmetic is held here by
test_torch_epf_math.py and test_torch_squeeze_math.py). On a machine with
the card:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import ctypes

import pytest
import torch

import torch_parity as tp

pytestmark = pytest.mark.cuda

CS = (40.0, 5.0, 3.5)
BSM = 2.0 / 3.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the EPF kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (3, 1000, 1030) and (3, 2048, 2048): more 64x64 tiles than resident
# blocks; (3, 64, 64) and (3, 40, 36): one tile; W % 4 != 0 takes the
# cp.async copy; H < 3 reflects rows more than once
@pytest.mark.parametrize("shape", [(3, 150, 40), (3, 2, 5), (3, 1, 1),
                                   (3, 1024, 1024), (3, 2048, 2048),
                                   (3, 1000, 1030), (3, 64, 64), (3, 40, 36),
                                   (3, 150, 42), (3, 1, 8), (3, 2, 64)])
@pytest.mark.parametrize("step,mult", [(0, 1.65), (1, 1.0), (2, 2.35)])
def test_epf_kernel_matches_plain(cuda, shape, step, mult):
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    p, s = tp.epf_inputs(shape, seed=step)
    planes = torch.from_numpy(p).to(cuda)
    sigma = torch.from_numpy(s).to(cuda)
    before = epf_step_cuda.launches
    got = epf_step_cuda(planes, sigma, step, CS, mult, BSM)
    torch.cuda.synchronize()
    assert epf_step_cuda.launches == before + 1
    want = epf_step(planes, sigma, step, CS, mult, BSM)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5


def test_epf_kernel_launch_geometry(cuda):
    """Persistent: at least one resident block per SM, within the card's
    shared memory."""
    from jxl_oxide_tpu_torch.ops.cuda import build

    lib = build.load("epf")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for step in range(3):
        threads, smem, resident = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        assert lib.jxl_epf_config(step, ctypes.byref(threads),
                                  ctypes.byref(smem),
                                  ctypes.byref(resident)) == 0
        assert threads.value == 512
        assert smem.value <= 232448
        assert resident.value >= sms


QUOTIENT_PROBE = r"""
#include "epf_math.cuh"

__global__ void probe(float a, unsigned lo, unsigned n,
                      unsigned long long* bad, unsigned* first) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float b = __uint_as_float(lo + i);
    if (__float_as_uint(jxl_epf::sigma_quotient(a, b)) !=
        __float_as_uint(a / b)) {
      atomicAdd(bad, 1ull);
      atomicMin(first, lo + i);
    }
  }
}

extern "C" int sigma_quotient_mismatches(float a, unsigned lo, unsigned n,
                                         void* bad, void* first) {
  probe<<<1056, 256>>>(a, lo, n, static_cast<unsigned long long*>(bad),
                       static_cast<unsigned*>(first));
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def test_sigma_quotient_is_the_ieee_division(cuda, tmp_path):
    """epf_math.cuh's sigma_quotient gives the IEEE quotient bit for bit
    for the filter's neg_k and every float sigma in [0.3, 2^126), the
    sigmas of filtered pixels (a probe kernel built with the port's nvcc
    flags, every float of the range)."""
    import subprocess

    import numpy as np

    from jxl_oxide_tpu_torch.ops.cuda import build
    from jxl_oxide_tpu_torch.ops.cuda.epf import kernel_params

    src = tmp_path / "probe.cu"
    src.write_text(QUOTIENT_PROBE)
    lib_path = tmp_path / "libprobe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR,
                    "-o", str(lib_path), str(src)], check=True, timeout=600,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.sigma_quotient_mismatches.argtypes = [
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
        ctypes.c_void_p]
    lo = int(np.float32(0.3).view(np.uint32))
    hi = int(np.float32(2.0 ** 126).view(np.uint32))
    neg_k = kernel_params(CS, 1.0, BSM)[5]
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    first = torch.full((1,), -1, dtype=torch.int32, device=cuda)
    assert lib.sigma_quotient_mismatches(neg_k, lo, hi - lo, bad.data_ptr(),
                                         first.data_ptr()) == 0
    assert int(bad.item()) == 0, hex(int(first.item()) & 0xFFFFFFFF)
    # the probe sees a difference where there is one: above 2^126 the
    # reciprocal flushes to 0 and so does the quotient
    top = int(np.float32(2.0 ** 127).view(np.uint32))
    assert lib.sigma_quotient_mismatches(neg_k, hi, top - hi, bad.data_ptr(),
                                         first.data_ptr()) == 0
    assert int(bad.item()) > 0


@pytest.mark.parametrize("name", tp.FIXTURES)
def test_fixture_decodes_on_cuda(cuda, name):
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    data, ref = tp.fixture(name)
    img = JxlImage.from_bytes(data)
    assert img.device.type == "cuda"
    epf = img._frames[0].header.restoration_filter.epf
    before = epf_step_cuda.launches
    u8 = img.render_frame(0).to_u8()
    assert epf_step_cuda.launches - before == (epf.iters if epf.enabled
                                                else 0)
    assert tp.max_lsb(u8, ref) <= 1


I32_EDGES = (-2**31, -2**31 + 1, -2**30, -13, -1, 0, 1, 12, 2**30,
             2**31 - 2, 2**31 - 1)


# (lines, n): n odd and even, no residual (n = 1), one line, one
# squeezed position, partial 32-line blocks and 32-column tiles, 2048^2;
# na % 4 of 0 (the TMA copy when nr % 4 == 0 too), 1, 2 and 3 (cp.async),
# more tiles than the horizontal kernel's ring stages
@pytest.mark.parametrize("lines,n", [(1, 2), (3, 3), (70, 1), (33, 64),
                                     (40, 65), (1, 131), (1024, 1024),
                                     (2048, 2048), (7, 70), (31, 68),
                                     (20, 264), (3, 257), (40, 300)])
@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("extremes", [False, True])
def test_squeeze_kernel_matches_plain(cuda, lines, n, horizontal, extremes):
    """The hand-written squeeze kernel (csrc/modular_squeeze.cu) against
    its plain torch version on the card, bit for bit."""
    import numpy as np

    from jxl_oxide_tpu_torch.ops import modular_tail as mt
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    rng = np.random.default_rng(lines + n)
    na, nr = (n + 1) // 2, n // 2
    shapes = ((lines, na), (lines, nr)) if horizontal else ((na, lines),
                                                             (nr, lines))
    if extremes:
        avg, res = (rng.choice(np.array(I32_EDGES, np.int32), s)
                    for s in shapes)
    else:
        avg, res = (rng.integers(-4096, 4096, s).astype(np.int32)
                    for s in shapes)
    avg, res = torch.from_numpy(avg).to(cuda), torch.from_numpy(res).to(cuda)
    before = inv_squeeze_cuda.launches
    got = inv_squeeze_cuda(avg, res, horizontal)
    torch.cuda.synchronize()
    assert inv_squeeze_cuda.launches == before + (1 if nr else 0)
    want = (mt.inv_squeeze_h if horizontal else mt.inv_squeeze_v)(avg, res)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("lines,n", [(33, 64), (20, 264), (1024, 1024),
                                     (40, 65), (7, 70)])
@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("extremes", [False, True])
def test_squeeze_kernel_on_misaligned_bases(cuda, lines, n, horizontal,
                                            extremes):
    """The squeeze kernel on planes whose bases are off a 16-byte
    boundary (the horizontal kernel then takes cp.async, not TMA), bit
    for bit the plain version."""
    import numpy as np

    from jxl_oxide_tpu_torch.ops import modular_tail as mt
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze_measure import misaligned

    rng = np.random.default_rng(lines * n)
    na, nr = (n + 1) // 2, n // 2
    shapes = ((lines, na), (lines, nr)) if horizontal else ((na, lines),
                                                             (nr, lines))
    if extremes:
        avg, res = (rng.choice(np.array(I32_EDGES, np.int32), s)
                    for s in shapes)
    else:
        avg, res = (rng.integers(-4096, 4096, s).astype(np.int32)
                    for s in shapes)
    avg = misaligned(torch.from_numpy(avg).to(cuda))
    res = misaligned(torch.from_numpy(res).to(cuda))
    assert avg.data_ptr() % 16 and res.data_ptr() % 16
    got = inv_squeeze_cuda(avg, res, horizontal)
    want = (mt.inv_squeeze_h if horizontal else mt.inv_squeeze_v)(avg, res)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_squeeze_pyramid_matches_host(cuda):
    """A default squeeze pyramid of a 2048^2 plane through the port's
    device tail on the card and through the host's Squeeze.inverse (C++
    rows): bit for bit."""
    import numpy as np

    from jxl_oxide_tpu_torch.models import modular_transform as mtr
    from jxl_oxide_tpu_torch.models.modular import inverse_transforms_device

    def pyramid():
        rng = np.random.default_rng(0)
        parent = rng.integers(-1024, 1024, (2048, 2048)).astype(np.int32)
        sq = mtr.Squeeze()
        sq.set_default_params([mtr.ChannelInfo(2048, 2048)], 0)
        slots = [mtr.Slot(parent)]
        sq.check([mtr.ChannelInfo(2048, 2048)], 0, slots, [])
        return sq, slots, parent

    sq, slots, _ = pyramid()
    planes = [torch.from_numpy(np.ascontiguousarray(s.arr)).to(cuda)
              for s in slots]
    (got,) = inverse_transforms_device([sq], planes, 16)
    sq, slots, parent = pyramid()
    sq.inverse(slots, 16)
    assert torch.equal(got.cpu(), torch.from_numpy(parent))


@pytest.mark.parametrize("name,squeezes", [("modular_1024", 1),
                                           ("modular_xyb_512", 0)])
def test_modular_fixture_decodes_on_cuda(cuda, name, squeezes):
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    data, ref = tp.fixture(name)
    img = JxlImage.from_bytes(data)
    epf = img._frames[0].header.restoration_filter.epf
    before = epf_step_cuda.launches, inv_squeeze_cuda.launches
    u8 = img.render_frame(0).to_u8()
    assert epf_step_cuda.launches - before[0] == (epf.iters if epf.enabled
                                                   else 0)
    assert inv_squeeze_cuda.launches - before[1] == squeezes
    assert tp.max_lsb(u8, ref) <= 1


# stacks of N images: the TMA copy (W % 4 == 0) and the cp.async copy
@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("hw", [(150, 40), (150, 42), (130, 68)])
@pytest.mark.parametrize("step,mult", [(0, 1.65), (1, 1.0), (2, 2.35)])
def test_epf_kernel_stack_is_one_launch(cuda, n, hw, step, mult):
    """One launch on [N, 3, H, W]: bit for bit the N one-image launches,
    and within 2e-5 of the plain version on the stack."""
    import numpy as np

    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    ins = [tp.epf_inputs((3, *hw), seed=10 * step + j) for j in range(n)]
    planes = torch.from_numpy(np.stack([p for p, _ in ins])).to(cuda)
    sigma = torch.from_numpy(np.stack([s for _, s in ins])).to(cuda)
    before = epf_step_cuda.launches
    got = epf_step_cuda(planes, sigma, step, CS, mult, BSM)
    torch.cuda.synchronize()
    assert epf_step_cuda.launches == before + 1
    singles = torch.stack([epf_step_cuda(planes[j], sigma[j], step, CS, mult,
                                         BSM) for j in range(n)])
    assert torch.equal(got, singles)
    want = epf_step(planes, sigma, step, CS, mult, BSM)
    assert float((got - want).abs().max()) <= 2e-5


def test_stacked_serving_equals_per_image_on_cuda(cuda):
    """decode_batch_stacked on the card: two different flagship-recipe
    streams (one 4:4:4 stack), the alpha fixture, and two different 4:2:2
    streams (one subsampled stack), each bit for bit its per-image decode
    and the fixtures within 1 LSB of their references; one EPF launch per
    pass of each stacked group."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage, decode_batch_stacked
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    names = ["flagship_1024", "flagship_1024_s1", "flagship_alpha_1024",
             "ycbcr422_256", "ycbcr422_256_s1"]
    streams = []
    for n in names:
        with open(f"{tp.TESTDATA}/{n}.jxl", "rb") as f:
            streams.append(f.read())
    before = epf_step_cuda.launches
    got = decode_batch_stacked(streams, output="u8")
    assert epf_step_cuda.launches - before == 3 * 2
    for name, data, img in zip(names, streams, got):
        want = JxlImage.from_bytes(data).render_frame(0).to_u8()
        assert img.shape == want.shape
        assert np.array_equal(img, want), name
        if not name.endswith("_s1"):  # streams committed with a reference
            assert tp.max_lsb(img, tp.fixture(name)[1]) <= 1


def test_launch_counts_are_exact_across_threads(cuda):
    """Frames of one keyframe render on several threads: the EPF and
    squeeze wrappers count every launch, however the threads interleave."""
    import threading

    from jxl_oxide_tpu_torch.ops.cuda import squeeze as sq
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    planes = torch.rand(3, 20, 30, device=cuda)
    sigma = torch.rand(20, 30, device=cuda) * 2
    avg = torch.randint(-99, 99, (8, 5), dtype=torch.int32, device=cuda)
    res = torch.randint(-99, 99, (8, 4), dtype=torch.int32, device=cuda)
    e0, s0 = epf_step_cuda.launches, sq.inv_squeeze_cuda.launches

    def run():
        for _ in range(300):
            epf_step_cuda(planes, sigma, 1, CS, 1.0, BSM)
            sq.inv_squeeze_cuda(avg, res, True)

    threads = [threading.Thread(target=run) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert epf_step_cuda.launches - e0 == 2400
    assert sq.inv_squeeze_cuda.launches - s0 == 2400


# the multi-frame fixtures: (name, EPF passes per frame, exact on the card)
ANIMATIONS = (("animation_4f_blend", 0, True), ("patch_alpha_256", 0, True),
              ("anim_blend_epf_512", 2, False), ("crop_epf_77x45", 2, False))


@pytest.mark.parametrize("name,passes,exact", ANIMATIONS)
def test_animation_composites_on_cuda(cuda, name, passes, exact):
    """Every keyframe of each multi-frame fixture composited on the card,
    last keyframe first: unfiltered canvases bit for bit the CPU's, the
    filtered ones within 2e-5 (the EPF kernel against its plain version)
    and 1 LSB, alpha exactly; K1 launched 2 per filtered frame rendered,
    none for a cached keyframe."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    with open(f"{tp.TESTDATA}/{name}.jxl", "rb") as f:
        data = f.read()
    gpu = JxlImage.from_bytes(data)
    cpu = JxlImage.from_bytes(data, device="cpu")
    for k in range(gpu.num_keyframes - 1, -1, -1):
        # a cached keyframe renders nothing; else its whole cone renders
        cone, _ = gpu._dependency_cone(gpu._keyframe_index(k))
        frames = 0 if k in gpu._keyframe_cache else len(cone)
        before = epf_step_cuda.launches
        kf = gpu._render_keyframe(k)
        assert epf_step_cuda.launches - before == passes * frames
        ref = cpu._render_keyframe(k)
        for a, b in zip((*kf.color, *kf.extra), (*ref.color, *ref.extra)):
            assert a.device.type == "cuda"
            if exact:
                assert torch.equal(a.cpu(), b)
            else:
                assert float((a.cpu() - b).abs().max()) <= 2e-5
        u8, want = gpu.render_frame(k).to_u8(), cpu.render_frame(k).to_u8()
        assert tp.max_lsb(u8, want) <= (0 if exact else 1)
        if u8.shape[-1] == 4:
            assert np.array_equal(u8[..., 3], want[..., 3])


def test_frame_workers_run_on_the_card(cuda, monkeypatch):
    """The frame-render workers of a CUDA decode see CUDA as the decode
    device (utils/options.py), so the Modular tail's gate reads the
    card, not the CPU default."""
    import threading

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch import api
    from jxl_oxide_tpu_torch.utils import options as opts

    seen = []
    real = api.render_frame

    def render(frame, device):
        seen.append((threading.current_thread() is threading.main_thread(),
                     opts.get_decode_device().type,
                     opts.device_modular_may_engage()))
        return real(frame, device)

    monkeypatch.setattr(api, "render_frame", render)
    with open(f"{tp.TESTDATA}/anim_blend_epf_512.jxl", "rb") as f:
        JxlImage.from_bytes(f.read()).render_frame(2)
    assert seen == [(False, "cuda", True)] * 3


@pytest.mark.parametrize("step,mult", [(0, 1.65), (1, 1.0), (2, 2.35)])
@pytest.mark.parametrize("hw", [(150, 40), (150, 42), (1024, 2048)])
def test_epf_kernel_on_cloned_grey_planes(cuda, step, mult, hw):
    """K1 on a grey plane cloned to [3, H, W] (render/render.py filters a
    grey frame so): within 2e-5 of the plain version, and its three output
    planes equal, so keeping plane 0 keeps the JAX package's result."""
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    p, s = tp.epf_inputs((1,) + hw, seed=step)
    planes = torch.from_numpy(p).to(cuda).expand(3, *hw).contiguous()
    sigma = torch.from_numpy(s).to(cuda)
    got = epf_step_cuda(planes, sigma, step, CS, mult, BSM)
    want = epf_step(planes, sigma, step, CS, mult, BSM)
    assert float((got - want).abs().max()) <= 2e-5
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])


def test_grey_squeeze_device_tail_matches_host(cuda):
    """grey_squeeze_2048x1024's inverse transforms on the card (one K9
    launch) and on the host (C++ rows): bit for bit."""
    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda
    from jxl_oxide_tpu_torch.utils.options import use_decode_device

    data = tp.fixture("grey_squeeze_2048x1024")[0]
    host = JxlImage.from_bytes(data, device="cpu")._frames[0]
    want = host.decode_modular_sections().finish()
    dev = JxlImage.from_bytes(data)._frames[0]
    with use_decode_device(cuda):
        modular = dev.decode_modular_sections()
        assert modular.device_tail_selected()
        before = inv_squeeze_cuda.launches
        got = modular.finish(to_device=True)
    assert inv_squeeze_cuda.launches - before == 1
    assert len(got) == len(want) == 1
    assert torch.equal(got[0].cpu(), torch.from_numpy(want[0]))


@pytest.mark.parametrize("name,exact,k1,k9", tp.COLOR_FIXTURES)
def test_color_fixture_decodes_on_cuda(cuda, monkeypatch, name, exact, k1,
                                       k9):
    """The colour fixtures on the card: within 1 LSB of the reference
    (alpha exactly), with their K1 and K9 launches. The reference's tone
    map steps at a luminance of |y| = 1e-7; a pixel whose luminance lands
    on the other side of the step on the card than on the CPU (K1's
    last-ulp differences from its plain version) is left out, and there
    are few (chip_smoke.py TONE_MAP_STEP; ROADMAP Queue 3)."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops import color
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    lums = {"cuda": [], "cpu": []}
    real = color.tone_map_rec2408
    data, ref = tp.fixture(name)

    def decode(device):
        def tone_map(r, g, b, luminances, *rest):
            y = color._luma(r, g, b, luminances)
            lums[device].append(y.cpu().numpy())
            return real(r, g, b, luminances, *rest)

        monkeypatch.setattr(color, "tone_map_rec2408", tone_map)
        return JxlImage.from_bytes(data, device=device).render_frame(0)\
            .to_u8()

    before = epf_step_cuda.launches, inv_squeeze_cuda.launches
    u8 = decode("cuda")
    assert epf_step_cuda.launches - before[0] == k1
    assert inv_squeeze_cuda.launches - before[1] == k9
    assert u8.shape == ref.shape
    crossed = np.zeros(u8.shape[:2], bool)
    if lums["cuda"]:
        decode("cpu")
        for a, b in zip(lums["cuda"], lums["cpu"]):
            crossed |= (np.abs(a) <= 1e-7) != (np.abs(b) <= 1e-7)
    assert crossed.sum() <= crossed.size * 1e-4
    off = np.abs(u8.astype(np.int32) - ref).max(-1)
    assert off[~crossed].max() <= 1
    if u8.shape[-1] in (2, 4):
        assert np.array_equal(u8[..., -1], ref[..., -1])


def test_flagship_requests_on_cuda(cuda):
    """flagship_1024 under each requested encoding on the card: u8 within
    1 LSB of the reference, u16 of PQ and HLG within REQUEST_U16_TOL."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.headers import image
    from make_torch_port_fixtures import requested_encodings

    data = tp.fixture("flagship_1024")[0]
    refs = np.load(f"{tp.TESTDATA}/flagship_1024_requests.npz")
    for name, enc in requested_encodings(image).items():
        img = JxlImage.from_bytes(data)
        img.request_color_encoding(enc)
        r = img.render_frame(0)
        assert tp.max_lsb(r.to_u8(), refs[f"u8_{name}"]) <= 1, name
        if f"u16_{name}" in refs.files:
            assert tp.max_lsb(r.to_u16(), refs[f"u16_{name}"]) <= \
                tp.REQUEST_U16_TOL, name


# K12 on the shapes of chip_smoke.py's checks: one pixel, W % 16 != 0,
# partial groups at the right and bottom edges, one group, 2048^2, and the
# features_up2_1024 field (one 1024^2 group)
@pytest.mark.parametrize("w,h,gdim", [(1, 1, 128), (17, 5, 128),
                                      (300, 260, 128), (513, 130, 256),
                                      (256, 256, 256), (2048, 2048, 256),
                                      (1024, 1024, 1024)])
def test_noise_kernel_matches_plain(cuda, w, h, gdim):
    import numpy as np

    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda
    from jxl_oxide_tpu_torch.ops.noise import noise_field_plain, noise_seed0

    seed0 = noise_seed0(3, 2)
    before = noise_field_cuda.launches
    got = noise_field_cuda(w, h, gdim, seed0, cuda)
    torch.cuda.synchronize()
    assert noise_field_cuda.launches == before + 1
    want = noise_field_plain(w, h, gdim, seed0)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_noise_kernel_refuses_bad_arguments(cuda):
    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda

    for args in ((0, 4, 128, 1), (4, 4, 0, 1), (4, 4, 128, -1),
                 (4, 4, 128, 1 << 64)):
        with pytest.raises(ValueError):
            noise_field_cuda(*args, cuda)


@pytest.mark.parametrize("name,k1,k12", tp.FEATURE_FIXTURES)
def test_feature_fixture_decodes_on_cuda(cuda, name, k1, k12):
    """The render pipeline's fixtures on the card: within 1 LSB of the
    reference, the alpha exactly, with their K1 and K12 launches."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.noise import noise_field_cuda

    data, ref = tp.fixture(name)
    before = epf_step_cuda.launches, noise_field_cuda.launches
    u8 = JxlImage.from_bytes(data).render_frame(0).to_u8()
    assert epf_step_cuda.launches - before[0] == k1
    assert noise_field_cuda.launches - before[1] == k12
    assert tp.max_lsb(u8, ref) <= 1
    if u8.shape[-1] == 4:
        assert np.array_equal(u8[..., 3], ref[..., 3])


@pytest.mark.parametrize("name,k1,k9", tp.PROGRESSIVE_FIXTURES)
def test_loading_renders_on_cuda(cuda, name, k1, k9):
    """A stream fed in pieces (the cuts of <name>_progressive.npz) renders
    on the card within 1 LSB of the same feed on the CPU and of the JAX
    package's committed loading render, with K1's launches per render
    and K9's (at least k9, none where k9 is 0); the last render is the
    card's one-shot decode bit for bit."""
    import os

    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    data, _ = tp.fixture(name)
    ref = np.load(os.path.join(tp.TESTDATA, f"{name}_progressive.npz"))
    card, host = JxlImage(device=cuda), JxlImage(device="cpu")
    prev = 0
    for k, cut in enumerate(ref["cuts"]):
        for img in (card, host):
            img.feed_bytes(data[prev:cut])
        prev = cut
        before = epf_step_cuda.launches, inv_squeeze_cuda.launches
        u8 = card.render_loading_frame().to_u8()
        launches = (epf_step_cuda.launches - before[0],
                    inv_squeeze_cuda.launches - before[1])
        assert launches[0] == k1, (k, launches)
        assert launches[1] >= k9 if k9 else launches[1] == 0, (k, launches)
        assert tp.max_lsb(u8, host.render_loading_frame().to_u8()) <= 1
        assert tp.max_lsb(u8, ref["u8"][k]) <= 1, k
    one = JxlImage.from_bytes(data, device=cuda).render_frame(0).to_u8()
    assert np.array_equal(u8, one)


def test_image_stream_on_cuda(cuda):
    """Render.stream over planes on the card: its u8 and u16 samples are
    to_u8() and to_u16() flattened, row bands downloaded one call at a
    time."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage

    data, _ = tp.fixture("orient6_512x384")
    r = JxlImage.from_bytes(data, device=cuda).render_frame(0)
    for dtype, want in ((np.uint8, r.to_u8()), (np.uint16, r.to_u16())):
        stream, buf, out = r.stream(), np.zeros(4099, dtype), []
        while (n := stream.write_to_buffer(buf)):
            out.append(buf[:n].copy())
        assert np.array_equal(np.concatenate(out), want.reshape(-1))


@pytest.mark.parametrize("name,k1,k9,keyframes", tp.EC_FIXTURES)
def test_extra_channel_fixture_on_cuda(cuda, name, k1, k9, keyframes):
    """Every keyframe of the extra-channel fixtures on the card: u8
    within 1 LSB of the reference with the alphas exact, every extra
    channel bit for bit (ec_mix_1024's f16 alpha leaves the device tail
    as int32 tensors and converts with its own float bit depth), K1 and
    K9 launches as stated."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda

    data, u8 = tp.fixture(name)
    extra = np.load(f"{tp.TESTDATA}/{name}.npz")["extra"]
    if keyframes == 1:
        u8, extra = u8[None], extra[None]
    before = epf_step_cuda.launches, inv_squeeze_cuda.launches
    img = JxlImage.from_bytes(data, device=cuda)
    for k in range(keyframes):
        r = img.render_frame(k)
        got = r.to_u8()
        assert tp.max_lsb(got, u8[k]) <= 1
        assert np.array_equal(got[..., 3], u8[k][..., 3])
        assert np.array_equal(r.image_all_channels()[..., 3:], extra[k])
    assert (epf_step_cuda.launches - before[0],
            inv_squeeze_cuda.launches - before[1]) == (k1, k9)


@pytest.mark.parametrize("name", tp.ROI_FIXTURES)
def test_region_renders_on_cuda(cuda, name):
    """Each committed region on the card: within 1 LSB of the JAX
    package's region render, equal to the crop of the card's full
    render, and each K1 launch on the rect's planes within 2e-5 of the
    plain version."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda import epf as k1mod
    from jxl_oxide_tpu_torch.ops.filters import epf_step

    data, _ = tp.fixture(name)
    ref = np.load(f"{tp.TESTDATA}/{name}_roi.npz")
    full = JxlImage.from_bytes(data, device=cuda).render_frame(0).to_u8()
    kernel = k1mod.epf_step_cuda
    for r, region in enumerate(ref["regions"].tolist()):
        seen = []

        def watched(*args):
            seen.append((args[0].clone(), *args[1:]))
            return kernel(*args)

        k1mod.epf_step_cuda = watched
        try:
            got = JxlImage.from_bytes(data, device=cuda).render_frame_cropped(
                0, region).to_u8()
        finally:
            k1mod.epf_step_cuda = kernel
        left, top, w, h = region
        assert tp.max_lsb(got, ref[f"u8_{r}"]) <= 1
        assert np.array_equal(got, full[top:top + h, left:left + w])
        for args in seen:
            want = epf_step(*args)
            assert float((kernel(*args) - want).abs().max()) <= 2e-5


def test_cli_decode_on_cuda(cuda, tmp_path):
    """The CLI's decode of the main path on the card (its default device):
    K1 2 launches a rep, the PNG (read with zlib alone) equal to
    render_frame(0).to_u8() on the card and within 1 LSB of the
    reference."""
    import contextlib
    import io

    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage, cli
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    data, ref = tp.fixture("flagship_1024")
    out = str(tmp_path / "x.png")
    before = epf_step_cuda.launches
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rc = cli.main(["decode", f"{tp.TESTDATA}/flagship_1024.jxl", "-o",
                       out, "--num-reps", "2"])
    assert rc == 0 and "MP/s" in err.getvalue()
    assert epf_step_cuda.launches - before == 4
    png = tp.read_png(out)["frames"][0]
    assert np.array_equal(png, JxlImage.from_bytes(data).render_frame(0)
                          .to_u8())
    assert tp.max_lsb(png, ref) <= 1


def test_clear_program_caches_on_cuda(cuda):
    """clear_program_caches gives the caching allocator's free blocks
    back (memory_reserved falls), and the next decode is the same."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage, clear_program_caches
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda

    data, _ = tp.fixture("flagship_1024")
    first = JxlImage.from_bytes(data).render_frame(0).to_u8()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    clear_program_caches()
    assert torch.cuda.memory_reserved() < reserved
    before = epf_step_cuda.launches
    again = JxlImage.from_bytes(data).render_frame(0).to_u8()
    assert epf_step_cuda.launches - before == 2
    assert np.array_equal(first, again)


@pytest.mark.parametrize("name,n", [("flagship_1024", 3), ("ycbcr420_1024", 4),
                                    ("wide_epf_1024x256", 4),
                                    ("wide_420_1024x256", 2)])
def test_mesh_decode_on_one_card(cuda, name, n):
    """n shards on cuda:0 (decode_mesh(n, devices=[...] * n)): planes and
    u8 equal to the card's single-device decode bit for bit, K1 launched
    once a pass (the bands of one card go as one stack), 1 LSB from the
    reference."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.parallel import decode_mesh

    data, ref = tp.fixture(name)
    single = JxlImage.from_bytes(data).render_frame(0)
    before = epf_step_cuda.launches
    got = JxlImage.from_bytes(
        data, mesh=decode_mesh(n, devices=["cuda:0"] * n)).render_frame(0)
    assert epf_step_cuda.launches - before == 2
    assert torch.equal(torch.stack(got.planes), torch.stack(single.planes))
    u8 = got.to_u8()
    assert np.array_equal(u8, single.to_u8())
    assert tp.max_lsb(u8, ref) <= 1


@pytest.mark.parametrize("rows", [True, False])
def test_k1_band_route_on_cuda(cuda, rows):
    """epf_step_bands on the card (K1 on the stack of haloed bands) within
    2e-5 of the plain prepad form on the same bands."""
    from jxl_oxide_tpu_torch.ops.cuda.epf import (
        BAND_HALO,
        epf_step_bands,
        epf_step_cuda,
    )
    from jxl_oxide_tpu_torch.ops.filters import epf_step
    from jxl_oxide_tpu_torch.parallel import (
        decode_mesh,
        halo_pad_cols,
        halo_pad_rows,
    )

    n, loc, dim = 4, 64, -2 if rows else -1
    shape = (3, n * loc, 96) if rows else (3, 96, n * loc)
    p, s = tp.epf_inputs(shape, seed=3)
    planes = torch.from_numpy(p).to(cuda)
    sigma = torch.from_numpy(s).to(cuda)[None]
    mesh = decode_mesh(n, devices=["cuda:0"] * n)
    bands = list(planes.split(loc, dim))
    sig = list(sigma.split(loc, dim))
    pad = halo_pad_rows if rows else halo_pad_cols
    sig8 = [x[0] for x in pad(sig, BAND_HALO, mesh, loc, n - 1)]
    before = epf_step_cuda.launches
    got = epf_step_bands(bands, sig8, 1, CS, 1.0, BSM, mesh, loc, n - 1, dim)
    assert epf_step_cuda.launches - before == 1
    kw = {"prepad_rows": 3} if rows else {"prepad_cols": 3}
    for g, b, s_ in zip(got, pad(bands, 3, mesh, loc, n - 1), sig):
        want = epf_step(b, s_[0], 1, CS, 1.0, BSM, **kw)
        assert float((g - want).abs().max()) <= 2e-5


def test_graft_entry_torch_on_cuda(cuda):
    """graft_entry_torch.py on the card: entry() decodes the flagship's
    planes, and dryrun_multichip over 2 shards of cuda:0 holds every
    fixture bit for bit."""
    import graft_entry_torch as g

    fn, args = g.entry()
    assert tuple(fn(*args).shape) == (3, 1024, 1024)
    g.dryrun_multichip(2, devices=["cuda:0"] * 2)


# (fixture, K1 launches, K9 launches) of one decode of the two YCbCr
# layouts of ROADMAP item 7 on the card
YCBCR = (("ycbcr444_1024", 2, 0), ("ycbcr444_256", 2, 0),
         ("modular_420_1024", 2, 1))


@pytest.mark.parametrize("name,k1,k9", YCBCR)
def test_ycbcr_fixture_decodes_on_cuda(cuda, name, k1, k9):
    """4:4:4 YCbCr VarDCT and 4:2:0 YCbCr Modular on the card: within 1
    LSB of the reference, K1 once a pass, K9 on the Modular frame's Cb
    squeeze; over 2 shards of cuda:0 bit for bit the single-device
    decode."""
    import numpy as np

    from jxl_oxide_tpu_torch import JxlImage
    from jxl_oxide_tpu_torch.ops.cuda.epf import epf_step_cuda
    from jxl_oxide_tpu_torch.ops.cuda.squeeze import inv_squeeze_cuda
    from jxl_oxide_tpu_torch.parallel import decode_mesh

    data, ref = tp.fixture(name)
    before = epf_step_cuda.launches, inv_squeeze_cuda.launches
    single = JxlImage.from_bytes(data).render_frame(0)
    assert epf_step_cuda.launches - before[0] == k1
    assert inv_squeeze_cuda.launches - before[1] == k9
    u8 = single.to_u8()
    assert tp.max_lsb(u8, ref) <= 1
    got = JxlImage.from_bytes(
        data, mesh=decode_mesh(2, devices=["cuda:0"] * 2)).render_frame(0)
    assert torch.equal(torch.stack(got.planes), torch.stack(single.planes))
    assert np.array_equal(got.to_u8(), u8)


def test_generate_fixture_on_the_host(tmp_path):
    """The port's generate-fixture where there is no JAX: the SHA-256 of
    the JAX CLI's output for each committed form (generate_fixture.json).
    Host work: it needs no card, and runs here with the card's tests."""
    import hashlib
    import json
    import os

    from jxl_oxide_tpu_torch import cli

    with open(os.path.join(tp.TESTDATA, "generate_fixture.json")) as f:
        forms = json.load(f)["forms"]
    for k, form in enumerate(forms):
        out = tmp_path / f"g{k}.jxl"
        assert cli.main(["generate-fixture", "-o", str(out),
                         *form["args"]]) == 0
        assert hashlib.sha256(out.read_bytes()).hexdigest() == form["sha256"]
