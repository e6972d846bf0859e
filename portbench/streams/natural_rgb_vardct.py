"""Recipe: a seeded photo-like RGB image through `encode_jxl_vardct`: lossy
4:4:4 VarDCT, DCT8 blocks only, the encoder's defaults (non-XYB, global
scale 512), the configuration's gaborish and EPF passes, and a seeded
per-block EPF sharpness map, so that the EPF filters.

The image has a natural image's spectrum: each of a luma field and two
chroma fields has amplitude 1/f^beta at spatial frequency f and random
phases, so its detail is textured at every scale and lies across the
8x8 block grid, and its HF coefficients are non-zero, fewer toward high
frequencies. The chroma fields are `chroma` times the luma's contrast;
the sum is scaled to a standard deviation `contrast` around mid-grey and
clipped to [0, 1].

`make` gives the stream's bytes; `reference_inputs` gives what the
stream carries, from the same seed: the quantized DCT8 coefficients and
LF values that the encoder writes, and the sharpness map, which the
plain reference decodes."""

from __future__ import annotations

import numpy as np

from .encoder_vardct import encode_jxl_vardct, quantize_dct8


def natural_rgb(h: int, w: int, rng: np.random.Generator, beta: float,
                contrast: float, chroma: float) -> np.ndarray:
    """[h, w, 3] float32 in [0, 1] with a 1/f^beta amplitude spectrum."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fx * fx + fy * fy)
    f[0, 0] = 1.0
    amp = f ** -beta
    amp[0, 0] = 0.0
    fields = []
    for _ in range(3):
        phase = rng.random(amp.shape) * (2.0 * np.pi)
        field = np.fft.irfft2(amp * np.exp(1j * phase), s=(h, w))
        fields.append(field / field.std())
    lum, a, b = fields
    rgb = np.stack([lum + chroma * a, lum - 0.5 * chroma * (a + b),
                    lum + chroma * b], -1)
    return np.clip(0.5 + contrast * rgb, 0.0, 1.0).astype(np.float32)


def _draw(params: dict, seed: int, slot: int):
    rng = np.random.default_rng([seed, slot])
    h, w = params["height"], params["width"]
    img = natural_rgb(h, w, rng, params["beta"], params["contrast"],
                      params["chroma"])
    lo, hi = params["sharpness"]
    sharp = rng.integers(lo, hi + 1, (-(-h // 8), -(-w // 8)))
    return img, sharp


def make(params: dict, seed: int, slot: int) -> bytes:
    img, sharp = _draw(params, seed, slot)
    return encode_jxl_vardct(img, gabor=params["gabor"],
                             epf_iters=params["epf_iters"], sharpness=sharp)


def reference_inputs(params: dict, seed: int, slot: int) -> dict:
    img, sharp = _draw(params, seed, slot)
    q, lf_q, consts = quantize_dct8(img)
    return {"layout": "444_cfl", "height": params["height"],
            "width": params["width"], "q": [q[c] for c in range(3)],
            "lf_q": [lf_q[c] for c in range(3)], "sharpness": sharp,
            "gabor": params["gabor"], "epf_iters": params["epf_iters"],
            **consts}
