"""Decoder option plumbing (contextvar-scoped, like the alloc tracker).

force_wide_buffers: disable the narrow (i16) modular sample lane even when
modular_16bit_buffers is set in the image header (JxlImageBuilder
force_wide_buffers, jxl-oxide/src/lib.rs:199-234; sample lanes
jxl-modular/src/sample.rs:4-36).

decode device: the torch device of the decode that is running, set by
JxlImage around its host and device stages. The modular inverse-transform
tail (models/modular.py ModularImage.finish) may run on the device only
when that device is CUDA (the counterpart of jxl_oxide_tpu/utils/
options.py local_accelerator / device_modular_may_engage, decided per
decode rather than per process), and then only for a frame with a
transformed plane of at least DEVICE_TAIL_MIN_SAMPLES samples. There is no
environment override: tests patch `device_modular_may_engage` and
DEVICE_TAIL_MIN_SAMPLES on this module.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# the size gate of the device tail (jxl_oxide_tpu/models/modular.py
# _device_tail_worthwhile): one squeeze step walks the squeezed axis in
# order, so a plane must be wide across the other axis to pay for the trip
DEVICE_TAIL_MIN_SAMPLES = 1 << 20

_force_wide: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "jxl_force_wide_buffers", default=False
)
_decode_device: contextvars.ContextVar[torch.device | None] = (
    contextvars.ContextVar("jxl_decode_device", default=None)
)


def get_force_wide() -> bool:
    return _force_wide.get()


@contextlib.contextmanager
def use_force_wide(value: bool):
    token = _force_wide.set(value)
    try:
        yield
    finally:
        _force_wide.reset(token)


def get_decode_device() -> torch.device:
    """The running decode's device; the CPU outside a JxlImage decode."""
    dev = _decode_device.get()
    return torch.device("cpu") if dev is None else dev


@contextlib.contextmanager
def use_decode_device(device):
    token = _decode_device.set(torch.device(device))
    try:
        yield
    finally:
        _decode_device.reset(token)


def device_modular_may_engage() -> bool:
    """Whether the modular inverse-transform tail may run on the device for
    the running decode: only when its device is CUDA."""
    return get_decode_device().type == "cuda"
