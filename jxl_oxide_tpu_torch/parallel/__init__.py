"""Multi-device decode: meshes, halo exchange, the active decode mesh.

The torch counterpart of jxl_oxide_tpu/parallel/. The pixel grid of a
VarDCT frame shards across a mesh by bands of whole groups
(ops/vardct_pipeline.py build_fused_pipeline_sharded and
build_fused_pipeline_subsampled_sharded, driven by render/vardct.py); the
Modular inverse-transform tail runs its row-independent steps per row
band (models/modular.py). Halos travel between neighbouring shards
(sharded.py `exchange`): a device-to-device copy within a process,
torch.distributed point-to-point across processes.
"""

import contextlib as _contextlib
import contextvars as _contextvars

from .sharded import (
    DecodeMesh,
    decode_mesh,
    decode_mesh_multihost,
    halo_pad_cols,
    halo_pad_rows,
)

# Active decode mesh: when set, VarDCT frames route through the sharded
# fused programs and the Modular device tail through row bands.
_decode_mesh: _contextvars.ContextVar = _contextvars.ContextVar(
    "jxl_decode_mesh", default=None
)


def set_decode_mesh(mesh) -> None:
    """Set (or clear, with None) the decode mesh of this context."""
    _decode_mesh.set(mesh)


def get_decode_mesh():
    return _decode_mesh.get()


@_contextlib.contextmanager
def use_decode_mesh(mesh):
    token = _decode_mesh.set(mesh)
    try:
        yield
    finally:
        _decode_mesh.reset(token)


def mesh_fingerprint(mesh) -> tuple:
    """Hashable identity of a mesh for program-cache keys: its axes, its
    shape, its shards' devices and, for a mesh across processes, this
    process's rank and the group's size."""
    return (
        tuple(mesh.axis_names),
        tuple(mesh.shape),
        tuple(str(d) for d in mesh.devices),
        (mesh.rank, mesh.world) if mesh.group is not None else None,
    )


__all__ = [
    "DecodeMesh",
    "decode_mesh",
    "decode_mesh_multihost",
    "halo_pad_cols",
    "halo_pad_rows",
    "set_decode_mesh",
    "get_decode_mesh",
    "use_decode_mesh",
    "mesh_fingerprint",
]
