"""Group-sharded decode over a torch device mesh: meshes and halo padding.

The torch counterpart of jxl_oxide_tpu/parallel/sharded.py. The image
shards by bands of whole 256px groups across a 1-D "groups" mesh (the
reference's per-group thread parallelism, vardct/mod.rs:250-376): rows of
groups for tall frames, columns of groups for wide ones. Block-local
stages need no communication; the restoration filters are stencils, so
shard boundaries exchange halo rows or columns (1px gaborish, 3px EPF, the
reference's region padding contract, jxl-frame/src/lib.rs:626-649).

A mesh (`DecodeMesh`) is an ordered list of shards, each a torch device:
several shards may share one device (the counterpart of the JAX tests'
virtual CPU devices), and a mesh may span processes of a
torch.distributed process group, each process holding a contiguous run
of shards (host-major). A program runs the shards this process holds, in
mesh order, each on its device; `exchange` moves the halo between
neighbouring shards: a copy to the neighbour's device within a process,
torch.distributed.batch_isend_irecv across processes (gloo on the CPU,
NCCL on cards).

Frames whose group count does not divide the mesh are padded up to the
next mesh multiple (trailing shards carry only padding); the shard that
holds the valid image edge mirrors its own rows there, so the sharded
filters reproduce the single-device symmetric padding bit for bit.
"""

from __future__ import annotations

import threading

import torch

from ..utils.trace import span

__all__ = ["DecodeMesh", "decode_mesh", "decode_mesh_multihost",
           "halo_pad_rows", "halo_pad_cols", "exchange", "join_bands",
           "exchanged", "reset_exchanged"]


class DecodeMesh:
    """An ordered list of decode shards.

    devices: one torch.device per shard, in mesh order (host-major for the
    2-D ("hosts", "chips") form); a shard another process holds is None.
    shape, axis_names: the mesh's layout, as the JAX package's Mesh has it.
    group: the torch.distributed process group of a mesh that spans
    processes (None within one process); owners[s] is the group rank that
    holds shard s."""

    def __init__(self, devices, axis_names=("groups",), shape=None,
                 group=None, owners=None):
        self.devices = tuple(None if d is None else torch.device(d)
                             for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else (
            len(self.devices),)
        self.group = group
        self.owners = (tuple(owners) if owners is not None
                       else (0,) * len(self.devices))
        self.rank = 0
        self.world = 1
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.local = tuple(s for s, o in enumerate(self.owners)
                           if o == self.rank)
        if not self.local or any(self.devices[s] is None
                                 for s in self.local):
            raise ValueError("a mesh needs a device for each shard of "
                             "this process")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home_device(self) -> torch.device:
        """The device of this process's first shard: the decode's device,
        where the bands are joined."""
        return self.devices[self.local[0]]

    def __repr__(self) -> str:
        return (f"DecodeMesh(shape={self.shape}, axes={self.axis_names}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"rank={self.rank}/{self.world})")


def _resolve(devices) -> list:
    from ..device import resolve_device

    return [resolve_device(d) for d in devices]


def decode_mesh(n_devices: int | None = None, axis: str = "groups",
                devices=None) -> DecodeMesh:
    """A 1-D mesh of `n_devices` shards: the first n CUDA devices, or the
    first n of `devices` (a list that may name one device several times,
    e.g. ["cuda:0"] * 4, or ["cpu"] * 2 in the tests). Raises when fewer
    exist; it never falls back to fewer shards or to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if n < 1 or count < n:
            raise RuntimeError(
                f"decode_mesh({n_devices}): {count} CUDA device(s) "
                "available; pass devices=[...] to put several shards on one "
                "device")
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        devices = list(devices)
        n = len(devices) if n_devices is None else n_devices
        if n < 1 or len(devices) < n:
            raise RuntimeError(f"decode_mesh({n_devices}): only "
                               f"{len(devices)} device(s) given")
        devices = devices[:n]
    return DecodeMesh(_resolve(devices), axis_names=(axis,))


def decode_mesh_multihost(n_hosts: int, chips_per_host: int, devices=None,
                          group=None) -> DecodeMesh:
    """2-D ("hosts", "chips") mesh, host-major. Under an initialised
    torch.distributed process group of `n_hosts` ranks (`group`, or the
    default one), rank r holds shards r * chips_per_host onwards, on
    `devices` (its chips_per_host devices; by default cuda:r*k .. when
    this host has a card for every shard, else cuda:0 .. cuda:k-1). Within
    one process it is n_hosts * chips_per_host shards on `devices` or the
    first CUDA devices, as decode_mesh takes them."""
    import torch.distributed as dist

    n = n_hosts * chips_per_host
    shape = (n_hosts, chips_per_host)
    axes = ("hosts", "chips")
    distributed = dist.is_available() and dist.is_initialized()
    if group is None and distributed:
        group = dist.group.WORLD
    if group is None or dist.get_world_size(group) == 1:
        flat = decode_mesh(n, devices=devices)
        return DecodeMesh(flat.devices, axis_names=axes, shape=shape)
    world = dist.get_world_size(group)
    if world != n_hosts:
        raise ValueError(f"{n_hosts} hosts on a process group of {world}")
    rank = dist.get_rank(group)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        first = rank * chips_per_host if count >= n else 0
        if count < first + chips_per_host:
            raise RuntimeError(
                f"rank {rank}: {count} CUDA device(s), {chips_per_host} "
                "needed; pass devices=[...]")
        devices = [f"cuda:{first + i}" for i in range(chips_per_host)]
    devices = list(devices)
    if len(devices) != chips_per_host:
        raise ValueError(f"{len(devices)} devices for {chips_per_host} "
                         "chips")
    owners = [s // chips_per_host for s in range(n)]
    mesh_devices = [None] * n
    for i, d in enumerate(_resolve(devices)):
        mesh_devices[rank * chips_per_host + i] = d
    return DecodeMesh(mesh_devices, axis_names=axes, shape=shape,
                      group=group, owners=owners)


# bytes of halo moved between shards since reset_exchanged(): in all, to
# another device, and to another process
_lock = threading.Lock()
exchanged = {"bytes": 0, "device_bytes": 0, "process_bytes": 0}


def reset_exchanged() -> None:
    with _lock:
        for k in exchanged:
            exchanged[k] = 0


def _count(key: str, nbytes: int) -> None:
    with _lock:
        exchanged["bytes"] += nbytes
        if key:
            exchanged[key] += nbytes


def exchange(mesh: DecodeMesh, firsts: list, lasts: list) -> tuple:
    """The halo of each of this process's shards from its neighbours:
    (from_above, from_below), each a list over the local shards. Shard s
    gets the `lasts` block of shard s - 1 and the `firsts` block of shard
    s + 1, on its own device; None where there is no such shard. The
    JAX package's two lax.ppermute calls (parallel/sharded.py:68-73)."""
    import torch.distributed as dist

    local = mesh.local
    pos = {s: k for k, s in enumerate(local)}
    above: list = [None] * len(local)
    below: list = [None] * len(local)
    ops, recv = [], []
    with span("Halo exchange"):
        for k, s in enumerate(local):
            dev = mesh.devices[s]
            for nb, blocks, out in ((s - 1, lasts, above),
                                    (s + 1, firsts, below)):
                if not 0 <= nb < mesh.size:
                    continue
                if nb in pos:
                    src = blocks[pos[nb]]
                    out[k] = src.to(dev)
                    _count("device_bytes" if src.device != dev else "",
                           src.numel() * src.element_size())
                    continue
                peer = dist.get_global_rank(mesh.group, mesh.owners[nb])
                mine = (firsts if nb < s else lasts)[k].contiguous()
                buf = torch.empty_like(mine)
                ops.append(dist.P2POp(dist.isend, mine, peer, mesh.group))
                ops.append(dist.P2POp(dist.irecv, buf, peer, mesh.group))
                recv.append((out, k, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for out, k, buf in recv:
                out[k] = buf
                _count("process_bytes", buf.numel() * buf.element_size())
    return above, below


def _halo_pad(bands: list, halo: int, mesh: DecodeMesh, vloc: int,
              last_shard: int, dim: int) -> list:
    firsts = [b.narrow(dim, 0, halo) for b in bands]
    lasts = [b.narrow(dim, b.shape[dim] - halo, halo) for b in bands]
    above, below = exchange(mesh, firsts, lasts)
    out = []
    for k, (s, b) in enumerate(zip(mesh.local, bands)):
        # the global first edge mirrors; the last shard's below block
        # (no neighbour) is zeros, as a ppermute with no source gives
        top = firsts[k].flip(dim) if s == 0 else above[k]
        bot = below[k] if below[k] is not None else torch.zeros_like(
            lasts[k])
        padded = torch.cat([top, b, bot], dim)
        if s == last_shard:
            # rows [vloc, vloc + halo) (local) become the mirror of the
            # last `halo` valid rows: the from_below block when vloc is
            # the band's height, else the padding that filters near the
            # valid edge read
            padded.narrow(dim, halo + vloc, halo).copy_(
                b.narrow(dim, vloc - halo, halo).flip(dim))
        out.append(padded)
    return out


def halo_pad_rows(bands: list, halo: int, mesh: DecodeMesh, vloc: int,
                  last_shard: int) -> list:
    """Pad each row band [..., h_loc, w] of this process's shards (in mesh
    order) with `halo` real rows from its neighbours; the global top edge
    mirrors symmetrically, and the valid bottom edge (local row vloc of
    shard last_shard; any later shard is padding) mirrors the last valid
    rows. This reproduces the symmetric pad of the whole unpadded plane
    exactly (jxl_oxide_tpu/parallel/sharded.py halo_pad_rows); for
    halo=1 the mirror row is the edge row, the gaborish clamp."""
    return _halo_pad(bands, halo, mesh, vloc, last_shard, -2)


def halo_pad_cols(bands: list, halo: int, mesh: DecodeMesh, vloc: int,
                  last_shard: int) -> list:
    """Column-band form of halo_pad_rows: pad [..., h, w_loc] with `halo`
    real columns; the global left edge mirrors and the valid right edge
    (column vloc of shard last_shard) mirrors the last valid columns."""
    return _halo_pad(bands, halo, mesh, vloc, last_shard, -1)


def join_bands(mesh: DecodeMesh, bands: list, dim: int) -> torch.Tensor:
    """The whole plane stack from the bands of every shard, on this
    process's home device: a copy of each local band there, and across
    processes an all-gather of each process's bands (every rank ends with
    the whole frame)."""
    home = mesh.home_device
    mine = [b.to(home) for b in bands]
    if mesh.world == 1:
        return torch.cat(mine, dim)
    import torch.distributed as dist

    stack = torch.stack(mine).contiguous()
    parts = [torch.empty_like(stack) for _ in range(mesh.world)]
    dist.all_gather(parts, stack, group=mesh.group)
    return torch.cat([b for p in parts for b in p.unbind(0)], dim)
