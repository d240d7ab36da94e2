"""Device meshes and the block scatter and gather — counterpart of
``nonlocalheatequation_tpu/parallel/mesh.py`` (with the single-granule part
of ``parallel/mesh_axes.py``) and of ``put_global``/``fetch_global``
(``parallel/multihost.py``).

The JAX package places tile (i, j) of the global grid on mesh position
(i, j) of a ``jax.sharding.Mesh`` and runs one SPMD program over it.  Here
a :class:`Mesh` is an array of devices of the mesh's shape, the global
grid is an object array of block tensors of the same shape, each on its
position's device, and the distributed solvers (parallel/distributed2d.py,
distributed3d.py) step their blocks in turn.

Blocks are owned by ranks.  Under a multi-process launch
(parallel/multihost.py) the device list is every rank's local devices in
rank order, the order of ``jax.devices()``: with 2 ranks of 2 devices each,
mesh row x=0 of a (2,2) mesh is rank 0's, and an uneven 3+1 split crosses
ranks mid-row.  A position whose device is another rank's
(``multihost.RemoteDevice``) holds a ``multihost.Remote`` placeholder in
every object array of blocks, so each rank builds, steps and moves only
its own blocks; :attr:`Mesh.ranks` names each position's owner.  In one
process every position is local, as JAX's single-controller ``shard_map``.

A device list may name one device several times: those are virtual
devices, the counterpart of the JAX suite's
``--xla_force_host_platform_device_count=8``.  They let the CPU tests, and
one card, hold a 2x2 or 2x2x2 mesh; a halo band moved between two virtual
devices of one device is a copy on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.parallel.multihost import (
    Remote,
    RemoteDevice,
    fetch_global,
    global_devices,
    local_card,
    process_count,
    process_index,
    put_global,
)
from nonlocalheatequation_torch.utils.devices import resolve_device

__all__ = ["Mesh", "Remote", "block_shape", "create_mesh", "device_list", "factor_devices",
           "factor_devices_3d", "fetch_global", "first_local", "local_positions", "make_mesh",
           "make_mesh_3d", "map_blocks", "put_global"]


class Mesh:
    """A device mesh: ``devices`` is an object array of the mesh's shape
    (``torch.device``, or ``multihost.RemoteDevice`` where another rank
    owns the position), ``axis_names`` names its axes (``("x", "y")`` or
    ``("x", "y", "z")``).  ``shape`` maps each axis name to its size, as a
    ``jax.sharding.Mesh`` does; ``ranks`` is the owning rank of each
    position.  A rank may own no position: it steps nothing and receives
    the gathered results."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"device array of rank {devices.ndim} and axis names "
                             f"{axis_names} disagree in rank")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape, strict=True))
        me = process_index()
        self.ranks = np.array([d.rank if isinstance(d, RemoteDevice) else me
                               for d in devices.flat], np.int64).reshape(devices.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def local_devices(self) -> list:
        """This rank's devices, in mesh order."""
        return [d for d in self.devices.flat if not isinstance(d, RemoteDevice)]


def device_list(device=None, count: int = 0) -> list:
    """The devices a mesh is built from.  ``device`` ``None``/``"gpu"``/
    ``"cuda"``: every CUDA card (raises when there is none); ``"cpu"``: the
    CPU.  ``count > 0`` takes that many, naming the devices again in turn
    when there are fewer (virtual devices).

    Under a multi-process launch these are this rank's ``count`` local
    devices (its one card, parallel/multihost.py), followed and preceded by
    the other ranks' in rank order (``multihost.global_devices``, an
    all-gather of the counts every rank joins)."""
    dev = resolve_device(device)
    multi = process_count() > 1
    if dev.type == "cuda":
        if dev.index is not None:
            devices = [dev]
        elif multi and local_card() is not None:
            devices = [torch.device("cuda", local_card())]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    count = int(count)
    if count < 0:
        raise ValueError(f"device count must be >= 0, got {count}")
    if count:
        devices = [devices[i % len(devices)] for i in range(count)]
    return global_devices(devices) if multi else devices


def create_mesh(axis_names: tuple[str, ...], shape: tuple[int, ...], devices) -> Mesh:
    """Mesh of ``shape`` over ``axis_names``: the first prod(shape) devices
    reshaped row-major (the JAX package's single-granule placement)."""
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {axis_names} and shape {shape} disagree in rank")
    devices = list(devices)
    n = int(np.prod(shape)) if shape else 1
    if n > len(devices):
        raise ValueError(f"mesh {dict(zip(axis_names, shape, strict=True))} needs {n} "
                         f"devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(shape), axis_names)


def factor_devices(n: int) -> tuple[int, int]:
    """Factor n into the most-square (dx, dy) grid, dx*dy == n."""
    best = (n, 1)
    for dx in range(1, int(np.sqrt(n)) + 1):
        if n % dx == 0:
            best = (n // dx, dx)
    return best


def make_mesh(npx: int | None = None, npy: int | None = None, devices=None) -> Mesh:
    """A 2D mesh with axes ('x', 'y'): of exactly (npx, npy), or with no
    shape over every device of ``devices`` (default :func:`device_list`, the
    CUDA cards), most-square factorization.  (The JAX package's
    ``assignment=`` device permutation is not ported: a partition map places
    tiles through the elastic executor, parallel/elastic.py.)"""
    devices = list(devices if devices is not None else device_list())
    if npx is None or npy is None:
        npx, npy = factor_devices(len(devices))
    if npx * npy > len(devices):
        raise ValueError(f"mesh {npx}x{npy} needs {npx * npy} devices, have {len(devices)}")
    return create_mesh(("x", "y"), (npx, npy), devices)


def factor_devices_3d(n: int) -> tuple[int, int, int]:
    """Factor n into the most-cubic (dx, dy, dz) grid, dx*dy*dz == n."""
    best, best_score = (n, 1, 1), n  # score: max factor (lower = more cubic)
    for dx in range(1, n + 1):
        if n % dx:
            continue
        for dy in range(1, n // dx + 1):
            if (n // dx) % dy:
                continue
            dz = n // (dx * dy)
            score = max(dx, dy, dz)
            if score < best_score:
                best, best_score = (dx, dy, dz), score
    return best


def make_mesh_3d(mx: int | None = None, my: int | None = None, mz: int | None = None,
                 devices=None) -> Mesh:
    """A 3D mesh with axes ('x', 'y', 'z') for the 3D distributed solver."""
    devices = list(devices if devices is not None else device_list())
    if mx is None or my is None or mz is None:
        mx, my, mz = factor_devices_3d(len(devices))
    if mx * my * mz > len(devices):
        raise ValueError(f"mesh {mx}x{my}x{mz} needs {mx * my * mz} devices, "
                         f"have {len(devices)}")
    return create_mesh(("x", "y", "z"), (mx, my, mz), devices)


def block_shape(mesh: Mesh, grid_shape: tuple[int, ...]) -> tuple[int, ...]:
    """The per-device block of the uniform sharding of ``grid_shape``."""
    return tuple(int(n) // int(m) for n, m in zip(grid_shape, mesh.devices.shape, strict=True))


def local_positions(blocks: np.ndarray):
    """The mesh positions of an object array of blocks that this rank
    owns (every position in one process), in mesh order."""
    return [pos for pos in np.ndindex(*blocks.shape) if not isinstance(blocks[pos], Remote)]


def first_local(blocks: np.ndarray):
    """This rank's first block (None when it owns none)."""
    return next((b for b in blocks.flat if not isinstance(b, Remote)), None)


def map_blocks(fn, *arrays) -> np.ndarray:
    """``fn`` applied position by position to object arrays of blocks of one
    shape (the per-shard body of a ``shard_map``): an object array of the
    results; a position another rank owns keeps its placeholder."""
    out = np.empty(arrays[0].shape, dtype=object)
    for pos in np.ndindex(*arrays[0].shape):
        first = arrays[0][pos]
        out[pos] = first if isinstance(first, Remote) else fn(*(a[pos] for a in arrays))
    return out
