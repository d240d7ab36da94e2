"""Hybrid device-mesh construction + logical axis rules — the port's copy of
``nonlocalheatequation_tpu/parallel/mesh_axes.py``.

Solver code names only LOGICAL axes (``case`` for the ensemble's batch
dimension, ``x``/``y``/``z`` for the spatial decomposition, ``d`` for the
gang executor's slot axis, ``p`` for the sharded point cloud), and this
module maps them onto the physical device fabric:

* **a granule is a process.**  The cards one process drives are one
  granule: they reach each other over peer access inside one address space
  (``ops/cuda_halo.fused_transport``), the counterpart of a TPU slice's ICI.
  A device's granule is its owning rank (:func:`device_granule`): a
  ``multihost.RemoteDevice``'s rank, ``multihost.process_index()`` for a
  local ``torch.device``, else an object's ``process_index`` attribute (so
  one fake device serves both packages' tests);
* **single granule** (one card, one process's cards, or the CPU's virtual
  devices) — a plain row-major reshape of the device list, byte for byte
  ``parallel/mesh.create_mesh``;
* **multiple granules** (the ranks of a multi-process launch,
  parallel/multihost.py) — the JAX rule of
  ``create_hybrid_device_mesh``: axes whose rule says ``"dcn"`` stride
  across granules and ``"ici"`` axes stay inside one; a device set whose
  granules cannot carry the axes so is refused loudly.

``parallel/mesh.make_mesh`` keeps its own row-major rank order (blocks
owned by ranks), which places a spatial mesh across ranks that this rule
would refuse; ROADMAP.md's "Deliberate differences" records it.
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.parallel.mesh import Mesh, create_mesh, device_list
from nonlocalheatequation_torch.parallel.multihost import RemoteDevice, process_index

#: logical axis -> "ici" | "dcn".  ``case`` is the ensemble batch axis
#: (serve/ensemble.py); the rest are the spatial / slot axes of
#: parallel/{distributed2d,distributed3d,gang}.py.
DEFAULT_AXIS_RULES: dict[str, str] = {
    "case": "dcn",
    "x": "ici",
    "y": "ici",
    "z": "ici",
    "d": "ici",
    "p": "ici",
}

_VALID_TARGETS = ("ici", "dcn")


def axis_rule(name: str, rules: dict | None = None) -> str:
    """The ICI/DCN placement of one logical axis (unknown names follow the
    spatial axes: ICI — a halo-crossing axis on the slow network is the
    pathological choice, never the silent default)."""
    rules = DEFAULT_AXIS_RULES if rules is None else rules
    target = rules.get(name, "ici")
    if target not in _VALID_TARGETS:
        raise ValueError(
            f"axis rule for {name!r} must be one of {_VALID_TARGETS}, "
            f"got {target!r}")
    return target


def device_granule(dev) -> int:
    """The granule id of one device: the rank that owns it."""
    if isinstance(dev, RemoteDevice):
        return dev.rank
    if isinstance(dev, torch.device):
        return process_index()
    idx = getattr(dev, "slice_index", None)
    if idx is not None:
        return int(idx)
    return int(getattr(dev, "process_index", 0))


def granule_count(devices) -> int:
    """How many processes the device set spans (1 == single granule: one
    card, one process's cards, or the virtual CPU test mesh)."""
    return len({device_granule(d) for d in devices})


def create_hybrid_mesh(axis_names: tuple[str, ...], shape: tuple[int, ...], devices=None,
                       rules: dict | None = None) -> Mesh:
    """Mesh of ``shape`` over ``axis_names`` placed by the axis rules.

    Single-granule device sets reshape row-major (``mesh.create_mesh``).
    Multi-granule sets take the hybrid rule: each axis contributes its full
    extent to either the ICI or the DCN factor per its rule; the granules
    (sorted by rank, each keeping its device order) must number the DCN
    product and each hold the ICI product of devices, and granule g's
    devices fill block g of the DCN grid row-major."""
    if len(axis_names) != len(shape):
        raise ValueError(f"axis_names {axis_names} and shape {shape} disagree in rank")
    devices = list(devices if devices is not None else device_list())
    n = int(np.prod(shape)) if shape else 1
    if n > len(devices):
        raise ValueError(
            f"mesh {dict(zip(axis_names, shape, strict=True))} needs {n} devices, "
            f"have {len(devices)}")
    devices = devices[:n]
    if granule_count(devices) <= 1:
        return create_mesh(axis_names, shape, devices)
    ici_shape = tuple(s if axis_rule(name, rules) == "ici" else 1
                      for name, s in zip(axis_names, shape, strict=True))
    dcn_shape = tuple(s if axis_rule(name, rules) == "dcn" else 1
                      for name, s in zip(axis_names, shape, strict=True))
    groups: dict[int, list] = {}
    for d in devices:
        groups.setdefault(device_granule(d), []).append(d)
    granules = [groups[g] for g in sorted(groups)]
    if len(granules) != int(np.prod(dcn_shape)):
        raise ValueError(
            f"Number of slices {len(granules)} must equal the product of "
            f"dcn_mesh_shape {dcn_shape}")
    per = int(np.prod(ici_shape))
    for g, members in zip(sorted(groups), granules, strict=True):
        if len(members) != per:
            raise ValueError(
                f"granule {g} holds {len(members)} devices; the ICI axes of mesh "
                f"{dict(zip(axis_names, shape, strict=True))} need {per} per granule")

    def block(members):
        grid = np.empty(per, dtype=object)
        grid[:] = members
        return grid.reshape(ici_shape)

    blocks = np.empty(len(granules), dtype=object)
    blocks[:] = [block(m) for m in granules]
    nested = blocks.reshape(dcn_shape).tolist()
    return Mesh(np.block(nested), axis_names)


def mesh_axis_network(mesh: Mesh, rules: dict | None = None) -> dict:
    """{axis: "ici" | "dcn"} for a built mesh — the docs/obs label of where
    each axis's traffic travels."""
    return {name: axis_rule(name, rules) for name in mesh.axis_names}


def pick_gang_devices(n: int, devices=None) -> list:
    """N devices for one gang/space-parallel worker, whole granules first.

    A gang replica's mesh carries the halo-crossing spatial axes, so its
    device set should span as FEW processes as possible.  Devices are
    grouped by granule and granules are consumed largest-first until n is
    reached; within a granule the original device order is kept (the
    row-major contract of :func:`create_hybrid_mesh`)."""
    devices = list(devices if devices is not None else device_list())
    n = int(n)
    if not 1 <= n <= len(devices):
        raise ValueError(f"pick_gang_devices needs 1 <= n <= {len(devices)}, got {n}")
    groups: dict[int, list] = {}
    for d in devices:
        groups.setdefault(device_granule(d), []).append(d)
    picked: list = []
    for _, members in sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0])):
        take = min(len(members), n - len(picked))
        picked.extend(members[:take])
        if len(picked) == n:
            break
    return picked
