"""Partition-map file IO, the reference's decomposition interchange format —
the port's own copy of ``nonlocalheatequation_tpu/utils/partition_map.py``
(NumPy only); a file written by either package reads in the other, byte for
byte the same.

File format (written by the decomposition tool, domain_decomposition.cpp:31-50;
read by the solver, 2d_nonlocal_distributed.cpp:467-488):

    nx ny npx npy dh
    idx idy locality     (npx*npy rows, idx-major)

``nx, ny`` are the per-tile grid sizes; tile (idx, idy) of the npx x npy tile
grid is owned by ``locality``.  In the port a locality is a device of the
elastic executor (parallel/elastic.py): a map places any number of tiles on
each device, and the load balancer moves them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PartitionMap:
    nx: int
    ny: int
    npx: int
    npy: int
    dh: float
    assignment: np.ndarray  # (npx, npy) int array: tile -> owner id

    @property
    def num_owners(self) -> int:
        return int(self.assignment.max()) + 1 if self.assignment.size else 0

    def tiles_of(self, owner: int) -> list[tuple[int, int]]:
        xs, ys = np.nonzero(self.assignment == owner)
        return list(zip(xs.tolist(), ys.tolist(), strict=True))


def default_assignment(npx: int, npy: int, nl: int) -> np.ndarray:
    """The reference's block map when no file is given
    (locidx: (i*nl)/(npx*npy), 2d_nonlocal_distributed.cpp:105-110), with
    i = idx + idy*npx."""
    i = np.arange(npx * npy)
    flat = (i * nl) // (npx * npy)
    out = np.zeros((npx, npy), dtype=np.int64)
    out[i % npx, i // npx] = flat
    return out


def read_partition_map(path: str) -> PartitionMap:
    with open(path) as f:
        tokens = f.read().split()
    nx, ny, npx, npy = (int(t) for t in tokens[:4])
    dh = float(tokens[4])
    rows = tokens[5:]
    assignment = np.zeros((npx, npy), dtype=np.int64)
    for r in range(npx * npy):
        idx, idy, loc = int(rows[3 * r]), int(rows[3 * r + 1]), int(rows[3 * r + 2])
        assignment[idx, idy] = loc
    return PartitionMap(nx, ny, npx, npy, dh, assignment)


def write_partition_map(path: str, pmap: PartitionMap):
    with open(path, "w") as f:
        f.write(f"{pmap.nx} {pmap.ny} {pmap.npx} {pmap.npy} {pmap.dh:g}\n")
        for idx in range(pmap.npx):
            for idy in range(pmap.npy):
                f.write(f"{idx} {idy} {int(pmap.assignment[idx, idy])}\n")
