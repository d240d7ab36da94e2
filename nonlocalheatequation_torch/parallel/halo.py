"""Halo exchange over a mesh of blocks — counterpart of
``nonlocalheatequation_tpu/parallel/halo.py``.

The JAX package moves each eps-band with ``lax.ppermute`` inside a
``shard_map``; here one process holds every block (parallel/mesh.py), and
each band is a tensor copy onto the receiving block's device.  The schedule
is the JAX package's:

* one hop per axis when the block edge >= eps (band exchange);
* a multi-hop ring when eps exceeds the block edge: hops 1..H-1 carry whole
  blocks, the last hop only the ``hop_widths(eps, bs)[-1]``-wide band still
  missing;
* axis x first, each later axis exchanging the blocks already padded along
  the earlier axes, so corners arrive without diagonal sends.

A band from beyond the mesh does not exist: that halo stays zero, which is
the volumetric boundary condition (u = 0 outside the domain), as
``lax.ppermute`` leaves its un-targeted outputs at zero.
"""

from __future__ import annotations

import numpy as np
import torch


def hop_widths(eps: int, bs: int) -> tuple[int, ...]:
    """Per-hop transfer widths of one axis direction: hop h carries
    ``min(bs, eps - (h-1)*bs)`` rows — whole blocks through the
    intermediate hops, and only the final hop's band is partial.  The
    source of the ring below, the fused plan (ops/cuda_halo.py) and the
    byte counts."""
    widths = []
    remaining = int(eps)
    while remaining > 0:
        w = min(int(bs), remaining)
        widths.append(w)
        remaining -= int(bs)
    return tuple(widths)


def _take_edge(x: torch.Tensor, axis: int, size: int, last: bool) -> torch.Tensor:
    n = x.shape[axis]
    return x.narrow(axis, n - size, size) if last else x.narrow(axis, 0, size)


def _band(blocks: np.ndarray, pos: tuple, axis: int, hop: int, width: int,
          dst: torch.Tensor) -> torch.Tensor:
    """The ``width``-wide band that the block ``hop`` shards away along
    ``axis`` (negative: before ``pos``) sends to ``pos``, copied onto the
    receiver's device; zeros when that block is beyond the mesh."""
    src = list(pos)
    src[axis] += hop
    if not 0 <= src[axis] < blocks.shape[axis]:
        shape = list(dst.shape)
        shape[axis] = width
        return torch.zeros(shape, dtype=dst.dtype, device=dst.device)
    # the block before me sends its trailing rows, the block after me its leading rows
    band = _take_edge(blocks[tuple(src)], axis, width, last=hop < 0)
    return band.to(dst.device)


def _axis_halo(blocks: np.ndarray, axis: int, eps: int) -> np.ndarray:
    """Pad every block with an eps-wide halo along ``axis`` from its mesh
    neighbours."""
    out = np.empty(blocks.shape, dtype=object)
    bs = blocks.flat[0].shape[axis]
    widths = hop_widths(eps, bs)
    for pos in np.ndindex(*blocks.shape):
        blk = blocks[pos]
        # lefts[h]: the band from the block h+1 shards before; rights[h] after
        lefts = [_band(blocks, pos, axis, -(h + 1), w, blk) for h, w in enumerate(widths)]
        rights = [_band(blocks, pos, axis, h + 1, w, blk) for h, w in enumerate(widths)]
        out[pos] = torch.cat(lefts[::-1] + [blk] + rights, dim=axis)
    return out


def halo_pad_nd(blocks: np.ndarray, eps: int) -> np.ndarray:
    """Rank-agnostic halo pad of an object array of blocks (one per mesh
    position, the array's shape the mesh's): one eps-band exchange per mesh
    axis, in axis order, so every corner and edge region arrives without
    diagonal sends."""
    out = blocks
    for axis in range(blocks.ndim):
        out = _axis_halo(out, axis, int(eps))
    return out
