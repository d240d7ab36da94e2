"""Halo exchange over a mesh of blocks — counterpart of
``nonlocalheatequation_tpu/parallel/halo.py``.

The JAX package moves each eps-band with ``lax.ppermute`` inside a
``shard_map``.  Here each rank holds the blocks it owns (parallel/mesh.py;
in one process, every block).  A band between two blocks of one rank is a
tensor copy onto the receiver's device; a band between ranks is a
``torch.distributed`` send and receive, all of one axis and hop posted in
one ``batch_isend_irecv`` in the order every rank derives from the mesh
(``parallel/multihost.exchange``; under ``gloo`` a CUDA band is staged
through host memory).  The schedule is the JAX package's:

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

from nonlocalheatequation_torch.parallel.mesh import first_local
from nonlocalheatequation_torch.parallel.multihost import Remote, exchange


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


def _inside(pos, shape) -> bool:
    return all(0 <= p < n for p, n in zip(pos, shape, strict=True))


def _axis_halo(blocks: np.ndarray, axis: int, eps: int) -> np.ndarray:
    """Pad every block this rank owns with an eps-wide halo along ``axis``
    from its mesh neighbours."""
    first = first_local(blocks)
    if first is None:  # this rank owns no block: nothing to send or receive
        return blocks.copy()
    widths = hop_widths(eps, first.shape[axis])
    bands = {}  # (pos, hop, side) -> the band that reaches pos
    for hop, w in enumerate(widths, start=1):
        sends, recvs, keys = [], [], []
        # one schedule for every rank: receivers in mesh order, the band
        # from before (side -1: the sender's trailing rows) then from after
        for i, pos in enumerate(np.ndindex(*blocks.shape)):
            for side in (-1, 1):
                src = list(pos)
                src[axis] += side * hop
                src = tuple(src)
                if not _inside(src, blocks.shape):
                    continue  # beyond the mesh: that halo stays zero
                dst, sb = blocks[pos], blocks[src]
                if isinstance(dst, Remote) and isinstance(sb, Remote):
                    continue
                tag = 2 * i + (side > 0)
                if isinstance(dst, Remote):
                    sends.append((dst.rank, _take_edge(sb, axis, w, last=side < 0), tag))
                elif isinstance(sb, Remote):
                    shape = list(dst.shape)
                    shape[axis] = w
                    recvs.append((sb.rank, shape, dst.dtype, dst.device, tag))
                    keys.append((pos, hop, side))
                else:
                    bands[(pos, hop, side)] = _take_edge(sb, axis, w, last=side < 0).to(dst.device)
        bands.update(zip(keys, exchange(sends, recvs), strict=True))

    def band(pos, hop, side, w, dst):
        b = bands.get((pos, hop, side))
        if b is None:
            shape = list(dst.shape)
            shape[axis] = w
            b = torch.zeros(shape, dtype=dst.dtype, device=dst.device)
        return b

    out = blocks.copy()  # other ranks' positions keep their placeholders
    for pos in np.ndindex(*blocks.shape):
        blk = blocks[pos]
        if isinstance(blk, Remote):
            continue
        # lefts[h]: the band from the block h+1 shards before; rights[h] after
        lefts = [band(pos, h, -1, w, blk) for h, w in enumerate(widths, start=1)]
        rights = [band(pos, h, 1, w, blk) for h, w in enumerate(widths, start=1)]
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
