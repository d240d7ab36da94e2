"""Sharded spectral transforms — counterpart of
``nonlocalheatequation_tpu/ops/spectral_sharded.py``, the distributed twin of
ops/spectral.py.

The whole-domain spectral path is exact by the zero-collar embedding
(ops/spectral.py); a halo-padded block carries neighbour data, so the padded
entry points refuse fft.  The sharded case keeps that boundary: the global
5-smooth zero-padded box is still the transform domain, computed by a
per-axis pencil decomposition whose transposes run over the mesh's axes.
No halo is ever wrapped.

The JAX package transposes with ``lax.all_to_all(..., tiled=True)`` inside a
``shard_map``; here each rank holds the blocks it owns (parallel/mesh.py),
and :func:`all_to_all` is the same exchange over the object array of
blocks: the block at position k of a mesh axis takes chunk k of every block
along that axis (fixed mesh order) and concatenates them.  A chunk moved
between virtual devices of one device is a copy on that device; the chunks
between ranks travel in one ``torch.distributed`` ``all_to_all_single`` a
transpose (parallel/multihost.all_to_all), in the same order.  The transforms are
``torch.fft.rfft``/``fft``/``ifft``/``irfft`` with the JAX package's ``n=``
padding, on each block's device (cuFFT on the card).

Layout (2D, mesh (mx, my), block (bx, by), box (BX, BY), BYr = BY//2 + 1,
BYrp = BYr rounded up to a multiple of mx*my), JAX ``:15-37``:

forward   (bx, by)                 real block, position (i, j)
  a2a y   (bx/my, NY)              row pencils (split ax0, concat ax1)
  rfft    (bx/my, BYr)             last-axis real FFT, n=BY (the y collar)
  pad     (bx/my, BYrp)            zero frequency columns to divisibility
  a2a y   (bx, BYrp/my)            freq chunk j of the x-block rows
  a2a x   (NX, BYrp/(mx*my))       column pencils, freq chunk j*mx + i
  fft     (BX, BYrp/(mx*my))       axis-0 complex FFT, n=BX (the x collar)

so the global frequency array is laid out ``P(None, ("y", "x"))``: axis 1 in
chunks, y-major (:meth:`ShardedSpectralPlan.freq_block`).  The inverse is
the mirror.  3D adds a transpose pair around the middle axis, whose FFT
output (length BY) is zero-padded to a multiple of my *after* the
transform; the layout is ``P(None, "y", ("z", "x"))``.

Divisibility: mx | NX, my | NY (mz | NZ), and ``NX % (mx*my) == 0`` (2D) /
``NX % (mx*mz) == 0`` (3D).  :func:`supports_sharded_fft` is the capability
gate, :func:`require_sharded_fft` the refusal at construction, and
``NLHEAT_FFT_SHARDED=0`` the kill-switch the JAX gate reads.

Numerics: the per-axis FFTs and transposes reassociate the sums of the
one-shot ``rfftn``, so the results hold the <= 1e-12 contract against
ops/spectral.py, not bitwise.  Runs are bitwise deterministic: the
schedule is static and the concatenation order is the mesh order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from nonlocalheatequation_torch.ops.spectral import fft_box, neighbor_symbol
from nonlocalheatequation_torch.parallel.mesh import first_local, map_blocks
from nonlocalheatequation_torch.parallel.multihost import (
    Remote,
    RemoteDevice,
    gather_blocks,
    process_count,
)
from nonlocalheatequation_torch.parallel.multihost import all_to_all as multihost_all_to_all


def _round_up(n: int, mult: int) -> int:
    """Smallest multiple of ``mult`` >= ``n``."""
    return -(-int(n) // int(mult)) * int(mult)


def sharded_fft_enabled() -> bool:
    """The kill-switch: ``NLHEAT_FFT_SHARDED=0`` disables the sharded
    spectral tier everywhere (the gate reports unsupported, the solvers
    refuse construction)."""
    return os.environ.get("NLHEAT_FFT_SHARDED", "1") != "0"


def supports_sharded_fft(shape, eps: int, mesh_shape) -> bool:
    """Whether the pencil decomposition serves ``shape`` on a mesh of
    ``mesh_shape`` (host arithmetic)."""
    if not sharded_fft_enabled():
        return False
    shape = tuple(int(n) for n in shape)
    mesh_shape = tuple(int(m) for m in mesh_shape)
    if len(shape) != len(mesh_shape) or len(shape) not in (2, 3):
        return False
    if any(n % m for n, m in zip(shape, mesh_shape)):
        return False  # the solver's own uniform-block requirement
    # the first transpose splits the x-block rows across the LAST axis
    return shape[0] % (mesh_shape[0] * mesh_shape[-1]) == 0


def require_sharded_fft(shape, eps: int, mesh_shape) -> None:
    """Refuse at construction (never a silent downgrade) when the pencil
    decomposition cannot serve this (grid, mesh) pair; the JAX words."""
    if supports_sharded_fft(shape, eps, mesh_shape):
        return
    if not sharded_fft_enabled():
        raise ValueError(
            "method='fft' on the distributed path is disabled by "
            "NLHEAT_FFT_SHARDED=0 (kill-switch); unset it or run the "
            "stencil methods")
    raise ValueError(
        f"sharded fft cannot serve grid {tuple(shape)} on mesh "
        f"{tuple(mesh_shape)}: the pencil transposes need every axis "
        "to divide its mesh extent and the leading extent to divide "
        "mesh[0]*mesh[-1] (ops/spectral_sharded.py layout); pick a "
        "compatible mesh or run the stencil methods")


def all_to_all(blocks: np.ndarray, axis: int, split_axis: int, concat_axis: int) -> np.ndarray:
    """``lax.all_to_all(x, name, split_axis, concat_axis, tiled=True)`` over
    mesh axis ``axis`` of an object array of blocks: the block at position k
    along ``axis`` receives chunk k (of m equal chunks along ``split_axis``)
    of every block on its line, concatenated along ``concat_axis`` in mesh
    order.  One mesh position along ``axis``: the blocks unchanged.  Chunks
    from other ranks' blocks arrive by one ``all_to_all_single`` of the
    group, every rank listing them in the schedule's order (receivers in
    mesh order, senders along the line)."""
    m = blocks.shape[axis]
    if m == 1:
        return blocks
    first = first_local(blocks)

    def chunk(x, k):
        n = x.shape[split_axis] // m
        return x.narrow(split_axis, k * n, n)

    sends, recvs, slots = {}, {}, {}
    for pos in np.ndindex(*blocks.shape):
        for j in range(m):
            src = list(pos)
            src[axis] = j
            sb, dst = blocks[tuple(src)], blocks[pos]
            if isinstance(dst, Remote) and not isinstance(sb, Remote):
                sends.setdefault(dst.rank, []).append(chunk(sb, pos[axis]))
            elif isinstance(sb, Remote) and not isinstance(dst, Remote):
                shape = list(first.shape)
                shape[split_axis] //= m
                recvs.setdefault(sb.rank, []).append((tuple(shape), first.dtype))
                slots.setdefault(sb.rank, []).append((pos, j))
    got = {}
    if process_count() > 1:  # a collective every rank of the group joins
        moved = multihost_all_to_all(sends, recvs, first.device if first is not None else None)
        for peer, keys in slots.items():
            got.update(zip(keys, moved[peer], strict=True))
    out = np.empty(blocks.shape, dtype=object)
    for pos in np.ndindex(*blocks.shape):
        dst = blocks[pos]
        if isinstance(dst, Remote):
            out[pos] = dst
            continue
        parts = []
        for j in range(m):
            src = list(pos)
            src[axis] = j
            sb = blocks[tuple(src)]
            part = got[(pos, j)] if isinstance(sb, Remote) else chunk(sb, pos[axis])
            parts.append(part.to(dst.device))
        out[pos] = torch.cat(parts, dim=concat_axis)
    return out


def _pad_axis(h: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """``h`` zero-padded at the end of ``axis`` to length ``n``."""
    extra = n - h.shape[axis]
    if extra <= 0:
        return h
    shape = list(h.shape)
    shape[axis] = extra
    return torch.cat([h, h.new_zeros(shape)], dim=axis)


class ShardedSpectralPlan:
    """The transpose and transform schedule of one (shape, eps, mesh) —
    JAX ``ShardedSpectralPlan`` (``:122-325``).

    ``fwd``/``inv`` map an object array of blocks (parallel/mesh.py) to the
    array of their frequency pencils and back; ``freq_global_shape`` is the
    padded global frequency array, ``pad_freq`` pads a host rfftn-layout
    array to it, and :meth:`freq_block`/:meth:`put_freq`/:meth:`fetch_freq`
    place a global frequency array on the mesh (the JAX ``freq_spec``
    sharding) and gather it back."""

    def __init__(self, shape, eps: int, mesh_shape, axis_names=None):
        shape = tuple(int(n) for n in shape)
        mesh_shape = tuple(int(m) for m in mesh_shape)
        require_sharded_fft(shape, eps, mesh_shape)
        self.shape = shape
        self.eps = int(eps)
        self.mesh_shape = mesh_shape
        self.box = fft_box(shape, eps)
        nd = len(shape)
        self.axis_names = tuple(axis_names if axis_names is not None
                                else ("x", "y", "z")[:nd])
        ndev = int(np.prod(mesh_shape))
        last_r = self.box[-1] // 2 + 1  # rfft bins of the last box axis
        if nd == 2:
            # frequency axis 1 padded so mx*my chunks tile it exactly
            self.freq_global_shape = (self.box[0], _round_up(last_r, ndev))
            self.freq_spec = (None, (self.axis_names[1], self.axis_names[0]))
        else:
            # the middle axis padded to a multiple of my (the transformed-axis
            # zero pad), the last to a multiple of mx*my*mz
            self.freq_global_shape = (self.box[0], _round_up(self.box[1], mesh_shape[1]),
                                      _round_up(last_r, ndev))
            self.freq_spec = (None, self.axis_names[1],
                              (self.axis_names[2], self.axis_names[0]))
        self._last_r = last_r

    # -- host-side helpers ---------------------------------------------------

    def pad_freq(self, arr: np.ndarray) -> np.ndarray:
        """Zero-pad a host array in rfftn frequency layout (box[:-1] +
        (box[-1]//2+1,)) to ``freq_global_shape``: the padded columns multiply
        the zero spectrum the forward path carries there."""
        arr = np.asarray(arr)
        want = tuple(self.box[:-1]) + (self._last_r,)
        if arr.shape != want:
            raise ValueError(f"frequency array shape {arr.shape} != rfftn layout {want} "
                             f"of box {self.box}")
        pad = [(0, g - s) for s, g in zip(arr.shape, self.freq_global_shape, strict=True)]
        return np.pad(arr, pad)

    def neighbor_symbol_padded(self, weights) -> np.ndarray:
        """The neighbour symbol (ops/spectral.neighbor_symbol, host float64,
        cached) in the plan's padded frequency layout."""
        return self.pad_freq(neighbor_symbol(weights, self.box))

    def a2a_schedule(self):
        """The forward transposes as (axis_extent, elems, complex) triples,
        host arithmetic for the traffic counters (the inverse is the mirror:
        the same traffic)."""
        if len(self.shape) == 2:
            (mx, my), (bx, by) = self.mesh_shape, self._block()
            BYrp = self.freq_global_shape[1]
            return [
                (my, bx * by, False),
                (my, (bx // my) * BYrp, True),
                (mx, bx * (BYrp // my), True),
            ]
        (mx, my, mz), (bx, by, bz) = self.mesh_shape, self._block()
        BX, BYp, BZp = self.freq_global_shape
        return [
            (mz, bx * by * bz, False),
            (mz, (bx // mz) * by * BZp, True),
            (my, bx * by * (BZp // mz), True),
            (my, bx * BYp * (BZp // (mz * my)), True),
            (mx, self.shape[0] * (BYp // my) * (BZp // (mz * mx)), True),
        ]

    def _block(self):
        return tuple(n // m for n, m in zip(self.shape, self.mesh_shape, strict=True))

    def freq_block(self, arr, pos: tuple):
        """Position ``pos``'s slice of a global frequency array in the
        ``freq_spec`` layout: 2D axis 1 chunk ``j*mx + i``; 3D axis 1 chunk
        ``j``, axis 2 chunk ``l*mx + i``."""
        mx, my = self.mesh_shape[0], self.mesh_shape[1]
        if len(self.shape) == 2:
            i, j = pos
            w = self.freq_global_shape[1] // (mx * my)
            c = j * mx + i
            return arr[:, c * w:(c + 1) * w]
        i, j, l = pos
        mz = self.mesh_shape[2]
        wy = self.freq_global_shape[1] // my
        wz = self.freq_global_shape[2] // (mz * mx)
        c = l * mx + i
        return arr[:, j * wy:(j + 1) * wy, c * wz:(c + 1) * wz]

    def put_freq(self, arr, devices: np.ndarray, dtype: torch.dtype) -> np.ndarray:
        """A global frequency array (host) placed on the mesh whose devices
        ``devices`` are (an object array of the mesh's shape): each of this
        rank's positions gets its :meth:`freq_block`, a contiguous ``dtype``
        tensor on its device (another rank's: a ``Remote`` placeholder)."""
        x = torch.as_tensor(np.asarray(arr))
        out = np.empty(devices.shape, dtype=object)
        for pos in np.ndindex(*devices.shape):
            d = devices[pos]
            out[pos] = (Remote(d.rank) if isinstance(d, RemoteDevice) else
                        self.freq_block(x, pos).to(device=d, dtype=dtype).contiguous())
        return out

    def fetch_freq(self, blocks: np.ndarray) -> np.ndarray:
        """The global frequency array (host NumPy) of an object array of
        pencils in the ``freq_spec`` layout: the inverse of :meth:`put_freq`,
        on every rank."""
        blocks = gather_blocks(blocks)  # every rank's pencils, in mesh order
        first = blocks.flat[0]
        out = torch.empty(self.freq_global_shape, dtype=first.dtype)
        for pos in np.ndindex(*blocks.shape):
            self.freq_block(out, pos).copy_(blocks[pos].cpu())
        return out.numpy()

    # -- the transforms over the mesh's blocks -------------------------------------

    def fwd(self, blocks: np.ndarray) -> np.ndarray:
        """Real blocks -> the pencils of the global box rfft (module
        docstring layout)."""
        if len(self.shape) == 2:
            return self._fwd2(blocks)
        return self._fwd3(blocks)

    def inv(self, pencils: np.ndarray) -> np.ndarray:
        """Frequency pencils -> the blocks of the inverse transform's domain
        interior (the collar discarded): the inverse of ``fwd`` up to the
        per-axis FFTs' rounding."""
        if len(self.shape) == 2:
            return self._inv2(pencils)
        return self._inv3(pencils)

    def _fwd2(self, u):
        BX, BY = self.box
        BYrp = self.freq_global_shape[1]
        u = all_to_all(u, 1, 0, 1)  # (bx, by) -> (bx/my, NY) row pencils
        # n=BY: the y zero collar; then the frequency columns to divisibility
        h = map_blocks(lambda x: _pad_axis(torch.fft.rfft(x, n=BY, dim=1), 1, BYrp), u)
        h = all_to_all(h, 1, 1, 0)  # back to x-block rows, freq chunk j
        h = all_to_all(h, 0, 1, 0)  # column pencils: all rows, freq chunk j*mx+i
        return map_blocks(lambda x: torch.fft.fft(x, n=BX, dim=0), h)  # n=BX: the x collar

    def _inv2(self, h):
        NX, NY = self.shape
        BY = self.box[1]
        last_r = self._last_r
        u = map_blocks(lambda x: torch.fft.ifft(x, dim=0)[:NX], h)
        u = all_to_all(u, 0, 0, 1)
        u = all_to_all(u, 1, 0, 1)
        u = map_blocks(lambda x: torch.fft.irfft(x[..., :last_r], n=BY, dim=1)[..., :NY], u)
        return all_to_all(u, 1, 1, 0)

    def _fwd3(self, u):
        BX, BYp, BZp = self.freq_global_shape
        BY, BZ = self.box[1], self.box[2]
        u = all_to_all(u, 2, 0, 2)  # (bx, by, bz) -> (bx/mz, by, NZ) z pencils
        # n=BZ: the z zero collar
        h = map_blocks(lambda x: _pad_axis(torch.fft.rfft(x, n=BZ, dim=2), 2, BZp), u)
        h = all_to_all(h, 2, 2, 0)  # back to x-block rows, z-freq chunk l
        h = all_to_all(h, 1, 2, 1)  # y pencils, z-freq chunk l*my + j
        # n=BY: the y collar; then the transformed-axis pad BY -> BYp (zero
        # spectrum rides through the later stages; the inverse slices it off)
        h = map_blocks(lambda x: _pad_axis(torch.fft.fft(x, n=BY, dim=1), 1, BYp), h)
        h = all_to_all(h, 1, 1, 2)  # y chunk j back, z-freq chunk l
        h = all_to_all(h, 0, 2, 0)  # x pencils: all rows, z-freq chunk l*mx + i
        return map_blocks(lambda x: torch.fft.fft(x, n=BX, dim=0), h)  # n=BX: the x collar

    def _inv3(self, h):
        NX, NY, NZ = self.shape
        BY, BZ = self.box[1], self.box[2]
        last_r = self._last_r
        u = map_blocks(lambda x: torch.fft.ifft(x, dim=0)[:NX], h)
        u = all_to_all(u, 0, 0, 2)
        u = all_to_all(u, 1, 2, 1)
        u = map_blocks(lambda x: torch.fft.ifft(x[:, :BY, :], dim=1)[:, :NY, :], u)
        u = all_to_all(u, 1, 1, 2)
        u = all_to_all(u, 2, 0, 2)
        u = map_blocks(lambda x: torch.fft.irfft(x[..., :last_r], n=BZ, dim=2)[..., :NZ], u)
        return all_to_all(u, 2, 2, 0)


#: Plan cache keyed by (shape, eps, mesh_shape, axis_names): plans are pure
#: schedules, shared by every solver.
_plan_cache: dict = {}


def get_plan(shape, eps: int, mesh_shape, axis_names=None) -> ShardedSpectralPlan:
    """Cached :class:`ShardedSpectralPlan` constructor."""
    key = (tuple(int(n) for n in shape), int(eps), tuple(int(m) for m in mesh_shape),
           tuple(axis_names) if axis_names is not None else None)
    plan = _plan_cache.get(key)
    if plan is None:
        plan = ShardedSpectralPlan(shape, eps, mesh_shape, axis_names)
        _plan_cache[key] = plan
    return plan
