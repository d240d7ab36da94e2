"""The distributed halo path's kernels and exchange plan — counterpart of
``nonlocalheatequation_tpu/ops/pallas_halo.py``.

* :func:`plan_exchange`, :class:`HaloMsg`, :func:`plan_bytes`,
  :func:`collective_bytes` and :func:`halo_stats`: the JAX package's
  exchange geometry and byte counts (host arithmetic, copied), behind the
  distributed solvers' ``/halo/bytes`` and ``/halo/exchanges`` counters;
  the plan also sets which blocks the in-kernel exchange reads.
* Two hand-written CUDA kernels replace the fused halo kernels, the
  exchange inside the kernel: :func:`fused_nsum2d` replaces
  ``build_fused_nsum_2d`` (pallas_halo.py:611) and :func:`fused_nsum3d`
  ``build_fused_nsum_3d`` (:653).  Where the TPU kernel pushes the bands
  into its neighbours' frames by remote DMA, a block's launch here reads
  them in place: it takes device pointers to the blocks around it and each
  tile loads its window straight from the blocks that hold it
  (csrc/fused_nsum2d.cu, fused_nsum3d.cu).  The blocks may be virtual
  devices of one card or cards that read each other's memory (peer
  access, NVLink).
* Two more replace the split compute kernels, for a mesh whose cards
  cannot read each other: :func:`split_nsum2d` replaces
  ``build_split_nsum_2d`` (:437) and :func:`split_nsum3d`
  ``build_split_nsum_3d`` (:474).  Each takes a block's halo frame, filled
  by the band copies of parallel/halo.py, and sums the interior (the cells
  whose window reads no halo), then the eps-wide ring, one launch per
  phase (csrc/split_nsum2d.cu, split_nsum3d.cu); a block with a side <=
  2*eps has no interior and is summed in one launch.
* :func:`make_fused_apply`: the ``comm='fused'`` operator of the
  distributed solvers, ``du = c*dh*dh*(nsum - wsum*operand(u))`` (3D:
  ``c*dh**3*(...)``) in ``NonlocalOp*.apply_padded``'s expression.

Every kernel here runs the tile body of nsum2d/nsum3d (csrc/stencil_tile.cuh,
stencil_tile3d.cuh), whose summation order does not depend on where a tile
sits, so each is bitwise the one-pass ``nsum2d``/``nsum3d`` on the
halo-exchanged frame and the fused path is bitwise the collective one.

:func:`fused_transport` picks the kernels, as the JAX package's picks remote
DMA on a TPU and the split kernel elsewhere: ``'peer'`` (the in-kernel
exchange) when every block is on CUDA cards that can read each other's
memory, ``'interp'`` (band copies, then the split kernels) otherwise, and
on the CPU, where the plain versions run.  ``NLHEAT_FUSED_TRANSPORT=interp``
picks the split kernels on any mesh.  The JAX package's VMEM fit gate
(``fits_fused``) has no counterpart: the kernels here stream from device
memory, so no block is refused for its size.

The split kernels' frame is ``(bx+2e, by+2e)`` (3D ``(bx+2e, by+2e,
bz+2e)``), contiguous, halo filled: the JAX frame's ``pad`` rows of roll
slack below it are not needed here.  As in ops/cuda_kernel.py: a CPU tensor
goes to the plain version beside each wrapper (written as the JAX package
writes the phases and the exchange); a CUDA tensor launches the kernel or
raises; ``cuda_kernel.LAUNCHES`` counts each launch.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
from dataclasses import dataclass

import numpy as np
import torch

from nonlocalheatequation_torch.ops.constants import validate_precision
from nonlocalheatequation_torch.ops.cuda_kernel import (
    _DTYPE_CODE,
    LAUNCHES,
    _check_device,
    _check_state,
    _entry,
    _raise_on,
    bf16_round,
    nsum2d_plain,
)
from nonlocalheatequation_torch.ops.cuda_kernel3d import nsum3d_plain
from nonlocalheatequation_torch.parallel.halo import _inside, halo_pad_nd, hop_widths
from nonlocalheatequation_torch.parallel.mesh import map_blocks
from nonlocalheatequation_torch.parallel.multihost import is_remote

#: the phase argument of the C entry points (csrc/split_nsum2d.cu, split_nsum3d.cu)
PHASES = {"all": 0, "interior": 1, "ring": 2}
#: the most blocks the in-kernel exchange's neighbour table holds
#: (csrc/fused_nsum2d.cu, fused_nsum3d.cu: MAX_NB)
MAX_NEIGHBOURS = 125


# -- the exchange plan: the reference's neighbour rectangles on a mesh -----------------

@dataclass(frozen=True)
class HaloMsg:
    """One directed band: the sender at mesh position p pushes
    ``block[src]`` into the frame of the receiver at ``p + offset``,
    landing at ``frame[dst]``.  ``src`` is in sender block coordinates,
    ``dst`` in receiver frame coordinates (block at offset eps per axis);
    both are per-axis ``(start, stop)`` pairs."""

    offset: tuple[int, ...]
    src: tuple[tuple[int, int], ...]
    dst: tuple[tuple[int, int], ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(b - a for a, b in self.src)

    def size(self) -> int:
        return int(np.prod(self.shape))


def _axis_ranges(extent: int, nshards: int, eps: int):
    """Per-axis {offset: (src_range, dst_range)} for one mesh axis; hops
    capped at ``nshards - 1`` (a band from beyond the mesh does not exist,
    and the un-sent halo stays zero: the volumetric boundary condition)."""
    widths = hop_widths(eps, extent)
    hops = min(len(widths), max(nshards - 1, 0))
    ranges = {0: ((0, extent), (eps, eps + extent))}
    for h in range(1, hops + 1):
        w = widths[h - 1]
        # +h: the sender's last w rows -> the receiver's low halo, (h-1)*extent deep
        lo = eps - (h - 1) * extent - w
        ranges[h] = ((extent - w, extent), (lo, lo + w))
        # -h: the sender's first w rows -> the receiver's high halo
        hi = eps + extent + (h - 1) * extent
        ranges[-h] = ((0, w), (hi, hi + w))
    return ranges


def plan_exchange(mesh_shape: tuple[int, ...], block_shape: tuple[int, ...],
                  eps: int) -> tuple[HaloMsg, ...]:
    """Every band one device pushes per exchange, one message per
    neighbour offset (8 in 2D at one hop; ``(2m+1)^d - 1`` when the horizon
    spans m blocks), in a deterministic order."""
    if len(mesh_shape) != len(block_shape):
        raise ValueError(f"mesh_shape {mesh_shape} and block_shape {block_shape} "
                         "disagree in rank")
    per_axis = [_axis_ranges(int(b), int(n), int(eps))
                for b, n in zip(block_shape, mesh_shape, strict=True)]
    msgs = []
    offsets = [sorted(r.keys()) for r in per_axis]
    for combo in np.ndindex(*[len(o) for o in offsets]):
        off = tuple(offsets[ax][i] for ax, i in enumerate(combo))
        if all(o == 0 for o in off):
            continue
        src = tuple(per_axis[ax][o][0] for ax, o in enumerate(off))
        dst = tuple(per_axis[ax][o][1] for ax, o in enumerate(off))
        msgs.append(HaloMsg(offset=off, src=src, dst=dst))
    return tuple(msgs)


def plan_bytes(plan, itemsize: int) -> int:
    """Bytes one interior device pushes per exchange under ``plan``."""
    return sum(m.size() for m in plan) * int(itemsize)


def collective_bytes(mesh_shape: tuple[int, ...], block_shape: tuple[int, ...], eps: int,
                     itemsize: int) -> int:
    """Bytes one device sends per ``halo_pad_nd`` exchange (both
    directions), with the hop-capped widths.  Axis k's bands carry the
    earlier axes' halos, so extents grow by 2*eps per completed axis."""
    total = 0
    extents = [int(b) for b in block_shape]
    for ax, (bs, nshards) in enumerate(zip(block_shape, mesh_shape, strict=True)):
        if int(nshards) <= 1:
            extents[ax] += 2 * eps
            continue
        other = 1
        for j, e in enumerate(extents):
            if j != ax:
                other *= e
        per_direction = sum(hop_widths(eps, int(bs)))
        total += 2 * per_direction * other * int(itemsize)
        extents[ax] += 2 * eps
    return total


def halo_stats(mesh_shape: tuple[int, ...], block_shape: tuple[int, ...], eps: int,
               comm: str, itemsize: int) -> dict:
    """Per-device, per-exchange-round traffic of one schedule: the numbers
    behind the /halo/bytes and /halo/exchanges counters and the
    halo.exchange span's attributes.  Host arithmetic only."""
    if comm == "fused":
        plan = plan_exchange(mesh_shape, block_shape, eps)
        return {"messages": len(plan), "bytes": plan_bytes(plan, itemsize)}
    nmsg = sum(2 * min(len(hop_widths(eps, int(b))), max(int(n) - 1, 0))
               for b, n in zip(block_shape, mesh_shape, strict=True))
    return {"messages": nmsg,
            "bytes": collective_bytes(mesh_shape, block_shape, eps, itemsize)}


# -- gates --------------------------------------------------------------------------

def require_fused(op, block_shape: tuple[int, ...], dtype=None, ksteps: int = 1) -> None:
    """Refuse every configuration ``comm='fused'`` cannot serve, instead of
    downgrading it to the collective path.  No block is refused for its
    size (the JAX package's VMEM gate has no counterpart here)."""
    if len(block_shape) not in (2, 3):
        raise ValueError(f"comm='fused' serves 2D/3D grids; got rank {len(block_shape)}")
    if op.method != "cuda":
        raise ValueError(
            f"comm='fused' runs the CUDA halo kernels and needs method='cuda' "
            f"explicitly (got method={op.method!r}); use comm='collective' for the other "
            "methods")
    if not getattr(op, "uniform", True):
        raise ValueError("comm='fused' supports the uniform influence function only (J == 1, "
                         "the sat/cuda identity); use comm='collective'")
    if max(1, int(ksteps)) != 1:
        raise ValueError(
            "comm='fused' fuses the exchange into each step; the superstep's K-wide "
            "exchange is a different schedule — use comm='collective' with superstep, or "
            "superstep=1")
    if dtype is not None and dtype not in _DTYPE_CODE:
        raise ValueError(f"comm='fused': the halo kernels take float32 or float64, got {dtype}")


@functools.lru_cache(maxsize=None)
def _can_peer(a: int, b: int) -> bool:
    return torch.cuda.can_device_access_peer(a, b)


def fused_transport(devices=()) -> str:
    """Which kernels ``comm='fused'`` runs on a mesh over ``devices``:
    ``'peer'``, the in-kernel exchange (fused_nsum2d/3d), when every device
    is a CUDA card and the cards can read each other's memory (one card
    always can); else ``'interp'``, the band copies and then the split
    kernels (on the CPU their plain versions: the JAX package's answer off
    a TPU).  A mesh whose blocks span ranks (parallel/multihost.py) takes
    ``'interp'``: the in-kernel exchange reads other blocks by device
    pointer, which no other process's block offers.
    ``NLHEAT_FUSED_TRANSPORT=interp`` picks ``'interp'`` on any mesh."""
    forced = os.environ.get("NLHEAT_FUSED_TRANSPORT", "")
    if forced not in ("", "interp"):
        raise ValueError(f"NLHEAT_FUSED_TRANSPORT={forced!r}: the only value is 'interp'")
    cards = set()
    for d in devices:
        if is_remote(d):
            return "interp"
        d = torch.device(d)
        if d.type != "cuda":
            return "interp"
        cards.add(d.index if d.index is not None else torch.cuda.current_device())
    if not cards or forced:
        return "interp"
    if all(_can_peer(a, b) for a in cards for b in cards if a != b):
        return "peer"
    return "interp"


def degenerate(block_shape: tuple[int, ...], eps: int) -> bool:
    """No interior cells (a side <= 2*eps, the multi-hop-sized block): the
    sum runs as one whole-block pass."""
    return any(int(b) <= 2 * eps for b in block_shape)


def _phases(block_shape, eps: int) -> tuple[str, ...]:
    return ("all",) if eps == 0 or degenerate(block_shape, eps) else ("interior", "ring")


# -- plain versions -------------------------------------------------------------------

def split_nsum2d_plain(frame: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """The neighbour sum of the (bx, by) block of a filled (bx+2e, by+2e)
    frame, interior then the four e-wide ring bands, as the JAX package's
    ``_nsum_phases_2d`` evaluates them."""
    e = int(eps)
    bx, by = frame.shape[0] - 2 * e, frame.shape[1] - 2 * e
    if precision == "bf16":
        frame = bf16_round(frame)
    if _phases((bx, by), e) == ("all",):
        return nsum2d_plain(frame, e)
    out = torch.empty((bx, by), dtype=frame.dtype, device=frame.device)
    out[e:bx - e, e:by - e] = nsum2d_plain(frame[e:bx + e, e:by + e], e)
    out[:e, :] = nsum2d_plain(frame[:3 * e, :], e)
    out[bx - e:, :] = nsum2d_plain(frame[bx - e:, :], e)
    out[e:bx - e, :e] = nsum2d_plain(frame[e:bx + e, :3 * e], e)
    out[e:bx - e, by - e:] = nsum2d_plain(frame[e:bx + e, by - e:], e)
    return out


def split_nsum3d_plain(frame: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """The 3D twin of :func:`split_nsum2d_plain`: the interior box, then the
    six face slabs of the ring (x slabs full-face, y slabs on the middle x
    rows, z slabs on the middle xy core), as ``_nsum_phases_3d``."""
    e = int(eps)
    bx, by, bz = (s - 2 * e for s in frame.shape)
    if precision == "bf16":
        frame = bf16_round(frame)
    if _phases((bx, by, bz), e) == ("all",):
        return nsum3d_plain(frame, e)
    out = torch.empty((bx, by, bz), dtype=frame.dtype, device=frame.device)
    mid = slice(e, bx + e)  # the frame rows of the middle x rows' windows
    out[e:bx - e, e:by - e, e:bz - e] = nsum3d_plain(frame[mid, e:by + e, e:bz + e], e)
    out[:e] = nsum3d_plain(frame[:3 * e], e)
    out[bx - e:] = nsum3d_plain(frame[bx - e:], e)
    out[e:bx - e, :e] = nsum3d_plain(frame[mid, :3 * e], e)
    out[e:bx - e, by - e:] = nsum3d_plain(frame[mid, by - e:], e)
    out[e:bx - e, e:by - e, :e] = nsum3d_plain(frame[mid, e:by + e, :3 * e], e)
    out[e:bx - e, e:by - e, bz - e:] = nsum3d_plain(frame[mid, e:by + e, bz - e:], e)
    return out


@functools.lru_cache(maxsize=None)
def neighbour_hops(mesh_shape: tuple[int, ...], block_shape: tuple[int, ...],
                   eps: int) -> tuple[int, ...]:
    """Per axis, how many blocks away the in-kernel exchange reads: the
    largest offset of :func:`plan_exchange` (hops capped by the mesh)."""
    plan = plan_exchange(mesh_shape, block_shape, eps)
    return tuple(max((abs(m.offset[ax]) for m in plan), default=0)
                 for ax in range(len(mesh_shape)))


def fused_nsum_plain(blocks: np.ndarray, pos: tuple, eps: int,
                     precision: str = "f32") -> torch.Tensor:
    """The neighbour sum of the block at mesh position ``pos`` of an object
    array of equal blocks, its halo taken from the blocks around it: each
    band of :func:`plan_exchange` lands in a zero frame as the TPU kernel's
    remote copies land it (the sender at ``pos - offset``; none from beyond
    the mesh), then the interior and ring are summed as
    :func:`split_nsum2d_plain`/:func:`split_nsum3d_plain` sum them."""
    e = int(eps)
    u = blocks[pos]
    frame = torch.zeros(tuple(b + 2 * e for b in u.shape), dtype=u.dtype, device=u.device)
    frame[tuple(slice(e, e + b) for b in u.shape)] = u
    for msg in plan_exchange(blocks.shape, tuple(u.shape), e):
        sender = tuple(p - o for p, o in zip(pos, msg.offset, strict=True))
        if _inside(sender, blocks.shape):
            band = blocks[sender][tuple(slice(a, b) for a, b in msg.src)]
            frame[tuple(slice(a, b) for a, b in msg.dst)] = band.to(u.device)
    plain = split_nsum2d_plain if u.dim() == 2 else split_nsum3d_plain
    return plain(frame, e, precision)


# -- kernel wrappers --------------------------------------------------------------------

def _split(name: str, frame: torch.Tensor, eps: int, precision: str, plain, dims: int):
    eps = int(eps)
    validate_precision(precision)
    if frame.dim() != dims or min(frame.shape) < 2 * eps:
        raise ValueError(f"{name}: frame {tuple(frame.shape)} too small for eps={eps}")
    if frame.device.type == "cpu":
        return plain(frame, eps, precision)
    _check_state(f"{name} frame", frame, frame.shape)
    _check_device(frame)
    block = tuple(s - 2 * eps for s in frame.shape)
    out = torch.empty(block, dtype=frame.dtype, device=frame.device)
    if out.numel() == 0:
        return out
    for phase in _phases(block, eps):
        launch_phase(name, frame, out, eps, precision, phase)
    return out


def launch_phase(name: str, frame: torch.Tensor, out: torch.Tensor, eps: int,
                 precision: str, phase: str) -> None:
    """One launch of the split kernel ``name`` computing ``phase`` of a
    checked CUDA frame into ``out`` (the wrappers call it once per phase;
    a benchmark may time one phase)."""
    block = tuple(out.shape)
    with torch.cuda.device(frame.device):
        rc = _entry(f"nlheat_{name}")(
            _DTYPE_CODE[frame.dtype], int(precision == "bf16"), frame.data_ptr(),
            out.data_ptr(), *block, int(eps), PHASES[phase],
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name, eps, frame, "use comm='collective' for this horizon")
    LAUNCHES[name] += 1


def split_nsum2d(frame: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """(bx+2e, by+2e) filled halo frame -> (bx, by) masked-circle neighbour
    sum: the interior launch, then the ring launch (one launch for a
    degenerate block).  ``precision="bf16"`` rounds the operand to bfloat16
    at the load and accumulates in the frame's dtype."""
    return _split("split_nsum2d", frame, eps, precision, split_nsum2d_plain, 2)


def split_nsum3d(frame: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """(bx+2e, by+2e, bz+2e) filled halo frame -> (bx, by, bz)
    masked-sphere neighbour sum, interior box then the six ring slabs."""
    return _split("split_nsum3d", frame, eps, precision, split_nsum3d_plain, 3)


def _pointer_grid(name: str, blocks: np.ndarray, eps: int, dims: int):
    """Check a mesh of blocks for the in-kernel exchange once: ``(hops,
    grid, cards)``, the exchange's reach per axis, the blocks' device
    pointers in a zero-padded array of the mesh's shape + 2*hops, so that
    the neighbour table of position p is ``grid[p : p + 2*hops + 1]``, and
    the cards the blocks sit on (peer access between them turned on)."""
    u0 = blocks.flat[0]
    if blocks.ndim != dims or u0.dim() != dims:
        raise ValueError(f"{name}: a rank-{dims} mesh of rank-{dims} blocks, got a "
                         f"{blocks.shape} mesh of {tuple(u0.shape)} blocks")
    hops = neighbour_hops(tuple(blocks.shape), tuple(u0.shape), eps)
    if int(np.prod([2 * h + 1 for h in hops])) > MAX_NEIGHBOURS:
        raise ValueError(
            f"comm='fused': eps={eps} reaches {hops} blocks away on a {blocks.shape} mesh of "
            f"{tuple(u0.shape)} blocks, more than the in-kernel exchange's table of "
            f"{MAX_NEIGHBOURS} blocks; use larger blocks or comm='collective'")
    if u0.device.type == "cpu":
        return hops, None, []
    grid = np.zeros([m + 2 * h for m, h in zip(blocks.shape, hops, strict=True)], np.uint64)
    for pos in np.ndindex(*blocks.shape):
        b = blocks[pos]
        _check_state(f"{name} block {pos}", b, u0.shape)
        _check_device(b)
        if b.dtype != u0.dtype:
            raise ValueError(f"{name}: block {pos} is {b.dtype}, block 0 {u0.dtype}")
        grid[tuple(p + h for p, h in zip(pos, hops, strict=True))] = b.data_ptr()
    cards = sorted({b.device.index for b in blocks.flat})
    if len(cards) > 1:
        _enable_peers(cards)
    return hops, grid, cards


def _launch_fused(name: str, blocks: np.ndarray, pos: tuple, eps: int, precision: str,
                  hops, grid) -> torch.Tensor:
    """One launch of the in-kernel-exchange kernel ``name`` for the block at
    ``pos`` (CPU blocks: the plain version); the caller orders it after the
    neighbours' writes on other cards (:func:`_streams_meet`)."""
    u = blocks[pos]
    if grid is None:
        return fused_nsum_plain(blocks, pos, eps, precision)
    out = torch.empty_like(u)
    if out.numel() == 0:
        return out
    table = np.ascontiguousarray(
        grid[tuple(slice(p, p + 2 * h + 1) for p, h in zip(pos, hops, strict=True))])
    with torch.cuda.device(u.device):
        rc = _entry(f"nlheat_{name}")(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), table.ctypes.data_as(ctypes.c_void_p),
            *hops, out.data_ptr(), *u.shape, eps, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, name, eps, u, "use comm='collective' for this horizon")
    LAUNCHES[name] += 1
    return out


def _fused(name: str, blocks: np.ndarray, pos: tuple, eps: int, precision: str,
           dims: int) -> torch.Tensor:
    validate_precision(precision)
    hops, grid, cards = _pointer_grid(name, blocks, int(eps), dims)
    _streams_meet(cards)
    out = _launch_fused(name, blocks, tuple(pos), int(eps), precision, hops, grid)
    _streams_meet(cards)
    return out


def fused_nsum2d(blocks: np.ndarray, pos: tuple, eps: int,
                 precision: str = "f32") -> torch.Tensor:
    """The (bx, by) masked-circle neighbour sum of the block at ``pos`` of
    a 2D object array of equal contiguous blocks, its halo read in the
    kernel from the blocks around it (one launch).  Blocks on several
    cards: peer access is turned on once, and the cards' streams meet
    before the launch and after it."""
    return _fused("fused_nsum2d", blocks, pos, eps, precision, 2)


def fused_nsum3d(blocks: np.ndarray, pos: tuple, eps: int,
                 precision: str = "f32") -> torch.Tensor:
    """The 3D twin of :func:`fused_nsum2d`: the masked-sphere sum."""
    return _fused("fused_nsum3d", blocks, pos, eps, precision, 3)


_peers_on: set = set()


def _enable_peers(cards) -> None:
    """Let every card of a mesh read the others' memory (once per pair)."""
    for a in cards:
        for b in cards:
            if a != b and (a, b) not in _peers_on:
                rc = _entry("nlheat_enable_peer")(a, b)
                if rc != 0:
                    raise RuntimeError(f"peer access from cuda:{a} to cuda:{b} failed: "
                                       f"CUDA error {rc}")
                _peers_on.add((a, b))


def _streams_meet(cards) -> None:
    """Make every card's current stream wait for what each other card's
    stream has queued so far (the counterpart of the TPU kernel's
    readiness barrier and send waits); nothing for one card, whose stream
    orders its launches."""
    if len(cards) < 2:
        return
    events = {}
    for c in cards:
        events[c] = torch.cuda.Event()
        events[c].record(torch.cuda.current_stream(c))
    for c in cards:
        for other, ev in events.items():
            if other != c:
                torch.cuda.current_stream(c).wait_event(ev)


# -- the solvers' comm='fused' operator -----------------------------------------------

def make_fused_apply(op, mesh_shape: tuple[int, ...], axis_names: tuple[str, ...],
                     transport: str | None = None):
    """The ``comm='fused'`` operator of a distributed solver: an object
    array of blocks (parallel/mesh.py) -> the array of their L(u) blocks,
    halos included.  ``transport`` (default :func:`fused_transport` of the
    blocks' devices): ``'peer'``, one in-kernel-exchange launch per block;
    ``'interp'``, the bands moved by ``halo_pad_nd``, then each frame's
    split kernel.  ``du`` is formed outside the kernel in exactly
    ``apply_padded``'s expression and fold order."""
    if len(axis_names) != len(mesh_shape):
        raise ValueError(f"axis names {axis_names} and mesh shape {mesh_shape} disagree")
    if transport not in (None, "peer", "interp"):
        raise ValueError(f"transport must be 'peer' or 'interp', got {transport!r}")
    eps = int(op.eps)
    precision = getattr(op, "precision", "f32")
    validate_precision(precision)
    dims = len(mesh_shape)
    split = split_nsum2d if dims == 2 else split_nsum3d
    name = f"fused_nsum{dims}d"

    def nsums(blocks: np.ndarray) -> np.ndarray:
        devices = [b if is_remote(b) else b.device for b in blocks.flat]
        mode = transport or fused_transport(devices)
        if mode == "interp":
            return map_blocks(lambda f: split(f, eps, precision), halo_pad_nd(blocks, eps))
        if any(is_remote(d) for d in devices):
            raise ValueError("transport 'peer' reads every block by device pointer; a mesh "
                             "whose blocks span ranks takes 'interp'")
        hops, grid, cards = _pointer_grid(name, blocks, eps, dims)
        out = np.empty(blocks.shape, dtype=object)
        _streams_meet(cards)  # every block written before any neighbour reads it
        for pos in np.ndindex(*blocks.shape):
            out[pos] = _launch_fused(name, blocks, pos, eps, precision, hops, grid)
        _streams_meet(cards)  # every read done before any block is freed or rewritten
        return out

    # c * dh * dh (3D: c * dh ** 3), as apply_padded folds it
    scale = op.c * op.dh * op.dh if dims == 2 else op.c * op.dh ** 3

    def apply_fused(blocks: np.ndarray) -> np.ndarray:
        return map_blocks(lambda u_blk, n: scale * (n - op.wsum * op._operand(u_blk)),
                          blocks, nsums(blocks))

    return apply_fused
