"""Multi-process execution: one rank a host, every rank running the same
program — counterpart of ``nonlocalheatequation_tpu/parallel/multihost.py``.

The reference scales across nodes with one HPX locality per host
(``srun -n 4 ... --file data_4.txt``, README.md:64-72 of the reference).
The JAX package wires its processes with ``jax.distributed.initialize``;
here :func:`init_from_env` wires them into one ``torch.distributed`` group
(``nccl`` between cards, one card a rank; ``gloo`` on the CPU), from the
same launch variables, so one recipe starts both packages' CLIs.

After that the distributed tier addresses blocks, not hosts.  A mesh
(parallel/mesh.py) is laid over the global device list, every rank's local
devices in rank order (:func:`global_devices`); a position whose device
belongs to another rank holds a :class:`Remote` placeholder instead of a
tensor, so each rank builds and steps only the blocks it owns (a rank may
own none).  Every rank runs the same program: under a group of more than
one rank every gather and transpose is a collective that each rank joins,
whatever it owns.  A band or
pencil chunk between two blocks of one rank stays a copy; between ranks it
moves by :func:`exchange` (point to point) or :func:`all_to_all`.  Host
values reach every rank: :func:`fetch_global` all-gathers the blocks in
mesh order, as the JAX ``_replicate`` does, for any device count a rank.

Under ``gloo`` a CUDA tensor moves through host memory (:func:`_staged`):
the group's backend names the route, nothing is chosen on a failure.  With
no launch signal and no argument every helper is the single-process
behaviour exactly.
"""

from __future__ import annotations

import datetime
import hashlib
import os

import numpy as np
import torch

#: seconds a collective waits for its peers before it raises; a dead peer
#: must end the run, not hang it (``NLHEAT_DIST_TIMEOUT`` overrides)
DEFAULT_TIMEOUT_S = 300.0

_state: dict = {"card": None}


class Remote:
    """The entry of an object array of blocks at a position another rank
    owns: no tensor, only the owner's rank."""

    __slots__ = ("rank",)

    def __init__(self, rank: int):
        self.rank = int(rank)

    def __repr__(self):
        return f"Remote(rank={self.rank})"


class RemoteDevice:
    """A device of another rank in the global device list: its owner's rank,
    its index among that rank's local devices and its ``type`` (``"cuda"``
    or ``"cpu"``, as ``torch.device.type``)."""

    __slots__ = ("rank", "index", "type")

    def __init__(self, rank: int, index: int, kind: str = "cpu"):
        self.rank, self.index, self.type = int(rank), int(index), str(kind)

    def __repr__(self):
        return f"RemoteDevice(rank={self.rank}, index={self.index}, type={self.type!r})"


def is_remote(x) -> bool:
    """A block or device that another rank owns."""
    return isinstance(x, (Remote, RemoteDevice))


# -- the group ----------------------------------------------------------------------

def _dist():
    import torch.distributed as dist

    return dist


def initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return _dist().get_rank() if initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if initialized() else 1


def backend() -> str | None:
    return _dist().get_backend() if initialized() else None


def _multiprocess_signals() -> bool:
    """Launch-environment signals that this is one process of many (the JAX
    function's, read as plain strings): explicit variables, a SLURM
    multi-task allocation (``srun -n N``), or a pod worker list."""
    if os.environ.get("COORDINATOR_ADDRESS") or os.environ.get("JAX_NUM_PROCESSES"):
        return True
    try:
        if int(os.environ.get("SLURM_NTASKS", "1") or 1) > 1:
            return True
    except ValueError:
        pass
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    return len([h for h in hosts.split(",") if h]) > 1


def _env_int(*names) -> int | None:
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def init_from_env(coordinator: str | None = None, num_processes: int | None = None,
                  process_id: int | None = None, backend: str | None = None, *,
                  platform: str | None = None, timeout: float | None = None) -> bool:
    """Wire this process into a multi-process run; returns True if done.

    With no arguments the launch is read from the environment:
    ``COORDINATOR_ADDRESS`` ("host:port", or an ``init_method`` URL such as
    ``file:///path``), ``JAX_NUM_PROCESSES`` (else ``SLURM_NTASKS``) and
    ``JAX_PROCESS_ID`` (else ``SLURM_PROCID``).  Explicit arguments win.
    With no signal and no argument this is a no-op returning False, and
    every path then runs as one process.  A SLURM launch with no
    coordinator is refused: the JAX package defers it to
    ``jax.distributed.initialize``'s auto-configuration, which has no
    counterpart here.

    ``backend`` defaults to ``NLHEAT_DIST_BACKEND`` if set, else ``nccl``
    when ``platform`` (default: the card when there is one) is the card,
    else ``gloo``; ``gloo`` on the card stages every band through host
    memory (ranks sharing one card need it: nccl takes one rank a card).
    On the card each rank takes one card, ``cuda:{local rank % cards}`` (``LOCAL_RANK``, else
    ``SLURM_LOCALID``, else the rank).  ``timeout`` (seconds; default
    ``NLHEAT_DIST_TIMEOUT`` or 300) bounds every collective's wait."""
    dist = _dist()
    if initialized():
        return True
    explicit = bool(coordinator or num_processes) or process_id is not None
    if not explicit and not _multiprocess_signals():
        return False
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator:
        raise RuntimeError(
            "a multi-process launch needs COORDINATOR_ADDRESS=host:port (rank 0's "
            "address) in every rank's environment: the SLURM/pod auto-configuration "
            "of jax.distributed.initialize is not ported")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "SLURM_NTASKS")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "SLURM_PROCID")
    if num_processes is None or process_id is None:
        raise RuntimeError(
            "a multi-process launch needs the process count (JAX_NUM_PROCESSES or "
            "SLURM_NTASKS) and this rank (JAX_PROCESS_ID or SLURM_PROCID)")
    rank, world = int(process_id), int(num_processes)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside 0..{world - 1}")
    on_card = (platform in ("gpu", "cuda") if platform is not None
               else torch.cuda.is_available())
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("the CUDA platform was requested but torch.cuda.is_available() "
                           "is false; launch with --platform cpu to run on the CPU")
    backend = (backend or os.environ.get("NLHEAT_DIST_BACKEND")
               or ("nccl" if on_card else "gloo"))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and not on_card:
        raise ValueError("backend 'nccl' runs between cards; the CPU platform takes 'gloo'")
    if on_card:
        local = _env_int("LOCAL_RANK", "SLURM_LOCALID")
        _state["card"] = (rank if local is None else local) % torch.cuda.device_count()
        torch.cuda.set_device(_state["card"])
    if timeout is None:
        timeout = float(os.environ.get("NLHEAT_DIST_TIMEOUT", DEFAULT_TIMEOUT_S))
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = torch.device("cuda", _state["card"])
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout), **kwargs)
    return True


def local_card() -> int | None:
    """The card this rank took at :func:`init_from_env` (None: no card)."""
    return _state["card"]


def shutdown() -> None:
    """Leave the group (a no-op when there is none)."""
    if initialized():
        _dist().destroy_process_group()
    _state["card"] = None


# -- moving tensors -------------------------------------------------------------------

def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the rank's card
    under nccl, the host under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the group's transport takes it: contiguous, and on the
    host under gloo (a CUDA tensor staged through host memory)."""
    return t.to(_comm_device()).contiguous()


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes, flat uint8, where the group's transport takes them."""
    return _real(_staged(t)).reshape(-1).view(torch.uint8)


def _nbytes(shape, dtype: torch.dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def _from_bytes(b: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    x = b.view(_real(torch.empty(0, dtype=dtype)).dtype)
    if dtype.is_complex:
        return torch.view_as_complex(x.reshape(*shape, 2))
    return x.reshape(tuple(shape))


def exchange(sends, recvs) -> list:
    """Point-to-point messages in one ``batch_isend_irecv``.  ``sends``:
    ``(peer, tensor, tag)``; ``recvs``: ``(peer, shape, dtype, device,
    tag)``, returning the received tensors in ``recvs``' order, each on its
    ``device``.  Every rank posts its part of one schedule in the order
    that schedule lists the messages, so each send meets its receive (nccl
    matches a pair's messages in order, gloo by tag)."""
    if not sends and not recvs:
        return []
    dist = _dist()
    ops, bufs = [], []
    for peer, t, tag in sends:
        ops.append(dist.P2POp(dist.isend, _real(_staged(t)), int(peer), tag=int(tag)))
    for peer, shape, dtype, _device, tag in recvs:
        buf = torch.empty(tuple(shape), dtype=dtype, device=_comm_device())
        bufs.append(buf)
        ops.append(dist.P2POp(dist.irecv, _real(buf), int(peer), tag=int(tag)))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [b.to(spec[3]) for b, spec in zip(bufs, recvs, strict=True)]


def all_to_all(sends: dict, recvs: dict, device) -> dict:
    """One ``all_to_all_single`` of the whole group, in bytes.
    ``sends[peer]``: the tensors for ``peer``, in the schedule's order;
    ``recvs[peer]``: the ``(shape, dtype)`` of each tensor expected from
    ``peer``.  Returns ``{peer: [tensors on device]}``.  Every rank calls
    it, with empty lists where it has nothing to move."""
    dist = _dist()
    world, cdev = process_count(), _comm_device()
    in_split, parts = [], []
    for peer in range(world):
        flat = [_bytes(t) for t in sends.get(peer, [])]
        in_split.append(sum(int(f.numel()) for f in flat))
        parts.extend(flat)
    out_split = [sum(_nbytes(*spec) for spec in recvs.get(peer, [])) for peer in range(world)]
    inp = torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8, device=cdev)
    out = torch.empty(sum(out_split), dtype=torch.uint8, device=cdev)
    dist.all_to_all_single(out, inp, out_split, in_split)
    got, off = {}, 0
    for peer in range(world):
        got[peer] = []
        for shape, dtype in recvs.get(peer, []):
            n = _nbytes(shape, dtype)
            got[peer].append(_from_bytes(out[off:off + n], shape, dtype).to(device))
            off += n
    return got


#: the block dtypes a gather may have to name to a rank that owns no block
_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128, torch.int64,
           torch.bfloat16, torch.float16, torch.int32)
_MAX_NDIM = 4


def gather_blocks(blocks: np.ndarray) -> np.ndarray:
    """Every block of an object array of equal-shaped blocks on every rank:
    an object array of the same shape whose entries are all tensors (this
    rank's own as they are, the others' on the host or the comm device).
    One ``all_gather`` of bytes that every rank of the group joins; each
    rank's blocks travel in mesh order, padded to the largest rank's count,
    so uneven ownership works.  Where some rank owns no block, an
    all-gather of the blocks' shape and dtype comes first (the owner map,
    the same on every rank, says so)."""
    me, world = process_index(), process_count()
    if world == 1:
        return blocks
    dist = _dist()
    flat = list(blocks.flat)
    mine = [b for b in flat if not isinstance(b, Remote)]
    owners = [b.rank if isinstance(b, Remote) else me for b in flat]
    counts = [owners.count(r) for r in range(world)]
    if all(counts):
        shape, dtype = tuple(mine[0].shape), mine[0].dtype
    else:
        meta = [0] * (3 + _MAX_NDIM)
        if mine:
            b = mine[0]
            meta = [1, _DTYPES.index(b.dtype), b.dim(), *b.shape] + [0] * (_MAX_NDIM - b.dim())
        row = next(r for r in all_gather_ints(meta) if r[0])
        shape, dtype = tuple(row[3:3 + row[2]]), _DTYPES[row[1]]
    nbytes = _nbytes(shape, dtype)
    buf = torch.zeros(max(counts) * nbytes, dtype=torch.uint8, device=_comm_device())
    if mine:
        buf[:len(mine) * nbytes] = torch.cat([_bytes(b) for b in mine])
    outs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(outs, buf)
    out = np.empty(blocks.shape, dtype=object)
    taken = [0] * world
    for i, r in enumerate(owners):
        if r == me:
            out.flat[i] = flat[i]
            continue
        k = taken[r]
        taken[r] += 1
        out.flat[i] = _from_bytes(outs[r][k * nbytes:(k + 1) * nbytes], shape, dtype)
    return out


def all_gather_ints(values) -> list:
    """Every rank's list of ints (each rank the same length)."""
    if process_count() == 1:
        return [list(values)]
    t = torch.as_tensor(list(values), dtype=torch.int64, device=_comm_device())
    outs = [torch.empty_like(t) for _ in range(process_count())]
    _dist().all_gather(outs, t)
    return [o.cpu().tolist() for o in outs]


def global_devices(local: list) -> list:
    """The global device list: every rank's local devices in rank order,
    this rank's ``local`` as they are and the others' as
    :class:`RemoteDevice` (an all-gather of the counts and device types),
    the order of ``jax.devices()`` that the JAX package's meshes reshape."""
    if process_count() == 1:
        return list(local)
    me = process_index()
    on_card = int(any(torch.device(d).type == "cuda" for d in local))
    rows = all_gather_ints([len(local), on_card])
    out = []
    for r, (n, cuda) in enumerate(rows):
        out.extend(local if r == me else
                   [RemoteDevice(r, i, "cuda" if cuda else "cpu") for i in range(n)])
    return out


# -- the JAX helpers ----------------------------------------------------------------

def host_block_slice(n_rows: int, axis_size: int | None = None,
                     index: int | None = None) -> slice:
    """Row slice of the global init state this process should materialize:
    process p owns rows [p*B, min((p+1)*B, n)), B = ceil(n/P); one process
    takes the whole grid."""
    np_ = axis_size if axis_size is not None else process_count()
    p = index if index is not None else process_index()
    B = -(-n_rows // np_)
    return slice(p * B, min((p + 1) * B, n_rows))


def put_global(array, mesh, dtype: torch.dtype) -> np.ndarray:
    """Scatter a global array (NumPy or a tensor, the same on every rank:
    the init contract, :func:`assert_same_on_all_hosts`) over ``mesh``: an
    object array of the mesh's shape holding this rank's blocks, each a
    contiguous ``dtype`` tensor on its device, and :class:`Remote` where
    another rank owns the position."""
    x = torch.as_tensor(array)
    devs = mesh.devices
    blk = tuple(int(n) // int(m) for n, m in zip(x.shape, devs.shape, strict=True))
    blocks = np.empty(devs.shape, dtype=object)
    for pos in np.ndindex(*devs.shape):
        d = devs[pos]
        if isinstance(d, RemoteDevice):
            blocks[pos] = Remote(d.rank)
            continue
        sl = tuple(slice(p * b, (p + 1) * b) for p, b in zip(pos, blk, strict=True))
        blocks[pos] = x[sl].to(device=d, dtype=dtype).contiguous()
    return blocks


def fetch_global(blocks: np.ndarray) -> np.ndarray:
    """The blocks as one host NumPy array of their dtype, on every rank (the
    all-gather of :func:`gather_blocks` when other ranks own blocks)."""
    blocks = gather_blocks(blocks)

    def nest(prefix):
        if len(prefix) == blocks.ndim:
            return blocks[prefix].cpu().numpy()
        return [nest(prefix + (i,)) for i in range(blocks.shape[len(prefix)])]

    return np.block(nest(()))


def assert_same_on_all_hosts(x, tag: str = "value") -> None:
    """Cross-rank determinism check: every rank must hold identical ``x``.
    A no-op in one process; otherwise each rank contributes a fixed-size
    blake2b digest of ``(dtype.str, shape, bytes)`` as uint8, the digests
    are all-gathered and every row must match (a digest, not the values, so
    that divergent shapes raise instead of hanging the collective)."""
    if process_count() == 1:
        return
    x = np.asarray(x)
    h = hashlib.blake2b(digest_size=32)
    h.update(str((x.dtype.str, x.shape)).encode())
    h.update(np.ascontiguousarray(x).tobytes())
    digest = np.frombuffer(h.digest(), dtype=np.uint8)
    rows = all_gather_ints(digest.tolist())
    if not all(np.array_equal(np.asarray(r), digest) for r in rows):
        raise AssertionError(
            f"{tag} differs between hosts (process {process_index()}): "
            "multi-controller programs must compute identical host values")
