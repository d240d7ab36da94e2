"""Distributed 2D solver over a mesh of blocks — counterpart of
``nonlocalheatequation_tpu/parallel/distributed2d.py`` (itself the
reference's flagship distributed solver, src/2d_nonlocal_distributed.cpp:
360-1325, re-designed for SPMD).

The global (nx*npx) x (ny*npy) grid is split into one equal block per mesh
position (parallel/mesh.py); each step exchanges the eps-wide halos
(parallel/halo.py) and advances every block, so the global numerics are the
single-device solve's.  ``comm=`` selects how a step computes a block:

* ``"collective"``: ``op.apply_padded`` on the block's exchanged frame (with
  ``method="cuda"`` the ``nsum2d`` kernel);
* ``"fused"``: the halo kernels of ops/cuda_halo.py, bitwise the
  collective path; it needs ``method="cuda"``.  On CUDA cards that read
  each other's memory (one card always can) there is no exchange outside
  the kernel: one ``fused_nsum2d`` launch per block reads its halo from
  the blocks around it.  Elsewhere (and on the CPU) the bands are copied
  first and the split kernel sums the frame, interior then ring.

``superstep=K > 1`` (collective only) exchanges a K*eps-wide halo once per
K steps and advances K levels locally, each level's valid region shrinking
by eps per side, with the cells outside the global domain re-zeroed at every
intermediate level (the volumetric boundary condition the per-step exchange
re-injects).  A run of ``count`` steps is q supersteps of K and one
shallower remainder superstep.

Each rank steps the blocks it owns in turn (parallel/mesh.py; in one
process every block, the JAX package's single-controller ``shard_map``),
bands crossing ranks by ``torch.distributed`` (parallel/halo.py).  A
logger or checkpoints run one runner per segment between the barriers
(utils/checkpoint.CheckpointMixin._run_chunked), the logger and the
checkpoint given the GLOBAL state (``fetch_global``, gathered to every
rank; rank 0 writes); the checkpoint's parameters are the single-device
solvers' (the JAX ``_ckpt_params``: no stepper, no stage count), so a
distributed checkpoint resumes in ``Solver2D``/``Solver3D`` and the
reverse, whatever the stepper.
``nbalance`` is refused as the JAX solver refuses it: rebalancing is the
elastic executor's (parallel/elastic.py).

The stepper axis: ``stepper="rkc"`` runs the Verwer stage loop above the
exchange (parallel/stepper_halo.py): each stage one apply of every block
through the transport above (per-stage, bitwise the single-device rkc
solve), or with ``superstep=K > 1`` stage batches of K, one exchange round a
batch.  ``method="fft"`` is the sharded spectral tier (parallel/
spectral_halo.py over ops/spectral_sharded.py): Euler, rkc and ``expo`` on
the pencil-decomposed global transform, its frequency tables placed on the
mesh once per solver; it refuses ``comm='fused'`` and ``superstep > 1``.
``expo`` needs ``method="fft"``.  :class:`DistributedGridSolver` holds what
the 2D and 3D solvers share.
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.models.metrics import ManufacturedMetrics2D
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.metrics import REGISTRY
from nonlocalheatequation_torch.ops.cuda_halo import (
    fused_transport,
    halo_stats,
    make_fused_apply,
    require_fused,
)
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, source_at
from nonlocalheatequation_torch.ops.spectral_sharded import get_plan, require_sharded_fft
from nonlocalheatequation_torch.parallel.halo import halo_pad_nd
from nonlocalheatequation_torch.parallel.mesh import (
    Mesh,
    block_shape,
    device_list,
    fetch_global,
    local_positions,
    make_mesh,
    map_blocks,
    put_global,
)
from nonlocalheatequation_torch.parallel.spectral_halo import (
    build_spectral_local_step,
    spectral_halo_obs,
    spectral_tables,
)
from nonlocalheatequation_torch.parallel.stepper_halo import (
    make_rkc_perstage_step,
    make_rkc_stagebatch_step,
    validate_dist_stepper,
)
from nonlocalheatequation_torch.utils.checkpoint import CheckpointMixin
from nonlocalheatequation_torch.utils.devices import resolve_dtype


def choose_mesh_shape(NX: int, NY: int, ndevices: int) -> tuple[int, int]:
    """Largest (mx, my) with mx | NX, my | NY and mx*my <= ndevices."""
    n = int(ndevices)
    best = (1, 1)
    for mx in range(1, min(NX, n) + 1):
        if NX % mx:
            continue
        for my in range(1, min(NY, n // mx) + 1):
            if NY % my == 0 and mx * my > best[0] * best[1]:
                best = (mx, my)
    return best


def choose_mesh_for_grid(NX: int, NY: int, devices=None) -> Mesh:
    """Largest mesh (mx, my) with mx | NX, my | NY and mx*my <= #devices
    (default :func:`device_list`, the CUDA cards)."""
    devices = list(devices if devices is not None else device_list())
    mx, my = choose_mesh_shape(NX, NY, len(devices))
    return make_mesh(mx, my, devices)


class DistributedGridSolver(CheckpointMixin, ManufacturedMetrics2D):
    """The set-up, step programs and time loop the 2D and 3D distributed
    solvers share; a subclass sets ``AXES``, ``_grid_shape`` and the
    operator."""

    AXES: tuple = ()
    #: print_error prefixes coordinates (2d_nonlocal_distributed.cpp:538-541)
    _cmp_coordinate_prefix = True

    def _setup(self, op, mesh, device, dtype, superstep: int, comm: str, choose_mesh,
               logger, checkpoint_path, ncheckpoint: int, stepper: str = "euler",
               stages: int = 0):
        self.logger = logger
        self.checkpoint_path = checkpoint_path
        self.ncheckpoint = int(ncheckpoint)
        self.ksteps = max(1, int(superstep))
        self.op = op
        # the stepper tier: rkc's stage loop above the exchange
        # (parallel/stepper_halo.py); expo only on the sharded spectral tier
        self.stepper, self.stages = validate_dist_stepper(op, stepper, stages)
        self.mesh = mesh if mesh is not None else choose_mesh(*self._grid_shape,
                                                              device_list(device))
        if self.mesh.axis_names != self.AXES:
            raise ValueError(f"the mesh's axes {self.mesh.axis_names} are not {self.AXES}")
        self.dtype = resolve_dtype(dtype, self.mesh.devices.flat[0])
        if comm not in ("collective", "fused"):
            raise ValueError(f"comm must be 'collective' or 'fused', got {comm!r}")
        self.comm = comm
        if op.method == "fft":
            # the sharded spectral tier's refusals, up front (the JAX words)
            if comm == "fused":
                raise ValueError(
                    "method='fft' runs on the collective all-to-all "
                    "pencil transposes (ops/spectral_sharded.py); "
                    "comm='fused' is a stencil-halo transport — run "
                    "comm='collective'")
            if self.ksteps > 1:
                raise ValueError(
                    "method='fft' has no superstep form (the transform "
                    "is global every step, there is no halo to "
                    "amortize); run superstep=1 — rkc stages or "
                    "stepper='expo' carry the big-dt claim on the "
                    "spectral tier")
            require_sharded_fft(self._grid_shape, self.eps, self._mesh_shape())
        if comm == "fused":
            # refused at construction, never downgraded to the collective path
            require_fused(self.op, self._block_shape(), self.dtype, ksteps=self.ksteps)
        self._step_cache: dict = {}
        self._spectral_tabs = None  # the frequency tables on the mesh, placed once
        self.t0 = 0
        self.test = False
        self.u0 = np.zeros(self._grid_shape, dtype=np.float64)
        self.u = None
        self.error_l2 = 0.0
        self.error_linf = 0.0

    def _mesh_shape(self) -> tuple:
        return tuple(self.mesh.shape[n] for n in self.AXES)

    def _block_shape(self) -> tuple:
        """Per-device block of the uniform sharding."""
        return block_shape(self.mesh, self._grid_shape)

    # -- initialization (2d_nonlocal_distributed.cpp:178-190) -----------------
    def test_init(self):
        self.test = True
        self.u0 = self.op.spatial_profile(*self._grid_shape).copy()

    def input_init(self, values):
        self.test = False
        self.u0 = np.asarray(values, dtype=np.float64).reshape(self._grid_shape)

    # -- the step programs ------------------------------------------------------
    def _build_step(self, ksteps: int = 1):
        """``step(blocks, t, srcs) -> blocks``, one (super)step of every
        block.  ``ksteps`` > 1 is the communication-avoiding superstep of K
        levels; with ``superstep`` > 1 the shallower remainder runs the same
        program at its depth, its sources sliced from the same
        (superstep-1)*eps-padded blocks (:meth:`_prep_sources`).  An rkc step
        advances one dt (``superstep`` batches its stages); ``method='fft'``
        steps through the sharded spectral tier, its tables leading ``srcs``."""
        op, eps = self.op, self.eps
        K = max(1, int(ksteps))
        test = self.test

        if op.method == "fft":
            local = build_spectral_local_step(op, self._spectral_plan(), self.stepper,
                                              self.stages, test)
            return lambda blocks, t, srcs: local(blocks, *srcs, t)

        apply = None
        if self.ksteps == 1:
            # one transport serves per-step Euler and per-stage rkc
            if self.comm == "fused":
                apply = make_fused_apply(op, self._mesh_shape(), self.AXES)
            else:
                def apply(blocks):
                    return map_blocks(op.apply_padded, halo_pad_nd(blocks, eps))

        if self.stepper == "rkc":
            if self.ksteps == 1:
                local = make_rkc_perstage_step(op, self.stages, apply, test)
            else:
                local = make_rkc_stagebatch_step(op, self.stages, self.ksteps, halo_pad_nd,
                                                 self._grid_shape, test,
                                                 (self.ksteps - 1) * eps)
            return lambda blocks, t, srcs: local(blocks, *srcs, t)

        if self.ksteps == 1:
            def step(blocks, t, srcs):
                du = apply(blocks)
                if test:
                    du = map_blocks(lambda d, g, lg: d + source_at(g, lg, t, op.dt), du, *srcs)
                return map_blocks(lambda u, d: u + op.dt * d, blocks, du)

            return step

        def step(blocks, t, srcs):
            frames = halo_pad_nd(blocks, K * eps)
            out = frames.copy()  # other ranks' positions keep their placeholders
            for pos in local_positions(frames):
                gp, lgp = (srcs[0][pos], srcs[1][pos]) if test else (None, None)
                out[pos] = self._superstep_block(frames[pos], pos, K, t, gp, lgp)
            return out

        return step

    # -- the sharded spectral tier ------------------------------------------------
    def _spectral_plan(self):
        """The cached pencil-FFT schedule of this (grid, mesh) pair."""
        return get_plan(self._grid_shape, self.eps, self._mesh_shape(), self.AXES)

    def _spectral_args(self) -> tuple:
        """The frequency tables on the mesh (each position's slice in the
        state's real dtype), placed once per solver."""
        if self._spectral_tabs is None:
            plan = self._spectral_plan()
            self._spectral_tabs = tuple(
                plan.put_freq(t, self.mesh.devices, self.dtype)
                for t in spectral_tables(self.op, plan, self.stepper, self.stages))
        return self._spectral_tabs

    def _superstep_block(self, Pk, pos, K: int, t: int, gp=None, lgp=None):
        """K Euler levels of one block from its K*eps-wide frame ``Pk``;
        gp/lgp are its sources padded with the (superstep-1)*eps ring."""
        op, eps = self.op, self.eps
        blk = self._block_shape()
        origin = [p * b for p, b in zip(pos, blk, strict=True)]
        src_halo = (self.ksteps - 1) * eps
        for j in range(1, K + 1):
            m = (K - j) * eps  # margin beyond the block at this level
            ext = [b + 2 * m for b in blk]
            du = op.apply_padded(Pk)
            if gp is not None:
                o = src_halo - m
                sl = tuple(slice(o, o + e) for e in ext)
                du = du + source_at(gp[sl], lgp[sl], t + (j - 1), op.dt)
            center = Pk[tuple(slice(eps, eps + e) for e in ext)]
            nxt = center + op.dt * du
            if j < K:
                # volumetric boundary condition on intermediates: collar cells
                # outside the global domain stay zero at every time
                ok = torch.ones((), dtype=torch.bool, device=nxt.device)
                for ax, (start, n, e) in enumerate(zip(origin, self._grid_shape, ext,
                                                       strict=True)):
                    c = (start - m) + torch.arange(e, device=nxt.device)
                    shape = [1] * len(ext)
                    shape[ax] = e
                    ok = ok & ((c >= 0) & (c < n)).reshape(shape)
                nxt = torch.where(ok, nxt, torch.zeros_like(nxt))
            Pk = nxt
        return Pk

    def _device_state(self):
        """This rank's blocks of the state and, in test mode, of (G, L(G))
        (L(G) by the operator's own method on the rank's first mesh device,
        in float64, then cast to the state dtype; a rank that owns no block
        holds only placeholders)."""
        u = put_global(self.u0, self.mesh, self.dtype)
        if not self.test:
            return u, ()
        if not self.mesh.local_devices:  # this rank owns no block: nothing to source
            return u, (u, u)
        g, lg = self.op.source_parts_on(*self._grid_shape, self.mesh.local_devices[0])
        return u, (put_global(g, self.mesh, self.dtype), put_global(lg, self.mesh, self.dtype))

    def _prep_sources(self, g, lg):
        """Pad the source blocks with the (superstep-1)*eps ring once per
        run (the fields do not depend on time)."""
        src_halo = (self.ksteps - 1) * self.eps
        return halo_pad_nd(g, src_halo), halo_pad_nd(lg, src_halo)

    def _halo_obs(self, steps: int) -> dict:
        """Publish the run's scheduled halo traffic (/halo/bytes,
        /halo/exchanges in obs.metrics.REGISTRY) and return the
        halo.exchange span's attributes.  Host arithmetic from the exchange
        plan; the stats follow the transport that runs: the in-kernel
        exchange reads the plan's bands, the split kernels' transport
        copies the collective exchange's (fused_transport()); the spectral
        tier's traffic is its plan's all-to-all schedule
        (spectral_halo_obs)."""
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        if self.op.method == "fft":
            return spectral_halo_obs(self._spectral_plan(), self.stepper, self.stages, steps,
                                     itemsize, self.comm)
        mesh_shape = self._mesh_shape()
        transport = (fused_transport(list(self.mesh.devices.flat)) if self.comm == "fused"
                     else "collective")
        stats = halo_stats(mesh_shape, self._block_shape(), self.eps,
                           "fused" if transport == "peer" else "collective", itemsize)
        ndev = int(np.prod(mesh_shape))
        if self.stepper == "rkc":
            # one round per stage batch (ceil(s/K) a step; per stage at K == 1),
            # on the eps-band basis of the Euler superstep's counts
            rounds = steps * -(-self.stages // self.ksteps)
        else:
            rounds = -(-steps // self.ksteps)  # one per (super)step
        REGISTRY.counter("/halo/exchanges").inc(rounds * stats["messages"] * ndev)
        REGISTRY.counter("/halo/bytes").inc(rounds * stats["bytes"] * ndev)
        return dict(comm=self.comm, transport=transport, devices=ndev, rounds=rounds,
                    messages_per_round=stats["messages"] * ndev,
                    bytes_per_device_round=stats["bytes"])

    def _make_runner(self, count: int):
        """``run(blocks, start, srcs)``: ``count`` steps from ``start`` as q
        supersteps of K and one shallower remainder (K == 1: ``count``
        steps).  An rkc step advances one dt, whatever ``superstep``."""
        K = 1 if self.stepper == "rkc" else max(1, min(self.ksteps, count))
        q, r = divmod(count, K)

        def get_step(k):
            key = (k, self.test)
            if key not in self._step_cache:
                self._step_cache[key] = self._build_step(k)
            return self._step_cache[key]

        step_K = get_step(K)
        step_r = get_step(r) if r else None

        def run(blocks, start, srcs):
            for i in range(q):
                blocks = step_K(blocks, start + K * i, srcs)
            if step_r is not None:
                blocks = step_r(blocks, start + q * K, srcs)
            return blocks

        return run

    # -- time loop (2d_nonlocal_distributed.cpp:1271-1325) ----------------------
    def do_work(self) -> np.ndarray:
        blocks, srcs = self._device_state()
        if srcs and self.ksteps > 1:
            srcs = self._prep_sources(*srcs)
        if self.op.method == "fft":
            srcs = self._spectral_args() + srcs  # the tables lead the step's arguments
        checkpointing = bool(self.checkpoint_path and self.ncheckpoint)

        def make_runner(count):
            # the segment runner the mixin calls, one per distinct count
            run = self._make_runner(count)
            return lambda b, start: run(b, start, srcs)

        with obs_trace.span("halo.exchange", cat="halo", **self._halo_obs(self.nt - self.t0)):
            if self.logger is None and not checkpointing:
                blocks = self._make_runner(self.nt - self.t0)(blocks, self.t0, srcs)
            else:
                # one runner per segment; barriers = log and checkpoint steps
                blocks = self._run_chunked(blocks, make_runner)
            self.u = fetch_global(blocks)
        if self.test:
            self.compute_l2(self.nt)
            self.compute_linf(self.nt)
        return self.u


class Solver2DDistributed(DistributedGridSolver):
    """Solve on the (nx*npx) x (ny*npy) global grid, sharded over a mesh.

    nx, ny, npx, npy mirror the reference's CLI (tile size and tile counts);
    the mesh is chosen independently of the tiling (any mesh whose shape
    divides the global grid).  The default mesh spans ``device_list(device)``
    (every CUDA card; ``device="cpu"`` for the CPU); pass ``mesh`` to place
    the blocks (parallel/mesh.py, virtual devices included).
    """

    AXES = ("x", "y")

    def __init__(self, nx: int, ny: int, npx: int, npy: int, nt: int, eps: int,
                 nlog: int = 5, nbalance: int | None = None, k: float = 1.0,
                 dt: float = 0.0005, dh: float = 0.02, mesh: Mesh | None = None,
                 method: str = "auto", logger=None, dtype=None,
                 checkpoint_path: str | None = None, ncheckpoint: int = 0,
                 superstep: int = 1, precision: str = "f32", resync_every: int = 0,
                 comm: str = "collective", stepper: str = "euler", stages: int = 0,
                 device=None):
        self.nx, self.ny, self.npx, self.npy = int(nx), int(ny), int(npx), int(npy)
        self.NX, self.NY = self.nx * self.npx, self.ny * self.npy
        self.nt, self.eps, self.nlog = int(nt), int(eps), int(nlog)
        if nbalance:
            # one equal block per device: no tile-count imbalance to correct;
            # rebalancing lives on the elastic executor (parallel/elastic.py)
            raise ValueError(
                "Solver2DDistributed shards uniformly (one equal block per "
                "device) and cannot rebalance; use "
                "parallel.elastic.ElasticSolver2D for nbalance support"
            )
        if resync_every:
            raise ValueError(
                "resync_every is not supported on the distributed path; run the serial "
                "solver, or precision='bf16' without resync")
        op = NonlocalOp2D(eps, k, dt, dh, method=method, precision=precision)
        self._setup(op, mesh, device, dtype, superstep, comm, choose_mesh_for_grid, logger,
                    checkpoint_path, ncheckpoint, stepper, stages)

    @property
    def _grid_shape(self):
        return (self.NX, self.NY)
