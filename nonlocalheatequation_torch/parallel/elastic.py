"""Elastic tile executor: arbitrary tile->device placement and migration —
counterpart of ``nonlocalheatequation_tpu/parallel/elastic.py``.

The uniform distributed solver (parallel/distributed2d.py) shards the grid
into one block per mesh position.  The reference, however, can place ANY
number of tiles on each locality (partition-map files, METIS output,
deliberately imbalanced load-balance fixtures) and re-place them at runtime
(load_balance, src/2d_nonlocal_distributed.cpp:844-959).  This module is
that capability in the port:

* a tile is a tensor on its owner's device; ``assignment[gx, gy]`` indexes
  ``devices`` (the reference's partition_space_client placement, :309-335);
  a device list may name one card several times (virtual devices, as
  parallel/mesh.py's meshes do),
* the halo "RPC" (get_data_action, :265-282) is a band copied onto the
  owner's device,
* neighborhoods generalize beyond 3x3 when eps exceeds the tile edge (the
  reference's general rectangle walk, :982-992 + :1202-1212),
* migration is ``.to(device)`` of the tile state to its new owner, driven by
  parallel/load_balance.py every ``nbalance`` steps.

Every tile's neighbour sum is ``op.apply_padded`` on its halo-padded frame
(with ``method="cuda"`` one ``nsum2d`` launch per tile), and every path ends
in one epilogue, :func:`euler_update`, so the numerics are IDENTICAL whatever
the placement, the schedule or the migration history — migrations move bits,
never recompute them.  Two step forms:

* the gang stretches (parallel/gang.py): every step outside a measured
  window runs from per-device slot stacks, each tile's frame assembled from
  its neighbours' bands (eps <= tile edge) or cut from the gathered global
  grid (eps > tile edge, while the grid and the frames fit the footprint
  gate of :meth:`ElasticSolver2D.do_work`);
* the per-tile rectangle walk (:meth:`ElasticSolver2D._assemble_padded`):
  the measured windows, where only the ``measure_window`` steps feeding the
  next rebalance run device group after device group, each between device
  synchronizations, timed by the injectable ``_measure_clock``; and the
  steps of an eps > tile grid beyond the gate.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nonlocalheatequation_torch.models.metrics import ManufacturedMetrics2D
from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, source_at
from nonlocalheatequation_torch.parallel.load_balance import (
    BUSY_SCALE,
    MeasuredTelemetry,
    publish_busy_rates,
    rebalance_assignment,
)
from nonlocalheatequation_torch.parallel.mesh import device_list
from nonlocalheatequation_torch.utils.checkpoint import CheckpointMixin
from nonlocalheatequation_torch.utils.devices import resolve_dtype
from nonlocalheatequation_torch.utils.partition_map import default_assignment

#: Fleet scale watermarks (fractions of BUSY_SCALE): a replica router adds a
#: worker when EVERY replica's absolute busy rate sits above the high mark
#: and drains one when every replica sits below the low mark.  The wide gap
#: between them is the hysteresis band — the fleet analog of work_realloc's
#: 0.3 dead-band (parallel/load_balance.py DEADBAND).
SCALE_HIGH_FRAC = 0.85
SCALE_LOW_FRAC = 0.20


class BusyRatePolicy:
    """The measurement-window bookkeeping of ``ElasticSolver2D._rebalance``,
    factored out so that a replica router can run the same discipline one
    layer up: read the window's busy rates from an injectable telemetry,
    remember the last NON-EMPTY window (after the post-decision telemetry
    reset, reports would otherwise be vacuously zero — and an acceptance
    check vacuously green), hand the rates to a decision, reset the window.
    The telemetry only needs ``busy_rates(assignment)`` (and optionally
    ``record``/``reset``)."""

    def __init__(self, telemetry):
        self.telemetry = telemetry
        self.last_rates: np.ndarray | None = None

    def window_rates(self, assignment=None) -> np.ndarray:
        """This window's rates; a non-empty window is remembered."""
        busy = np.asarray(self.telemetry.busy_rates(assignment))
        if busy.any():
            self.last_rates = np.asarray(busy, dtype=np.float64)
        return busy

    def rates_or_last(self, assignment=None) -> np.ndarray:
        """Current-window rates, falling back to the last completed
        window's snapshot when the current window is empty (e.g. right
        after a decision's telemetry reset)."""
        cur = np.asarray(self.telemetry.busy_rates(assignment))
        if cur.any() or self.last_rates is None:
            return cur
        return self.last_rates

    def reset(self) -> None:
        """Open a new measurement window (the reference re-reads its
        idle-rate counters after rebalancing, :954-956)."""
        if hasattr(self.telemetry, "reset"):
            self.telemetry.reset()


class FleetTelemetry:
    """MeasuredTelemetry's fleet-level sibling: per-replica ABSOLUTE busy
    fractions (busy = 10000 - idle over the window, the HPX idle-rate
    semantics), which each replica worker reports as (busy_s, span_s)."""

    def __init__(self):
        self._rates: dict[int, float] = {}

    def record_window(self, replica: int, busy_s: float, span_s: float) -> None:
        frac = min(1.0, busy_s / span_s) if span_s > 0 else 0.0
        self._rates[int(replica)] = BUSY_SCALE * frac

    def forget(self, replica: int) -> None:
        self._rates.pop(int(replica), None)

    def rate(self, replica: int) -> float:
        return float(self._rates.get(int(replica), 0.0))

    def busy_rates(self, assignment=None) -> np.ndarray:
        return np.asarray([self._rates[r] for r in sorted(self._rates)], dtype=np.float64)

    def reset(self) -> None:
        self._rates.clear()


def fleet_scale_decision(busy, n_replicas: int, *, n_min: int = 1,
                         n_max: int | None = None,
                         low_frac: float = SCALE_LOW_FRAC,
                         high_frac: float = SCALE_HIGH_FRAC) -> str | None:
    """The elastic add/drain decision over one window's absolute busy rates
    (0..BUSY_SCALE units): ``"add"`` when every replica is above the high
    watermark and headroom exists, ``"drain"`` when every replica is below
    the low watermark and the fleet is above its floor, else None (the
    hysteresis band).  min/max aggregation, not the mean: one idle replica
    disproves saturation, one busy replica disproves idleness."""
    busy = np.asarray(busy, dtype=np.float64)
    if busy.size == 0:
        return None
    if (n_max is None or n_replicas < n_max) and busy.min() >= high_frac * BUSY_SCALE:
        return "add"
    if n_replicas > n_min and busy.max() <= low_frac * BUSY_SCALE:
        return "drain"
    return None


def euler_update(center, du, t, dt, g=None, lg=None):
    """The one Euler epilogue of every step path: ``center + dt*(du + b_t)``,
    the source ``b_t`` only in the test form.  The same torch operations in
    the same order wherever it runs, so the paths stay bitwise equal."""
    if g is not None:
        du = du + source_at(g, lg, t, dt)
    return center + dt * du


def synchronize(devices) -> None:
    """Wait for every queued operation on the CUDA devices among ``devices``
    (no-op on the CPU)."""
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def place_blocks(items, nx: int, ny: int, NX: int, NY: int) -> np.ndarray:
    """The float64 global grid from ((gx, gy), tile) pairs (tensors or NumPy)."""
    out = np.zeros((NX, NY), dtype=np.float64)
    for (gx, gy), tile in items:
        if isinstance(tile, torch.Tensor):
            tile = tile.cpu().numpy()
        out[gx * nx:(gx + 1) * nx, gy * ny:(gy + 1) * ny] = tile
    return out


class ElasticSolver2D(CheckpointMixin, ManufacturedMetrics2D):
    """2D solver over npx x npy tiles of nx x ny with per-tile placement.

    ``assignment`` is an (npx, npy) array of indices into ``devices`` (a
    partition-map file's locality column); defaults to the reference's block
    map (locidx, src/2d_nonlocal_distributed.cpp:105-110).  ``devices``
    defaults to every CUDA card (parallel/mesh.device_list, which raises
    without one); pass ``device_list("cpu", n)`` for n virtual CPU devices
    or ``device_list("cuda", n)`` for n virtual devices of one card.
    """

    def __init__(self, nx: int, ny: int, npx: int, npy: int, nt: int, eps: int,
                 nlog: int = 5, nbalance: int | None = None, k: float = 1.0,
                 dt: float = 0.0005, dh: float = 0.02, assignment: np.ndarray | None = None,
                 devices=None, method: str = "auto", telemetry=None, logger=None, dtype=None,
                 checkpoint_path: str | None = None, ncheckpoint: int = 0,
                 measure_window: int | None = None, superstep: int = 1,
                 precision: str = "f32"):
        self.nx, self.ny, self.npx, self.npy = int(nx), int(ny), int(npx), int(npy)
        self.NX, self.NY = self.nx * self.npx, self.ny * self.npy
        self.nt, self.eps, self.nlog = int(nt), int(eps), int(nlog)
        self.nbalance = int(nbalance) if nbalance else None
        self.op = NonlocalOp2D(eps, k, dt, dh, method=method, precision=precision)
        self.devices = list(devices if devices is not None else device_list())
        nl = len(self.devices)
        if assignment is None:
            assignment = default_assignment(self.npx, self.npy, nl)
        self.assignment = np.asarray(assignment, dtype=np.int64)
        if self.assignment.min() < 0 or self.assignment.max() >= nl:
            raise ValueError(
                f"assignment owner ids span [{self.assignment.min()}, "
                f"{self.assignment.max()}] but only {nl} devices are "
                "available; re-run the decomposition for this device count")
        # measured wall-clock by default (the reference reads real idle-rate
        # counters); WorkTelemetry stays injectable for deterministic tests
        self.telemetry = telemetry or MeasuredTelemetry(nl)
        self._policy = BusyRatePolicy(self.telemetry)
        # the measurement clock is injectable: busy-rate tests swap in a
        # virtual clock advanced by the tile hook, so their assertions never
        # race host load; production measures real wall-clock
        self._measure_clock = time.perf_counter
        # measurement serializes device groups: only when rates are consumed
        # (rebalancing, or a caller that sets it, as --test_load_balance does)
        self.measure = bool(self.nbalance)
        # with nbalance, only the measure_window steps feeding the next
        # rebalance are measured; None -> min(5, nbalance)
        if measure_window is None:
            measure_window = min(5, self.nbalance) if self.nbalance else 0
        self.measure_window = int(measure_window)
        self.logger = logger
        self.dtype = resolve_dtype(dtype, self.devices[0])
        self.checkpoint_path = checkpoint_path
        self.ncheckpoint = int(ncheckpoint)
        self.t0 = 0
        self.test = False
        self.u0 = np.zeros((self.NX, self.NY), dtype=np.float64)
        self.u = None
        self.error_l2 = 0.0
        self.error_linf = 0.0
        self._tiles: dict[tuple[int, int], torch.Tensor] = {}
        self._gtiles: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
        # the gang's band assembly (3x3 neighborhoods, eps <= tile edge); the
        # general gang and the rectangle walk serve eps > tile
        self._use_fused = self.eps <= self.nx and self.eps <= self.ny
        # superstep K > 1: gang stretches exchange ONE K*eps-wide halo per K
        # steps; measured windows and remainders keep the per-step paths.
        # Refused where the schedule cannot engage, never silently per-step
        self.ksteps = max(1, int(superstep))
        if self.ksteps > 1 and self.ksteps * self.eps > min(self.nx, self.ny):
            raise ValueError(
                f"superstep {self.ksteps} needs ksteps*eps <= tile edge "
                f"({self.ksteps}*{self.eps} > {min(self.nx, self.ny)}): "
                "the gang band assembly draws the whole halo from the 8 "
                "immediate neighbors")
        # gang scheduling: window-free stretches run as one loop over every
        # device's slot stack (parallel/gang.py), bitwise the rectangle walk
        self._gang = None
        self._gang_active = False

    # -- initialization -------------------------------------------------------------
    def test_init(self):
        self.test = True
        self.u0 = self.op.spatial_profile(self.NX, self.NY).copy()

    def input_init(self, values):
        self.test = False
        self.u0 = np.asarray(values, dtype=np.float64).reshape(self.NX, self.NY)

    # checkpoint/resume: CheckpointMixin (the single-device solvers'
    # parameters, so files move between the serial, distributed and elastic
    # solvers of either package on the same global grid); the saved state
    # is the float64 gather, as the JAX executor saves it

    @property
    def _grid_shape(self):
        return (self.NX, self.NY)

    def _device_of(self, gx: int, gy: int) -> torch.device:
        return self.devices[int(self.assignment[gx, gy])]

    def _tile_slice(self, gx: int, gy: int):
        return (slice(gx * self.nx, (gx + 1) * self.nx), slice(gy * self.ny, (gy + 1) * self.ny))

    def _place_tiles(self):
        g = lg = None
        if self.test:
            # (G, L(G)) in float64 by the operator's own method on the first
            # device, as the distributed solvers build theirs
            g, lg = self.op.source_parts_on(self.NX, self.NY, self.devices[0])
        self._tiles, self._gtiles = {}, {}
        for gx in range(self.npx):
            for gy in range(self.npy):
                sl = self._tile_slice(gx, gy)
                dev = self._device_of(gx, gy)
                self._tiles[gx, gy] = torch.tensor(self.u0[sl], dtype=self.dtype, device=dev)
                if self.test:
                    self._gtiles[gx, gy] = tuple(
                        a[sl].to(device=dev, dtype=self.dtype).contiguous() for a in (g, lg))

    # -- the per-tile step (general eps > tile path) ---------------------------------
    def _assemble_padded(self, gx: int, gy: int) -> torch.Tensor:
        """The (nx+2e, ny+2e) halo-padded frame of tile (gx, gy).

        Walks every tile intersecting the eps-expanded rectangle — the
        reference's add_neighbour_rectangle generalized (:982-992); regions
        outside the grid stay zero (volumetric boundary condition).  Bands
        are sliced on their owner's device and copied onto this tile's
        owner: the halo exchange.
        """
        nx, ny, e = self.nx, self.ny, self.eps
        x0, y0 = gx * nx - e, gy * ny - e  # global coords of upad[0, 0]
        upad = torch.zeros((nx + 2 * e, ny + 2 * e), dtype=self.dtype,
                           device=self._device_of(gx, gy))
        tx_lo, tx_hi = max(0, x0 // nx), min(self.npx - 1, (x0 + nx + 2 * e - 1) // nx)
        ty_lo, ty_hi = max(0, y0 // ny), min(self.npy - 1, (y0 + ny + 2 * e - 1) // ny)
        for tx in range(tx_lo, tx_hi + 1):
            for ty in range(ty_lo, ty_hi + 1):
                # overlap of tile (tx, ty) with the expanded rectangle
                ox0, ox1 = max(tx * nx, x0), min((tx + 1) * nx, x0 + nx + 2 * e)
                oy0, oy1 = max(ty * ny, y0), min((ty + 1) * ny, y0 + ny + 2 * e)
                if ox0 >= ox1 or oy0 >= oy1:
                    continue
                band = self._tiles[tx, ty][ox0 - tx * nx:ox1 - tx * nx,
                                           oy0 - ty * ny:oy1 - ty * ny]
                upad[ox0 - x0:ox1 - x0, oy0 - y0:oy1 - y0] = band
        return upad

    def _step_tile(self, key, t):
        """One tile's rectangle walk and step (every measured step, and eps >
        tile beyond the general gang's footprint gate)."""
        self._tile_hook(key)
        e = self.eps
        upad = self._assemble_padded(*key)
        du = self.op.apply_padded(upad)
        g, lg = self._gtiles[key] if self.test else (None, None)
        return euler_update(upad[e:e + self.nx, e:e + self.ny], du, t, self.op.dt, g, lg)

    def _tile_hook(self, key) -> None:
        """Test seam: called before each tile's step (e.g. to advance a
        virtual measurement clock for a deliberately slow device)."""

    # -- migration (the load balancer's actuator) ------------------------------------
    def migrate(self, new_assignment: np.ndarray) -> int:
        """Move tiles whose owner changed; returns the number moved.

        The analog of re-constructing partition_space_clients on new
        localities (src/2d_nonlocal_distributed.cpp:939-944): the state moves
        bit for bit, nothing is recomputed.  The gang's slot plan is rebuilt
        from the new assignment at the next stretch, even when the devices
        are virtual devices of one card (the slots follow the assignment, not
        the physical device).
        """
        self._leave_gang()
        new_assignment = np.asarray(new_assignment, dtype=np.int64)
        moved = 0
        for gx in range(self.npx):
            for gy in range(self.npy):
                if new_assignment[gx, gy] == self.assignment[gx, gy]:
                    continue
                dev = self.devices[int(new_assignment[gx, gy])]
                self._tiles[gx, gy] = self._tiles[gx, gy].to(dev)
                if self.test:
                    self._gtiles[gx, gy] = tuple(a.to(dev) for a in self._gtiles[gx, gy])
                moved += 1
        self.assignment = new_assignment
        return moved

    def _rebalance(self) -> int:
        # window_rates remembers a non-empty window, so that reports after
        # the post-rebalance reset describe the last completed window
        busy = self._policy.window_rates(self.assignment)
        with obs_trace.span("balance.rebalance", cat="balance",
                            devices=int(np.asarray(busy).size)):
            new_assignment = rebalance_assignment(self.assignment, busy)
            moved = self.migrate(new_assignment)
        publish_busy_rates(busy, moved=moved)
        return moved

    def _step_all_measured(self, t) -> None:
        """One timestep with per-device busy-time MEASUREMENT.

        The reference samples per-locality idle-rate counters
        (src/2d_nonlocal_distributed.cpp:856-863); the analog here is the
        wall-clock each device's tile group takes: assemble + launch +
        synchronize, one group at a time, each clock started only after a
        synchronization of every device, so nothing queued by an earlier
        group is counted.  Virtual devices of one card share it, so the
        groups' times follow their tile counts.  Measurement steps PER TILE
        (the rectangle walk, bitwise the gang): a device's busy time must
        scale with its tiles.
        """
        new_tiles = {}
        for d in range(len(self.devices)):
            keys = [k for k, owner in np.ndenumerate(self.assignment) if owner == d]
            if not keys:
                continue
            synchronize(self.devices)
            t0 = self._measure_clock()
            for key in keys:
                new_tiles[key] = self._step_tile(key, t)
            synchronize(self.devices)
            self.telemetry.record(d, self._measure_clock() - t0)
        self._tiles = new_tiles

    def _step_all_overlapped(self, t) -> None:
        """One timestep of the rectangle walk, every device's launches queued
        without a fence (eps > tile beyond the general gang's gate)."""
        self._tiles = {key: self._step_tile(key, t) for key in self._tiles}

    def _in_measure_window(self, t: int) -> bool:
        """Is step t inside the sampling window feeding the next rebalance?

        The rebalance at step t (t % nbalance == 0, t > 0) consumes rates
        right after the step executes, so the window is the measure_window
        steps ENDING at that step.  Without nbalance (reporting mode, e.g.
        --test_load_balance alone) every step is measured.
        """
        if not self.nbalance:
            return True
        r = t % self.nbalance
        return (r == 0 and t > 0) or r > self.nbalance - self.measure_window

    # -- gang-scheduled stretches (parallel/gang.py) ---------------------------------
    def _gang_stretch_len(self, t: int, measured: bool) -> int:
        """#steps from t runnable inside ONE gang stretch: stops BEFORE the
        next measured-window step, and AFTER a step that needs the host
        (logging, checkpoint, rebalance)."""
        n, step = 0, t
        while step < self.nt:
            if measured and self._in_measure_window(step):
                break
            n += 1
            io = ((self.logger is not None and step % self.nlog == 0)
                  or self._ckpt_due(step)
                  or self._rebalance_due(step))
            step += 1
            if io:
                break
        return n

    def _rebalance_due(self, t: int) -> bool:
        """Rebalance fires after step t (the reference's do_work cadence,
        src/2d_nonlocal_distributed.cpp:1306-1309; final step skipped)."""
        return bool(self.nbalance and t % self.nbalance == 0 and t > 0
                    and t != self.nt - 1 and len(self.devices) > 1)

    def _enter_gang(self):
        if self._gang_active:
            return
        if self._gang is None:
            from nonlocalheatequation_torch.parallel.gang import GangExecutor

            self._gang = GangExecutor(self)
        self._gang.rebuild(self._tiles, self._gtiles if self.test else None)
        self._gang_active = True

    def _leave_gang(self):
        if not self._gang_active:
            return
        self._tiles = self._gang.tiles()
        self._gang_active = False

    # -- time loop ----------------------------------------------------------------------
    def _check_superstep(self, measured: bool) -> None:
        """Refuse a superstep that could never engage (never silently per-step;
        ksteps*eps <= tile edge, checked at construction, keeps it on the
        gang's band assembly)."""
        if self.ksteps == 1:
            return
        if measured and not self.nbalance:
            raise RuntimeError(
                "superstep > 1 cannot engage when every step is a "
                "measured window (measure=True without nbalance); add a "
                "rebalance cadence or drop superstep")
        if measured and self.nbalance - self.measure_window < self.ksteps:
            raise RuntimeError(
                f"superstep {self.ksteps} cannot engage: only "
                f"{self.nbalance - self.measure_window} window-free "
                "steps exist between measured windows (nbalance - "
                "measure_window); widen nbalance, shrink measure_window, "
                "or drop superstep")

    def do_work(self) -> np.ndarray:
        self._place_tiles()
        measured = self.measure and hasattr(self.telemetry, "record")
        window_len = self.measure_window if self.nbalance else self.nt
        prev_in_window = False
        self._gang_active = False
        # the general gang form materializes the global grid and every
        # tile's padded window per device: gated on both footprints
        window_elems = self.npx * self.npy * (self.nx + 2 * self.eps) * (self.ny + 2 * self.eps)
        use_gang = self._use_fused or (
            self.NX * self.NY <= (1 << 24) and window_elems <= (1 << 25))
        self._check_superstep(measured)
        t = self.t0
        while t < self.nt:
            n = self._gang_stretch_len(t, measured) if use_gang else 0
            if n > 0:
                # window-free stretch: one gang run over every device
                self._enter_gang()
                self._gang.run_stretch(t, n)
                last = t + n - 1
                t += n
                prev_in_window = False
                if self._rebalance_due(last):
                    # model-telemetry mode (no measured windows): migrate
                    # leaves the gang, whose plan the next stretch rebuilds
                    self._rebalance()
                    self._policy.reset()
                if self.logger is not None and last % self.nlog == 0:
                    self.logger(last, self.gather())
                if self._ckpt_due(last):
                    self._maybe_checkpoint(last, self.gather())
                continue
            self._leave_gang()
            in_window = measured and self._in_measure_window(t)
            if in_window:
                self._step_all_measured(t)
                if not prev_in_window and window_len > 1:
                    # a window's first step pays warm-up inside its timed
                    # groups: discard it, unless it is the window's only step
                    self._policy.reset()
            else:
                self._step_all_overlapped(t)
            prev_in_window = in_window
            if self._rebalance_due(t):
                # (not on the final step: its migration would serve no step
                # and its reset would erase the rates of the reported placement)
                self._rebalance()
                # a new window, like the reference's counter re-read (:954-956)
                self._policy.reset()
            if t % self.nlog == 0 and self.logger is not None:
                self.logger(t, self.gather())
            if self._ckpt_due(t):
                self._maybe_checkpoint(t, self.gather())
            t += 1
        self._leave_gang()
        self.u = self.gather()
        if self.test:
            self.compute_l2(self.nt)
            self.compute_linf(self.nt)
        return self.u

    def gather(self) -> np.ndarray:
        """The global state as a float64 NumPy grid (one host copy per
        device slot stack in a gang stretch)."""
        place = lambda items: place_blocks(items, self.nx, self.ny, self.NX, self.NY)  # noqa: E731
        if self._gang_active:
            return place(self._gang.plan.unpack(self._gang.host_state()).items())
        return place(self._tiles.items())

    def busy_rates(self) -> np.ndarray:
        """Current-window measured rates, or the last completed window's
        when the current one is empty (right after the final rebalance's
        reset) — BusyRatePolicy's discipline."""
        return self._policy.rates_or_last(self.assignment)

    #: print_error prefixes coordinates (2d_nonlocal_distributed.cpp:538-541)
    _cmp_coordinate_prefix = True
