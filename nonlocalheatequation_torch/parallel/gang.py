"""Gang-scheduled elastic execution, the fast path for arbitrary placement —
counterpart of ``nonlocalheatequation_tpu/parallel/gang.py`` (less
``solve_case_sharded``, the router's sharded case class, which is not
ported).

The elastic executor (parallel/elastic.py) runs every step outside a
measurement window here, over whole stretches of steps from fixed slot
arrays, as the JAX package's one SPMD program over a 1D device mesh does:

* the state is one (T_max, nx, ny) slot stack per device of a 1D mesh
  (parallel/mesh.create_mesh, axis ``"d"``) — device d's tiles in slots
  0..T-1, and a device with fewer tiles than T_max carries all-zero pad
  slots,
* the halo "RPC" is one gather of only the eps-bands of every slot
  (2*eps*(nx+ny) values per tile) onto each device per step, the
  counterpart of the JAX program's ``lax.all_gather``; each tile's 3x3 halo
  is then assembled by a (T_max, 9) slot-index matrix (the JAX package's
  band order, :data:`_OFFSETS`), the same frame the executor's rectangle
  walk copies together, so results are bitwise those of that walk,
* migrations permute tiles between slots and rewrite the index matrices;
  T_max only grows (``t_max_floor``), as the JAX package keeps it to reuse
  its compiled program.

Each stretch runs as a loop of launches: per step and device, the
assembly of its real slots' frames, one ``op.apply_padded`` per real slot
(with ``method="cuda"`` one ``nsum2d`` launch) and the epilogue once over
them; pad slots are never assembled nor summed, and stay zero.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nonlocalheatequation_torch.parallel.elastic import euler_update
from nonlocalheatequation_torch.parallel.mesh import create_mesh

# the 3x3 neighbor offsets in upad assembly order (top row, mid row, bottom)
_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
            (1, -1), (1, 0), (1, 1))


class GangPlan:
    """Slot layout and neighbour index matrices for one assignment.

    ``order[d]`` lists device d's tiles in row-major tile order; tile (gx, gy) on device d at position j owns
    global slot d*T_max + j.  ``idx`` is the (ndev, T_max, 9) int64 matrix of
    neighbour slots (the zero slot S = ndev*T_max marks out-of-domain and pad
    rows).  T_max is padded up to ``t_max_floor``.
    """

    def __init__(self, assignment: np.ndarray, ndev: int, t_max_floor: int = 0):
        self.assignment = np.asarray(assignment, dtype=np.int64)
        npx, npy = self.assignment.shape
        self.ndev = int(ndev)
        self.order: dict[int, list] = {d: [] for d in range(self.ndev)}
        slot_of: dict[tuple[int, int], int] = {}
        for (gx, gy), owner in np.ndenumerate(self.assignment):
            self.order[int(owner)].append((gx, gy))
        self.t_max = max(max((len(o) for o in self.order.values()), default=1),
                         int(t_max_floor), 1)
        for d, own in self.order.items():
            for j, key in enumerate(own):
                slot_of[key] = d * self.t_max + j
        self.zero_slot = self.ndev * self.t_max
        idx = np.full((self.ndev, self.t_max, 9), self.zero_slot, dtype=np.int64)
        for d, own in self.order.items():
            for j, (gx, gy) in enumerate(own):
                for b, (dx, dy) in enumerate(_OFFSETS):
                    key = (gx + dx, gy + dy)
                    if 0 <= key[0] < npx and 0 <= key[1] < npy:
                        idx[d, j, b] = slot_of[key]
        self.idx = idx

    def tile_coords(self) -> np.ndarray:
        """(ndev, T_max, 2) tile coordinates of each slot (pad slots (0, 0))."""
        txy = np.zeros((self.ndev, self.t_max, 2), np.int64)
        for d, own in self.order.items():
            for j, key in enumerate(own):
                txy[d, j] = key
        return txy

    def pack(self, tiles: dict, nx: int, ny: int, dtype, devices) -> list:
        """One (T_max, nx, ny) slot stack per device from a (gx, gy) -> tile
        dict (tensors or arrays), each on its device; pad slots zero."""
        out = []
        for d, own in self.order.items():
            stack = torch.zeros((self.t_max, nx, ny), dtype=dtype, device=devices[d])
            for j, key in enumerate(own):
                stack[j] = torch.as_tensor(tiles[key])
            out.append(stack)
        return out

    def unpack(self, state) -> dict:
        """Back to the per-tile dict: ``state[d][j]`` of each tile."""
        return {key: state[d][j] for d, own in self.order.items() for j, key in enumerate(own)}


def _make_run_driver(step_all, test: bool, t_stride: int = 1):
    """The loop every gang regime shares: ``run(state, *aux, [g, lg,] t0,
    niter) -> state`` after ``niter`` calls of ``step_all(state, aux, g, lg,
    t)``, iteration i at t = t0 + i*t_stride (``t_stride`` = the timesteps
    one call advances: K for the superstep program)."""

    def run(state, *args):
        *aux, t0, niter = args
        g = lg = None
        if test:
            *aux, g, lg = aux
        for i in range(int(niter)):
            state = step_all(state, aux, g, lg, int(t0) + i * t_stride)
        return state

    return run


def _distinct(state) -> list:
    return list(dict.fromkeys(s.device for s in state))


def _gather_bands(state, width: int) -> dict:
    """The banded gather: for each distinct device, the (top, bottom, left,
    right) ``width``-bands of every slot of every device, in slot order,
    each with one zero row appended (the zero slot)."""
    nx, ny = state[0].shape[1:]
    w = width
    cuts = ((slice(None), slice(0, w), slice(None)), (slice(None), slice(nx - w, nx), slice(None)),
            (slice(None), slice(None), slice(0, w)), (slice(None), slice(None), slice(ny - w, ny)))
    out = {}
    for dev in _distinct(state):
        bands = []
        for cut in cuts:
            parts = [s[cut].to(dev) for s in state]
            parts.append(torch.zeros_like(parts[0][:1]))
            bands.append(torch.cat(parts))
        out[dev] = bands
    return out


def _assemble_halo(own, idx, bands, width: int):
    """(T_max, nx+2w, ny+2w) padded slots from the gathered bands, by the
    (T_max, 9) slot-index matrix: the values of the rectangle walk's frame
    (the bitwise guarantee).  Legal while width <= tile edge (the whole halo
    then comes from the 8 immediate neighbours)."""
    top_all, bot_all, left_all, right_all = bands
    w = width
    ny = own.shape[2]
    top = torch.cat([bot_all[idx[:, 0]][:, :, ny - w:], bot_all[idx[:, 1]],
                     bot_all[idx[:, 2]][:, :, :w]], dim=2)
    mid = torch.cat([right_all[idx[:, 3]], own, left_all[idx[:, 5]]], dim=2)
    bot = torch.cat([top_all[idx[:, 6]][:, :, ny - w:], top_all[idx[:, 7]],
                     top_all[idx[:, 8]][:, :, :w]], dim=2)
    return torch.cat([top, mid, bot], dim=1)


def _step_slots(op, own, frames, t, g=None, lg=None):
    """The next slot stack of one device: the first len(frames) slots
    stepped from their padded frames (L(u) frame by frame, then the
    epilogue once over them), the pad slots after them kept as they are
    (zero)."""
    n = len(frames)
    if n == 0:
        return own
    du = torch.stack([op.apply_padded(frame) for frame in frames])
    src = (g[:n], lg[:n]) if g is not None else ()
    return torch.cat([euler_update(own[:n], du, t, op.dt, *src), own[n:]])


def make_gang_run(op, nx: int, ny: int, test: bool, counts):
    """The per-step gang run (eps <= tile edge): ``run(state, idx [, g, lg],
    t0, nsteps) -> state`` after nsteps steps of every slot.  ``state``,
    ``idx``, ``g`` and ``lg`` are per-device lists; ``counts()`` gives the
    real slots of each device (the plan's current tile counts)."""
    e = op.eps
    if e > nx or e > ny:
        raise ValueError("gang path requires eps <= tile edge")

    def step_all(state, aux, g, lg, t):
        (idx,) = aux
        bands = _gather_bands(state, e)
        out = []
        for d, own in enumerate(state):
            n = counts()[d]
            upad = _assemble_halo(own[:n], idx[d][:n], bands[own.device], e)
            out.append(_step_slots(op, own, upad, t, *((g[d], lg[d]) if test else ())))
        return out

    return _make_run_driver(step_all, test)


def _superstep_tile(op, Pk, gx: int, gy: int, nx: int, ny: int, NX: int, NY: int, K: int,
                    t: int, gp=None, lgp=None):
    """K Euler levels of one tile from its K*eps-padded frame ``Pk``, each
    level's region shrinking by eps per side; gp/lgp are the tile's sources
    padded with the (K-1)*eps ring.  Cells of intermediate levels outside
    the global domain are re-zeroed (the volumetric boundary condition the
    per-step exchange re-injects)."""
    e = op.eps
    r = (K - 1) * e
    for j in range(1, K + 1):
        m = (K - j) * e  # margin beyond the tile this level keeps
        du = op.apply_padded(Pk)
        src = ()
        if gp is not None:
            o = r - m
            src = (gp[o:o + nx + 2 * m, o:o + ny + 2 * m], lgp[o:o + nx + 2 * m, o:o + ny + 2 * m])
        nxt = euler_update(Pk[e:e + nx + 2 * m, e:e + ny + 2 * m], du, t + (j - 1), op.dt, *src)
        if j < K:
            rows = (gx * nx - m) + torch.arange(nxt.shape[0], device=nxt.device)
            cols = (gy * ny - m) + torch.arange(nxt.shape[1], device=nxt.device)
            ok = ((rows >= 0) & (rows < NX))[:, None] & ((cols >= 0) & (cols < NY))[None, :]
            nxt = torch.where(ok, nxt, torch.zeros_like(nxt))
        Pk = nxt
    return Pk


def make_gang_run_superstep(op, nx: int, ny: int, NX: int, NY: int, test: bool, ksteps: int,
                            counts):
    """Communication-avoiding gang run: ONE K*eps-wide band gather per K
    steps, under ARBITRARY tile placement — the schedule of the distributed
    solver's ``superstep`` (parallel/distributed2d.py), on the slot stacks.
    Legal while K*eps <= tile edge.  ``run(state, idx, txy [, gpad, lgpad],
    t0, nblocks)`` advances K timesteps per block; ``txy`` holds each
    slot's tile coordinates (the volumetric mask's offsets) and gpad/lgpad
    each slot's sources padded with the (K-1)*eps ring.  Within 1e-12 of the
    per-step paths (the levels add in another order), not bitwise."""
    e = op.eps
    K = int(ksteps)
    E = K * e
    if E > nx or E > ny:
        raise ValueError("gang superstep requires ksteps*eps <= tile edge")

    def step_all(state, aux, g, lg, t):
        idx, txy = aux
        bands = _gather_bands(state, E)
        out = []
        for d, own in enumerate(state):
            n = counts()[d]
            upad = _assemble_halo(own[:n], idx[d][:n], bands[own.device], E)
            blocks = [_superstep_tile(op, upad[j], int(txy[d][j, 0]), int(txy[d][j, 1]), nx, ny,
                                      NX, NY, K, t, *((g[d][j], lg[d][j]) if test else ()))
                      for j in range(n)]
            out.append(torch.cat([torch.stack(blocks), own[n:]]) if n else own)
        return out

    return _make_run_driver(step_all, test, t_stride=K)


def make_gang_run_general(op, npx: int, npy: int, nx: int, ny: int, test: bool, counts):
    """Gang run for the eps > tile-edge regime (the reference's degenerate
    nx <= eps path, src/2d_nonlocal_distributed.cpp:1202-1212).

    A tile's halo is (a window of) the whole grid, so the exchange gathers
    every slot onto each device, which reassembles the global grid by the
    (npx, npy) position->slot index ``pos``, pads it once and cuts each own
    tile's (nx+2e, ny+2e) window by its coordinates ``txy``.  The values are
    the per-tile rectangle walk's, so the results are bitwise its.  Every
    device holds the global grid: callers gate this on grid size.
    """
    e = op.eps
    NX, NY = npx * nx, npy * ny

    def step_all(state, aux, g, lg, t):
        pos, txy = aux
        grids = {}
        for dev in _distinct(state):
            gathered = torch.cat([s.to(dev) for s in state])
            glob = gathered[pos.to(dev)].permute(0, 2, 1, 3).reshape(NX, NY)
            grids[dev] = F.pad(glob, (e, e, e, e))
        out = []
        for d, own in enumerate(state):
            gpad = grids[own.device]
            frames = [gpad[tx * nx:tx * nx + nx + 2 * e, ty * ny:ty * ny + ny + 2 * e].contiguous()
                      for tx, ty in txy[d][:counts()[d]].tolist()]
            out.append(_step_slots(op, own, frames, t, *((g[d], lg[d]) if test else ())))
        return out

    return _make_run_driver(step_all, test)


class GangExecutor:
    """The slot state and the runs of an ElasticSolver2D's gang stretches.

    The solver calls ``run_stretch`` for every window-free stretch;
    ``tiles()`` hands the per-tile dict back at stretch boundaries (windows,
    migration), and ``host_state()`` serves logging and checkpoints.
    """

    def __init__(self, solver):
        self.s = solver
        # the 1D slot axis over the solver's devices (one granule)
        self.mesh = create_mesh(("d",), (len(solver.devices),), solver.devices)
        self.plan: GangPlan | None = None
        self._runs: dict = {}
        self._state = None
        self._g = self._lg = None

    def _devices(self) -> list:
        return list(self.mesh.devices)

    def _counts(self) -> list:
        return [len(self.plan.order[d]) for d in range(self.plan.ndev)]

    def rebuild(self, tiles: dict, gtiles: dict | None):
        """(Re)pack the slot stacks from the per-tile dict."""
        s = self.s
        floor = self.plan.t_max if self.plan is not None else 0
        plan = GangPlan(s.assignment, len(s.devices), t_max_floor=floor)
        self.plan = plan
        devs = self._devices()
        self._state = plan.pack(tiles, s.nx, s.ny, s.dtype, devs)
        self._idx = [torch.as_tensor(plan.idx[d], device=dev) for d, dev in enumerate(devs)]
        # per-slot tile coordinates (pad slots (0, 0)): the general regime's
        # windows and the superstep's volumetric-mask offsets (host ints)
        self._txy = list(plan.tile_coords())
        if not s._use_fused:
            # the general plan's global position -> slot map
            pos = np.zeros((s.npx, s.npy), np.int64)
            for d, own in plan.order.items():
                for j, (gx, gy) in enumerate(own):
                    pos[gx, gy] = d * plan.t_max + j
            self._pos_idx = torch.as_tensor(pos)
        if s.test and gtiles is not None:
            g = {k: v[0] for k, v in gtiles.items()}
            lg = {k: v[1] for k, v in gtiles.items()}
            self._g = plan.pack(g, s.nx, s.ny, s.dtype, devs)
            self._lg = plan.pack(lg, s.nx, s.ny, s.dtype, devs)
            if s.ksteps > 1:
                # the superstep's intermediates consume an r = (K-1)*eps
                # source ring: each slot's sources padded from the GLOBAL
                # fields (zero beyond the domain, the volumetric BC's source)
                rr = (s.ksteps - 1) * s.eps
                self._gpad = self._ring_pack(g, rr)
                self._lgpad = self._ring_pack(lg, rr)

    def _ring_pack(self, tiles: dict, r: int) -> list:
        """One (T_max, nx+2r, ny+2r) stack per device: each slot its tile's
        field padded with the true r-ring of the GLOBAL field (zeros beyond
        the domain); pad slots stay all-zero."""
        s, plan = self.s, self.plan
        G = np.zeros((s.NX + 2 * r, s.NY + 2 * r), np.float64)
        for (gx, gy), v in tiles.items():
            G[r + gx * s.nx: r + (gx + 1) * s.nx, r + gy * s.ny: r + (gy + 1) * s.ny] = \
                v.cpu().numpy()
        out = []
        for d, dev in enumerate(self._devices()):
            stack = np.zeros((plan.t_max, s.nx + 2 * r, s.ny + 2 * r), np.float64)
            for j, (gx, gy) in enumerate(plan.order[d]):
                stack[j] = G[gx * s.nx: (gx + 1) * s.nx + 2 * r, gy * s.ny: (gy + 1) * s.ny + 2 * r]
            out.append(torch.tensor(stack, dtype=s.dtype, device=dev))
        return out

    def run_stretch(self, t0: int, nsteps: int) -> None:
        s = self.s
        if s.ksteps > 1 and s._use_fused and nsteps >= s.ksteps:
            # communication-avoiding blocks first (one K*eps gather per K
            # steps); the remainder falls through to the per-step run
            if "ss" not in self._runs:
                self._runs["ss"] = make_gang_run_superstep(
                    s.op, s.nx, s.ny, s.NX, s.NY, s.test, s.ksteps, self._counts)
            nblocks = nsteps // s.ksteps
            src = (self._gpad, self._lgpad) if s.test else ()
            self._state = self._runs["ss"](self._state, self._idx, self._txy, *src, t0, nblocks)
            done = nblocks * s.ksteps
            t0 += done
            nsteps -= done
            if nsteps == 0:
                return
        key = "fused" if s._use_fused else "general"
        if key not in self._runs:
            self._runs[key] = (
                make_gang_run(s.op, s.nx, s.ny, s.test, self._counts) if s._use_fused else
                make_gang_run_general(s.op, s.npx, s.npy, s.nx, s.ny, s.test, self._counts))
        aux = (self._idx,) if s._use_fused else (self._pos_idx, self._txy)
        src = (self._g, self._lg) if s.test else ()
        self._state = self._runs[key](self._state, *aux, *src, t0, nsteps)

    def host_state(self) -> list:
        """The slot stacks as host NumPy arrays (one copy per device)."""
        return [st.cpu().numpy() for st in self._state]

    def tiles(self) -> dict:
        """The per-tile dict: each tile a slot of its owner's stack."""
        return self.plan.unpack(self._state)
