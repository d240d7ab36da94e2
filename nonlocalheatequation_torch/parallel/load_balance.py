"""Dynamic load balancing, the analog of the reference's C4e — the port's
copy of ``nonlocalheatequation_tpu/parallel/load_balance.py`` (NumPy only;
the same decisions on the same busy rates).

The reference rebalances every ``nbalance`` steps: it reads per-locality
busy rates from HPX idle-rate performance counters (units of 0.01%, busy =
10000 - idle, src/2d_nonlocal_distributed.cpp:856-863), converts the
deviation from the mean into per-node tile deltas with a 0.3 dead-band
(:906-919), then re-grows/shrinks each node's tile region via DFS over the
locality adjacency graph + priority-BFS (:706-831), and finally migrates
tiles by re-constructing their client handles on new localities (:939-944).

One process that drives its devices has no per-device idle counters, so
the counters' role is played by MEASUREMENT: ``MeasuredTelemetry``
accumulates each device's observed per-step wall-clock (assemble + launch +
synchronize, timed per device group by the elastic executor) and normalizes
to the reference's 0..10000 busy units.  This is the default — like the
reference, the balancer reacts to what actually happened, so a genuinely
slow or contended device is detected.  ``WorkTelemetry`` (busy-rate modeled
as tiles x per-tile cost, with injectable per-device speed factors) is kept
as a deterministic test fixture.  The rebalance decision (``work_realloc``,
reference formula and dead-band intact) and the region-transfer step
(receivers grow by grabbing adjacent boundary tiles from donors, donors
never emptied — the BFS's effect) operate on the (npx, npy) tile->device
assignment grid; the executor (parallel/elastic.py) migrates tile tensors
with ``.to(device)``.

Acceptance: ``balance_check`` reproduces the reference's test_load_balance
criterion — max |busy - mean| <= 1500 of 10000 (:682-685).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

BUSY_SCALE = 10000.0  # busy-rate units: 0.01% (reference counters)
DEADBAND = 0.3  # fraction of one tile's busy-cost below which we don't move
ACCEPT_MAX_DEVIATION = 1500.0  # reference acceptance threshold (:682-685)


@dataclass
class WorkTelemetry:
    """Per-device busy-rate model over one rebalance window.

    ``speed_factors[d]`` scales the per-tile cost on device ``d`` (1.0 =
    homogeneous); tests use it to emulate slow nodes.  ``busy_rates`` maps
    assigned work to the reference's 0..10000 busy units: the busiest device
    defines the window (steps are dispatched in lockstep), everyone else is
    busy in proportion to its work.  This is deliberately a work-proportional
    MODEL, not a wall-clock measurement — one process exposes no
    per-device idle counters, and for homogeneous per-tile programs the two
    coincide; heterogeneity enters through ``speed_factors``.
    """

    num_devices: int
    speed_factors: np.ndarray | None = None

    def __post_init__(self):
        if self.speed_factors is None:
            self.speed_factors = np.ones(self.num_devices, dtype=np.float64)
        self.speed_factors = np.asarray(self.speed_factors, dtype=np.float64)

    def busy_rates(self, assignment: np.ndarray) -> np.ndarray:
        counts = np.bincount(assignment.ravel(), minlength=self.num_devices)
        work = counts * self.speed_factors
        window = work.max()
        if window <= 0:
            return np.zeros(self.num_devices)
        return BUSY_SCALE * work / window


@dataclass
class MeasuredTelemetry:
    """Per-device busy time MEASURED over a rebalance window — the analog
    of the reference's idle-rate performance counters
    (src/2d_nonlocal_distributed.cpp:112-128, sampled :856-863).

    The elastic executor times each device's tile group per step — halo
    assembly + launches + a device synchronize, i.e. the wall-clock that
    device's work actually took — and records it here.  ``busy_rates``
    normalizes the accumulated seconds to the reference's 0..10000 busy
    units (busiest device = the window, exactly how busy = 10000 - idle
    behaves in a lockstep loop).  ``reset`` starts a new window, mirroring
    the reference's counter re-read after each rebalance (:954-956).

    Unlike WorkTelemetry (a work-proportional MODEL kept as a test fixture),
    this reacts to anything that actually slows a device: more tiles, slower
    hardware, host contention, an interposed delay.
    """

    num_devices: int

    def __post_init__(self):
        self.busy_s = np.zeros(self.num_devices, dtype=np.float64)

    def record(self, device: int, seconds: float) -> None:
        self.busy_s[device] += seconds

    def busy_rates(self, assignment: np.ndarray | None = None) -> np.ndarray:
        window = self.busy_s.max() if self.busy_s.size else 0.0
        if window <= 0:
            return np.zeros(self.num_devices)
        return BUSY_SCALE * self.busy_s / window

    def reset(self) -> None:
        self.busy_s[:] = 0.0


def work_realloc(busy: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-device tile deltas (positive = wants more work).

    The reference's formula verbatim (src/2d_nonlocal_distributed.cpp:906-919):
    time_per_subdomain = busy/count; move ceil/floor(deviation / tps) tiles
    when the deviation exceeds the 0.3 dead-band.
    """
    busy = np.asarray(busy, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.float64)
    mean = busy.mean()
    out = np.zeros(len(busy), dtype=np.int64)
    for i in range(len(busy)):
        if counts[i] <= 0:
            # an empty device wants its fair share: mean busy at the global
            # average cost per tile
            tps = busy.sum() / max(counts.sum(), 1.0)
            out[i] = math.ceil(mean / tps) if tps > 0 else 0
            continue
        tps = busy[i] / counts[i]
        diff = mean - busy[i]
        if tps <= 0 or abs(diff) <= DEADBAND * tps:
            out[i] = 0
        elif diff > 0:
            out[i] = math.ceil(diff / tps)
        else:
            out[i] = math.floor(diff / tps)
    return out


_NBRS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _region_components(assignment: np.ndarray, device: int) -> int:
    """Number of 4-connected components of a device's tile region."""
    npx, npy = assignment.shape
    todo = {(int(x), int(y)) for x, y in zip(*np.nonzero(assignment == device), strict=True)}
    comps = 0
    while todo:
        comps += 1
        stack = [todo.pop()]
        while stack:
            cx, cy = stack.pop()
            for dx, dy in _NBRS:
                nxt = (cx + dx, cy + dy)
                if nxt in todo:
                    todo.remove(nxt)
                    stack.append(nxt)
    return comps


def _splits_region(assignment: np.ndarray, x: int, y: int,
                   before: int | None = None) -> bool:
    """Would removing tile (x, y) split its owner's region (create more
    components than it had)?  An owner already fragmented is compared
    against its own count, so pre-existing fragmentation is tolerated.
    ``before`` lets callers evaluating many candidates of the SAME owner
    pay the baseline flood-fill once."""
    owner = assignment[x, y]
    if before is None:
        before = _region_components(assignment, owner)
    assignment[x, y] = -1
    after = _region_components(assignment, owner)
    assignment[x, y] = owner
    return after > before


def _boundary_grabs(assignment: np.ndarray, receiver: int, donor: int):
    """Donor tiles 4-adjacent to the receiver's region (the reference's
    manhattan<=1 boundary walk, :769-779)."""
    npx, npy = assignment.shape
    recv_mask = assignment == receiver
    out = []
    for x, y in zip(*np.nonzero(assignment == donor), strict=True):
        for dx, dy in _NBRS:
            jx, jy = x + dx, y + dy
            if 0 <= jx < npx and 0 <= jy < npy and recv_mask[jx, jy]:
                out.append((int(x), int(y)))
                break
    return out


def _region_adjacency(assignment: np.ndarray, nl: int):
    """Region adjacency over the tile grid.  The tile grid is connected, so
    the quotient graph over any partition is connected: a transfer path
    exists between every pair of non-empty regions."""
    npx, npy = assignment.shape
    adj = [set() for _ in range(nl)]
    for x in range(npx):
        for y in range(npy):
            a = assignment[x, y]
            for dx, dy in ((1, 0), (0, 1)):
                jx, jy = x + dx, y + dy
                if jx < npx and jy < npy:
                    b = assignment[jx, jy]
                    if a != b:
                        adj[a].add(int(b))
                        adj[b].add(int(a))
    return adj


def _transfer_path(adj, receiver: int, donors: set[int],
                   realloc: np.ndarray):
    """Shortest region-adjacency path from the receiver to the best
    reachable donor (ties: most-overloaded donor, then lowest id) — the
    graph-general cascade the reference reaches via redistribution_dfs over
    the locality adjacency graph (:808-831).  Work flows along the path
    through NEUTRAL regions: each intermediate gains one tile on one side
    and gives one on the other, so only the endpoints' counts change.
    ``adj`` is the current _region_adjacency (built once per outer
    iteration — the assignment is unchanged between receiver attempts)."""
    from collections import deque

    prev = {receiver: None}
    frontier = deque([receiver])
    found = []
    depth = {receiver: 0}
    best_depth = None
    while frontier:
        cur = frontier.popleft()
        if best_depth is not None and depth[cur] >= best_depth:
            break
        for nxt in sorted(adj[cur]):
            if nxt in prev:
                continue
            prev[nxt] = cur
            depth[nxt] = depth[cur] + 1
            if nxt in donors:
                found.append(nxt)
                best_depth = depth[nxt]
            else:
                frontier.append(nxt)
    if not found:
        return None
    donor = min(found, key=lambda d: (realloc[d], d))
    path = [donor]
    while prev[path[-1]] is not None:
        path.append(prev[path[-1]])
    path.reverse()  # receiver ... donor
    return path


def rebalance_assignment(assignment: np.ndarray, busy: np.ndarray,
                         stats: dict | None = None) -> np.ndarray:
    """One rebalance pass: new (npx, npy) tile->device assignment.

    Receivers (work_realloc > 0) grow their regions with boundary-tile
    transfers; when no donor region touches a receiver (donor islands,
    dead-band neutrals in between), work CASCADES along the shortest
    region-adjacency path — each hop's region grabs a boundary tile from
    the next, so intermediates keep their counts and only the endpoint
    donor shrinks.  This is the effect of the reference's
    redistribution_dfs + locality_subdomain_bfs (:706-831) generalized to
    arbitrary region shapes.  Guarantees: donors are never emptied
    (total_subdomains > 1 guard, :751); grabs prefer tiles whose removal
    does NOT split the donor's region (articulation check), so regions
    that start connected stay connected unless literally every transfer
    would split — ``stats["splits"]`` counts those forced cases.
    A device that owns zero tiles is seeded with the best boundary tile of
    the most-loaded donor first.
    """
    assignment = np.array(assignment, dtype=np.int64)
    nl = int(max(assignment.max() + 1, len(busy)))
    counts = np.bincount(assignment.ravel(), minlength=nl)
    realloc = work_realloc(busy, counts)
    if stats is None:
        stats = {}
    stats.setdefault("splits", 0)
    stats.setdefault("chains", 0)

    # seed empty receivers: give each one donor tile, spread apart — the tile
    # (of the most-loaded donor) farthest from every already-placed
    # non-donor tile, so seeded regions have room to grow
    for d in range(nl):
        if counts[d] == 0 and realloc[d] > 0:
            donor = int(np.argmax(busy))
            xs, ys = np.nonzero(assignment == donor)
            if len(xs) > 1:
                ox, oy = np.nonzero(assignment != donor)
                if len(ox):
                    dist = ((xs[:, None] - ox[None, :]) ** 2
                            + (ys[:, None] - oy[None, :]) ** 2).min(axis=1)
                else:
                    cx, cy = xs.mean(), ys.mean()
                    dist = (xs - cx) ** 2 + (ys - cy) ** 2
                # prefer seeds whose removal keeps the donor connected
                order = np.argsort(-dist, kind="stable")
                i = int(order[0])
                for cand in order:
                    if not _splits_region(assignment, xs[cand], ys[cand]):
                        i = int(cand)
                        break
                else:
                    stats["splits"] += 1
                assignment[xs[i], ys[i]] = d
                counts[donor] -= 1
                counts[d] += 1
                realloc[d] -= 1
                realloc[donor] += 1

    # transfer loop: each chain moves exactly one tile of work from the
    # endpoint donor to the neediest receiver (possibly through neutral
    # regions), so sum(max(realloc, 0)) strictly decreases — termination
    guard = assignment.size * nl + 10
    while guard > 0:
        guard -= 1
        receivers = sorted((i for i in range(nl) if realloc[i] > 0),
                           key=lambda i: (-realloc[i], i))
        donors = {i for i in range(nl) if realloc[i] < 0 and counts[i] > 1}
        if not receivers or not donors:
            break
        progressed = False
        adj = _region_adjacency(assignment, nl)
        for receiver in receivers:
            path = _transfer_path(adj, receiver, donors, realloc)
            if path is None:  # receiver owns no tiles & wasn't seeded
                continue
            # execute the chain DONOR-END FIRST: each hop's giver grabs its
            # replacement from the next region before giving a tile away,
            # so a single-tile intermediate is never emptied mid-chain and
            # every hop's boundary (computed from the path's adjacency,
            # which only ever GAINS tiles ahead of the current hop) is
            # guaranteed non-empty
            moves = []  # (x, y, previous_owner) for rollback
            split_moves = 0
            ok = True
            for recv_side, donor_side in reversed(list(zip(path, path[1:], strict=False))):
                grabs = _boundary_grabs(assignment, recv_side, donor_side)
                if not grabs:  # unreachable per the argument above; defend
                    ok = False
                    break
                before = _region_components(assignment, donor_side)
                keep = [g for g in grabs
                        if not _splits_region(assignment, g[0], g[1], before)]
                forced = not keep
                x, y = min(keep or grabs)
                if forced:
                    split_moves += 1
                moves.append((x, y, int(assignment[x, y])))
                assignment[x, y] = recv_side
            if not ok:  # defensive rollback (see above)
                for x, y, owner in reversed(moves):
                    assignment[x, y] = owner
                continue
            stats["splits"] += split_moves
            counts[path[0]] += 1
            counts[path[-1]] -= 1
            realloc[path[0]] -= 1
            realloc[path[-1]] += 1
            stats["chains"] += 1
            progressed = True
            break
        if not progressed:
            break
    return assignment


def publish_busy_rates(busy, moved: int | None = None,
                       registry=None) -> None:
    """Mirror one rebalance window's busy rates into the obs registry —
    ``/device{d}/busy-rate`` gauges plus ``/balance/windows`` and (when
    ``moved`` tiles actually migrated) ``/balance/tiles-moved`` and
    ``/balance/rebalances`` counters, the namespace twin of the HPX
    idle-rate counters this module models
    (src/2d_nonlocal_distributed.cpp:112-128).  A window where the
    balancer ran but moved nothing counts only as a window — the
    rebalances counter reflects actual migrations, not invocations.
    Defaults to the process-wide ``REGISTRY``; never raises
    (observability must not fail a rebalance)."""
    try:
        from nonlocalheatequation_torch.obs.metrics import REGISTRY

        reg = REGISTRY if registry is None else registry
        for d, b in enumerate(np.asarray(busy, dtype=np.float64)):
            reg.gauge(f"/device{{{d}}}/busy-rate").set(float(b))
        reg.counter("/balance/windows").inc()
        if moved:
            reg.counter("/balance/rebalances").inc()
            reg.counter("/balance/tiles-moved").inc(int(moved))
    except Exception:  # noqa: BLE001 — observability never raises
        pass


def balance_check(busy: np.ndarray) -> tuple[bool, float]:
    """The reference's acceptance criterion (test_load_balance, :647-686):
    max |busy_i - mean| <= 1500 (units of 0.01%)."""
    busy = np.asarray(busy, dtype=np.float64)
    mean = busy.mean()
    max_diff = float(np.abs(busy - mean).max()) if busy.size else 0.0
    return max_diff <= ACCEPT_MAX_DEVIATION, max_diff


def print_balance_report(busy: np.ndarray, assignment: np.ndarray) -> bool:
    """Reference-format stdout report (:654-686): counter values, expected
    busy rate, the tile->owner grid, and the verdict line."""
    busy = np.asarray(busy, dtype=np.float64)
    print("Testing load balance:")
    for v in busy:
        print(f"Test: counter value: {v}")
    print(f"Expected busy rate {busy.mean()}")
    print("Visualizing Load Balance across nodes")
    npx, npy = assignment.shape
    for idx in range(npx):
        print(" ".join(str(int(assignment[idx, idy])) for idy in range(npy)) + " ")
    ok, _ = balance_check(busy)
    print("Load balanced correctly" if ok else "Load not balanced correctly")
    return ok
