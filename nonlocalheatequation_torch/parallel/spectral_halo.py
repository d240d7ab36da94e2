"""Distributed spectral steppers over the pencil-FFT transposes —
counterpart of ``nonlocalheatequation_tpu/parallel/spectral_halo.py``.

parallel/stepper_halo.py puts the RKC stage loop above the halo exchange;
this module puts the spectral tier above the pencil-decomposed transforms
(ops/spectral_sharded.py): sharded ``method='fft'`` Euler, rkc on fft and the
distributed exponential integrator.  The transform is the global zero-collar
box computed over the mesh, not a halo scheme, so the padded entry points
still refuse fft.

* :func:`make_spectral_apply`: L(u) of every block through the sharded
  transform, in ``NonlocalOp.apply``'s expression ``c*h^d * (neighbour sum
  - wsum*u)`` with the neighbour sum ``inv(fwd(u) * sigma)``, so Euler and
  every rkc stage on fft hold the 1e-12 contract against the single-device
  fft solve.
* :func:`make_expo_step_blk`: the distributed ETD1 step, the single-device
  ``_make_expo_step`` with the whole-box transforms replaced by
  ``plan.fwd``/``plan.inv`` and the collar projection ``Pi`` by the
  identical composition ``PF = fwd o inv``; the S >= 1 correction's
  commutator is evaluated in the frequency domain, ``D_h = PF(lam *
  PF(mid_h)) - lam * mid_h`` (analytically the serial ``rfftn(d)``; within
  f64 rounding, not bitwise).
* :func:`spectral_tables`: the frequency tables on the host in the plan's
  padded layout, from the single-device bakers (ops/spectral.neighbor_symbol,
  models/steppers._expo_tables) in float64; the solvers place them on the
  mesh once per run in the state's real dtype (``plan.put_freq``), the cast
  the single-device path makes.

Sources are frozen at the step's start, as the single-device steps freeze
them.  The step functions take and return object arrays of blocks
(parallel/mesh.py): ``(blocks, *tables, [g, lg,] t) -> blocks``, the JAX
per-shard signature.
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.obs.metrics import REGISTRY
from nonlocalheatequation_torch.ops.nonlocal_op import case_scale, source_at
from nonlocalheatequation_torch.parallel.mesh import map_blocks


def spectral_tables(op, plan, stepper: str, stages: int) -> tuple:
    """The step's frequency tables as host float64 arrays in ``plan``'s
    padded global layout (JAX ``:75``):

    * euler / rkc: ``(sigma,)``, the neighbour symbol (the operator scale
      stays in the apply expression);
    * expo: ``(E, P)`` at stages == 0, ``(E, P, Eh, lam)`` with the boundary
      correction armed: the single-device ``_expo_tables`` values, padded
      with zeros."""
    if stepper != "expo":
        return (plan.neighbor_symbol_padded(op.weights),)
    from nonlocalheatequation_torch.models.steppers import _expo_tables

    S = max(0, int(stages))
    tabs = _expo_tables(op, plan.shape, torch.float64, "cpu", sub_dt=op.dt / max(1, S),
                        correction=bool(S))
    return tuple(plan.pad_freq(t.numpy()) for t in tabs)


def ntables(stepper: str, stages: int) -> int:
    """How many frequency tables the (stepper, stages) step takes."""
    if stepper != "expo":
        return 1
    return 4 if int(stages) > 0 else 2


def make_spectral_apply(op, plan):
    """``apply(blocks, sig) -> L(u)`` blocks through the sharded transform, in
    ``NonlocalOp.apply``'s expression order over ``neighbor_sum_fft``;
    ``case_scale`` is the same ``c*h^d`` host float."""
    scale = case_scale(op)
    wsum = op.wsum

    def apply_blocks(blocks, sig):
        opd = map_blocks(op._operand, blocks)
        ns = plan.inv(map_blocks(lambda h, s: h * s, plan.fwd(opd), sig))
        return map_blocks(lambda n, u: scale * (n - wsum * u), ns, opd)

    return apply_blocks


def build_spectral_local_step(op, plan, stepper: str, stages: int, test: bool):
    """The step of a spectral distributed solver: ``(blocks, *tables, [g,
    lg,] t) -> blocks`` after ONE dt, :func:`ntables` tables first; one
    builder, so the 2D and 3D solvers cannot drift."""
    if stepper == "expo":
        return make_expo_step_blk(op, plan, stages, test)
    sapply = make_spectral_apply(op, plan)
    if stepper == "rkc":
        from nonlocalheatequation_torch.parallel.stepper_halo import make_rkc_perstage_step

        def local_step(blocks, sig, *rest):
            # every rkc stage is one spectral apply: the stage loop above the
            # transport, as on the halo tier
            stage_step = make_rkc_perstage_step(op, stages, lambda y: sapply(y, sig), test)
            return stage_step(blocks, *rest)

        return local_step
    dt = op.dt
    # euler: the single-device step expression over the sharded apply
    if test:
        def local_step(blocks, sig, g, lg, t):
            du = map_blocks(lambda d, gb, lgb: d + source_at(gb, lgb, t, dt),
                            sapply(blocks, sig), g, lg)
            return map_blocks(lambda u, d: u + dt * d, blocks, du)
    else:
        def local_step(blocks, sig, t):
            return map_blocks(lambda u, d: u + dt * d, blocks, sapply(blocks, sig))
    return local_step


def spectral_halo_obs(plan, stepper: str, stages: int, steps: int, itemsize: int,
                      comm: str) -> dict:
    """The scheduled all-to-all traffic of a spectral distributed run (JAX
    ``:166``), host arithmetic from the plan's transpose schedule: a
    transform pair (fwd + inv) runs the schedule twice; pairs a step: 1
    (euler), ``stages`` (rkc), ``1 + 3*S`` (expo with the correction; a
    documented approximation).  Increments /halo/exchanges and /halo/bytes
    and returns the span's attributes."""
    sched = [e for e in plan.a2a_schedule() if e[0] > 1]
    msgs = 2 * sum(p - 1 for p, _, _ in sched)
    nbytes = 2 * sum(n * int(itemsize) * (2 if cplx else 1) * (p - 1) // p
                     for p, n, cplx in sched)
    if stepper == "rkc":
        pairs = int(stages)
    elif stepper == "expo":
        pairs = 1 + 3 * max(0, int(stages))
    else:
        pairs = 1
    rounds = int(steps) * pairs
    ndev = int(np.prod(plan.mesh_shape))
    REGISTRY.counter("/halo/exchanges").inc(rounds * msgs * ndev)
    REGISTRY.counter("/halo/bytes").inc(rounds * nbytes * ndev)
    return dict(comm=comm, transport="alltoall", devices=ndev, rounds=rounds,
                messages_per_round=msgs * ndev, bytes_per_device_round=nbytes)


def make_expo_step_blk(op, plan, stages: int, test: bool):
    """The distributed ETD1 step (JAX ``:185``): ``(blocks, *tables, [g, lg,]
    t) -> blocks`` after ONE dt; ``stages = S >= 1`` arms the boundary
    correction's S substeps of dt/S."""
    dt = op.dt
    S = max(0, int(stages))
    nt = ntables("expo", S)

    def mul(a, h):
        return map_blocks(lambda x, y: x * y, a, h)

    def add(a, b):
        return map_blocks(lambda x, y: x + y, a, b)

    def step(blocks, *args):
        tabs, rest = args[:nt], args[nt:]
        bh = None
        if test:
            g, lg, t = rest
            bh = plan.fwd(map_blocks(lambda gb, lgb: source_at(gb, lgb, t, dt), g, lg))
        uh = plan.fwd(map_blocks(op._operand, blocks))
        if not S:
            E, Pt = tabs
            uh = mul(E, uh)
            if test:
                uh = add(uh, mul(Pt, bh))
            return plan.inv(uh)
        E, Pt, Eh, lam = tabs
        sub = dt / S

        def PF(h):
            # Pi in the frequency domain: the inverse discards the collar, the
            # forward re-embeds it as zeros
            return plan.fwd(plan.inv(h))

        cur_h = uh
        for i in range(S):
            mid_h = mul(Eh, cur_h)
            base_h = mul(Eh, mid_h)  # E * cur_h, through the damped midpoint
            if test:
                base_h = add(base_h, mul(Pt, bh))
            # D(mid) = Pi L Pi mid - L mid, evaluated spectrally
            d_h = map_blocks(lambda a, lm, m: a - lm * m, PF(mul(lam, PF(mid_h))), lam, mid_h)
            cur_h = map_blocks(lambda b, e, d: b + (0.5 * sub) * (e * d), base_h, Eh, d_h)
            if i + 1 < S:
                # the collar re-zeroed between substeps, as at the step boundary
                cur_h = PF(cur_h)
        return plan.inv(cur_h)

    return step
