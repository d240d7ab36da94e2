"""Distributed super-stepping: the RKC stage loop over the halo exchange —
counterpart of ``nonlocalheatequation_tpu/parallel/stepper_halo.py``.

Every RKC stage (models/steppers.py) is one eps-halo operator apply, so the
stage loop sits above the distributed solvers' exchange unchanged:

* **Per-stage exchange** (``ksteps == 1``, :func:`make_rkc_perstage_step`):
  each stage's right-hand side is the solver's own apply of every block
  (``halo_pad_nd`` then ``op.apply_padded`` on ``comm='collective'``, the
  halo kernels of ops/cuda_halo.py on ``comm='fused'``), and the recurrence
  is the single-device ``_make_rkc_step``'s expression order over each
  block, ``mu*y1 + nu*y2 + (mut*dt)*rhs`` with host-float coefficients.
  The exchange rebuilds each block's neighbourhood exactly and eager torch
  runs the same elementwise program, so per-stage distributed rkc is the
  single-device rkc solve bitwise (on the card too: each stage is one
  ``nsum2d``/``nsum3d`` launch per block, or one ``fused_nsum2d``/
  ``split_nsum2d`` ... launch, bitwise the one-pass sum).
* **Stage batches** (``ksteps = K > 1``, :func:`make_rkc_stagebatch_step`):
  one exchange round per batch of B = K stages (a (B*eps)-wide halo on the
  leading carry and a ((B-1)*eps)-wide one on the trailing carry, multi-hop
  where that exceeds a block), then B local stages on margins shrinking by
  eps a stage, the cells outside the global domain re-zeroed on every
  intermediate margin: the distributed Euler superstep's schedule applied
  to the stages of one dt.  Ring cells owned by neighbours are recomputed
  locally from the same values, so the result holds the per-stage form to
  the 1e-12 contract (the JAX package pins each intermediate with
  ``optimization_barrier`` against XLA's re-fusion; eager torch rounds each
  operation on its own and needs none).

Sources are frozen at the step's start, as in the single-device scheme: the
stage-batch form reads them from the ``(ksteps-1)*eps``-ring blocks that the
Euler superstep's ``_prep_sources`` builds.  Both builders are
dimension-generic: the 2D and 3D solvers pass their halo transport and
global extents.  Steps take and return object arrays of blocks
(parallel/mesh.py) and run on the blocks this rank owns; a block's origin
is its mesh position times the block shape.
"""

from __future__ import annotations

import torch

from nonlocalheatequation_torch.models.steppers import STEPPERS, _rkc_coeffs, validate_stepper
from nonlocalheatequation_torch.ops.nonlocal_op import source_at
from nonlocalheatequation_torch.parallel.mesh import first_local, local_positions, map_blocks


def validate_dist_stepper(op, stepper: str, stages: int) -> tuple:
    """The distributed solvers' stepper checks (JAX ``:63``): the
    single-device ones (models/steppers.validate_stepper) and the
    distributed rule that ``expo`` serves sharded blocks only through
    ``method='fft'`` (the pencil-decomposed transform,
    ops/spectral_sharded.py).  Returns the canonical ``(stepper, stages)``."""
    if stepper not in STEPPERS:
        raise ValueError(f"unknown stepper {stepper!r}; one of {STEPPERS}")
    if stepper == "expo" and getattr(op, "method", None) != "fft":
        raise ValueError(
            "stepper='expo' integrates the whole-domain spectral symbol; "
            "on the distributed path it requires method='fft' (the "
            "pencil-decomposed sharded transform, ops/spectral_sharded"
            ".py) — a stencil block's halo carries neighbor data, not "
            "the zero collar; rkc super-steps the stencil methods")
    validate_stepper(op, stepper, stages)
    return stepper, int(stages)


def make_rkc_perstage_step(op, stages: int, apply_blocks, test: bool):
    """The per-stage-exchange RKC step (JAX ``:89``): ``(blocks, [g, lg,] t)
    -> blocks`` after ONE dt, where every stage's right-hand side is one
    ``apply_blocks`` call (an object array of blocks -> their L(u) blocks,
    one exchange, collective or fused)."""
    co = _rkc_coeffs(stages)
    s, mu, nu, mut = co["s"], co["mu"], co["nu"], co["mut"]
    dt = op.dt

    def step(blocks, *rest):
        b = None
        if test:
            g, lg, t = rest
            b = map_blocks(lambda gb, lgb: source_at(gb, lgb, t, dt), g, lg)

        def rhs(y):
            du = apply_blocks(y)
            return du if b is None else map_blocks(lambda d, bb: d + bb, du, b)

        y_prev2 = blocks
        y_prev = map_blocks(lambda u, d: u + (mut[1] * dt) * d, blocks, rhs(blocks))
        for j in range(2, s + 1):
            y = map_blocks(lambda y1, y2, d, j=j: mu[j] * y1 + nu[j] * y2 + (mut[j] * dt) * d,
                           y_prev, y_prev2, rhs(y_prev))
            y_prev2, y_prev = y_prev, y
        return y_prev

    return step


def make_rkc_stagebatch_step(op, stages: int, ksteps: int, pad, grid_N, test: bool,
                             src_halo: int):
    """The communication-avoiding RKC step (JAX ``:124``): stages grouped in
    batches of ``ksteps``, one exchange round a batch (the module
    docstring's schedule).  ``pad(blocks, w)`` is the solver's halo transport
    (``halo_pad_nd``), ``grid_N`` the global extents (the volumetric collar
    mask) and ``src_halo`` the source ring width ``(ksteps-1)*eps`` (test
    mode takes the ring-padded ``gp``/``lgp`` blocks of ``_prep_sources``).
    Signature: ``(blocks, [gp, lgp,] t) -> blocks`` after ONE dt."""
    co = _rkc_coeffs(stages)
    s, mu, nu, mut = co["s"], co["mu"], co["nu"], co["mut"]
    K = int(ksteps)
    eps = int(op.eps)
    dt = op.dt

    def step(blocks, *rest):
        if test:
            gp, lgp, t = rest
        else:
            (t,) = rest
        if first_local(blocks) is None:
            return blocks  # this rank owns no block: no band to send or receive
        bshape = tuple(first_local(blocks).shape)
        nd = len(bshape)

        def crop(arr, m_from: int, m_to: int):
            d = m_from - m_to
            return arr[tuple(slice(d, d + b + 2 * m_to) for b in bshape)]

        def mask_collar(arr, m: int, pos):
            # volumetric BC on intermediates: margin cells outside the global
            # domain stay zero at every stage
            ok = torch.ones((), dtype=torch.bool, device=arr.device)
            for ax in range(nd):
                c = (pos[ax] * bshape[ax] - m) + torch.arange(arr.shape[ax], device=arr.device)
                shape = [1] * nd
                shape[ax] = arr.shape[ax]
                ok = ok & ((c >= 0) & (c < grid_N[ax])).reshape(shape)
            return torch.where(ok, arr, torch.zeros_like(arr))

        def src_at_margin(pos, m: int):
            o = src_halo - m
            sl = tuple(slice(o, o + b + 2 * m) for b in bshape)
            return source_at(gp[pos][sl], lgp[pos][sl], t, dt)

        j = 1  # the next stage to run (1..s)
        y_prev = blocks  # margin 0 at the batch's entry
        y_prev2 = None
        while j <= s:
            B = min(K, s - j + 1)
            # the batch's exchange round: both carries' bands
            Pp, p_m = pad(y_prev, B * eps), B * eps
            Pq, q_m = None, 0
            if y_prev2 is not None and B > 1:
                Pq, q_m = pad(y_prev2, (B - 1) * eps), (B - 1) * eps
            elif y_prev2 is not None:
                Pq, q_m = y_prev2, 0
            for _ in range(B):
                m = p_m - eps  # the margin this stage leaves
                nxt = Pp.copy()  # other ranks' positions keep their placeholders
                for pos in local_positions(Pp):
                    du = op.apply_padded(Pp[pos])  # margin p_m -> m
                    if test:
                        # every stage reads the source at the STEP's t
                        du = du + src_at_margin(pos, m)
                    base = crop(Pp[pos], p_m, m)
                    if j == 1:
                        y = base + (mut[1] * dt) * du
                    else:
                        y = (mu[j] * base + nu[j] * crop(Pq[pos], q_m, m)
                             + (mut[j] * dt) * du)
                    nxt[pos] = mask_collar(y, m, pos) if m > 0 else y
                Pq, q_m = Pp, p_m
                Pp, p_m = nxt, m
                j += 1
            y_prev = Pp  # margin 0 (the batch's last stage)
            y_prev2 = map_blocks(lambda a: crop(a, q_m, 0), Pq) if Pq is not None else None
        return y_prev

    return step
