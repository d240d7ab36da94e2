#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nonlocalheatequation_torch) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the last
line is printed; the phase walls are printed at the end):

1. Device and build: the card's name and power limit, then the kernels built
   by nvcc from csrc/ (one nvcc per source, started together), and each
   source's ptxas report.  The batch CLIs of phase 3 start right after it.
2. Kernels against their plain PyTorch versions on the card, in float64,
   float32 and the bf16 operand tier.  Tolerance: max|kernel - plain| <=
   1e-12 (float64) or 1e-5 (float32) times the largest magnitude of the
   plain result.  2D: nsum2d and step2d over eps in {1, 3, 5, 8, 10, 16, 40}
   and ragged shapes (1x1, non tile multiples, nx < 2*eps, eps above the
   32-point tile); then the multi-step kernels (carried2d; superstep2d at
   K = 1-4 and a 7-step run with a remainder; resident2d, which has no bf16
   tier) over the same shapes and eps up to 60 where each takes it, each
   held to its plain version (in the bf16 tier plus one bfloat16 rounding
   flip per step after the first, see phase_multistep_checks) and BITWISE
   to the same number of step2d launches.  3D: nsum3d and step3d
   (production and test form) over eps in {1, 2, 3, 4, 6, 8} and ragged
   shapes (1x1x1, non tile multiples, n < 2*eps, nx != ny != nz); carried3d
   and resident3d (no bf16 tier) held to their plain versions and BITWISE
   to step3d launches over 1, 2, 3 and 5 steps.  resident2d at 4096^2 and
   resident3d at 256^3, eps=4, beyond their gates, must raise ValueError.
   The batched kernels (batched_step2d production and test form,
   batched_carried2d, batched_superstep2d at K = 1-4), uniform and mixed
   physics, B in {1, 2, 3, 8}, eps 1-8, 16 and 40 over ragged grids: each
   held to its plain version (batched_step2d BITWISE) and each lane
   BITWISE to its solo launch (phase_batched_checks).
3. The main path's correctness: the batch tables (CASES_2D and CASES_1D of
   tests/cases.py, CASES_3D of tests/test_oracle_3d.py, copied here) through
   the port's CLIs on the card in float64, each must print "Tests Passed"
   (CASES_1D and CASES_3D also with --ensemble); then CASES_2D and CASES_3D
   in float32 through Solver2D and Solver3D, reporting the largest
   error_l2/#points.
4. The 2D headline configuration: 4096^2, eps=8, float32, method="cuda".  At
   the main path's shape every kernel form (nsum2d f32 and bf16 operand,
   and in float64 on the padded G the test-form solve gives it; step2d
   production and test form, f32 and bf16 operand; carried2d and
   superstep2d at K = 2 and 3) is held against its plain version with the
   phase-2 tolerances.  The kernels are timed with CUDA events beside their
   plain versions, their byte/operation bound and F.conv2d (the library
   yardstick for the neighbour sum, with TF32 disabled; the port never calls
   it), and the test-form source's set-up is timed on the card and in NumPy.
   Every multi-step candidate of the tuner is timed in ms/step at 4096^2
   (resident does not fit there) and at 512^2, eps=8, f32, where resident
   fits; there the per-step, carried and superstep kernels are also timed
   alone, as a replayed CUDA graph of launches, since a loop of launches
   from Python times the host at that size.  Then the launch counts and the
   tuner's records are reset and the 2D main path runs through Solver2D:
   the production solve at 4096^2 and at 512^2 (each tunes its shape, as a
   first production call does, and runs the winner) and a test-form solve
   at 4096^2 (whose L(G) goes through nsum2d); the 2D counts must show
   every 2D kernel launched, and exactly the probes' and the winners'
   launches.  The tuner's records are printed.
5. The 3D path, the same way: the kernels at 256^3, eps=4, f32 (every form
   held to its plain version, carried3d bitwise to step3d launches; timed
   beside the plain versions, the bound and F.conv3d with TF32 disabled),
   the tuner's candidates at 256^3 and at 128^3, eps=6 (where resident3d
   fits; it is held bitwise to step3d launches there and timed), then the
   counts and records reset and the 3D main path through Solver3D: the
   production solves at both shapes (each tuned) and a test-form solve at
   256^3; the 3D counts must equal the probes', the winners' and the test
   form's launches, every 3D kernel among them.
6. The ensemble engine (phase_ensemble) at the JAX package's ensemble
   size, 8 production cases of 1024^2, eps=8, f32, 500 steps, and a
   mixed-physics 8 x 512^2 bucket: the batched kernels at 8 x 1024^2 held to
   their plain versions (batched_step2d bitwise) and bitwise per lane to the
   solo kernels, timed beside their plain versions and bounds;
   batched_step2d at B=1 timed against step2d on the same 1024^2 and 4096^2
   planes (its register design against the shared tile body, in turns); the
   engine's run timed beside the
   same 8 cases as 8 sequential tuned solves; every lane of both buckets
   bitwise equal to its solo per-step loop.  Then, counted: CASES_2D through
   solve2d --ensemble in float64 (it must print "Tests Passed" and launch
   batched_step2d, never step2d), both buckets through EnsembleEngine (each
   1 bucket, 1 program, 1 dispatch, 500 batched_step2d launches), and both
   under NLHEAT_TUNE_BATCH=1 (the batched tuner's probes and winner); the
   batched counts must equal the rows', buckets', probes' and winners'.
7. The unstructured path (phase_unstructured_checks, phase_unstructured):
   windowed_matvec (f64, f32) and gather_L (f64, f32, bf16 operand) held to
   their plain versions on small clouds (2D jittered and shuffled, 3D, 1D,
   n not a multiple of 128, a forced residual, a self-only horizon, a hub
   node), the windowed operator to the NumPy oracle, and stacked gather
   lanes bitwise their solo runs.  Then the shuffled jittered 512^2 cloud
   (262,144 nodes, eps = 3h, f32): the host walls of the edge and plan
   builds, the card memory of building the windowed exec (its packed
   in-window entries; it must not allocate the dense strips), both kernels
   held and timed beside their plain versions, their bounds and
   torch.sparse.mm of a CSR matrix of the same entries (in turns, in CUDA
   graphs and in loops of launches), one L(u) per layout and one
   auto-picked L(u) (counted: one windowed_matvec).  The CLI on the card:
   data/*.msh with --layout auto and windowed in f64 (error_l2/N <= 1e-6;
   started with phase 3's CLIs and collected after them), then, counted, the 512^2 cloud from a 2.2 .msh
   with --layout auto, which must choose windowed and launch
   windowed_matvec once per step.  Last, bench.py's graded cloud at nm=256
   (65,536 nodes) in a throwaway mesh registry: gather_L held and timed at
   its shape, then, counted, an 8-case bucket and a mixed-physics 8-case
   bucket through EnsembleEngine, each 8 x MESH_STEPS gather_L launches, every
   lane bitwise its solo gather loop and within the manufactured contract.
8. The distributed grid solves (phase_halo_checks, phase_distributed):
   fused_nsum2d and fused_nsum3d (the halo read inside the kernel from the
   blocks around it) over meshes of blocks, and split_nsum2d and
   split_nsum3d (the split kernels, interior then ring, on a filled
   frame), held to their plain versions in float64, float32 and the bf16
   tier on normal, degenerate and multi-hop blocks, and BITWISE to the
   one-pass nsum2d/nsum3d on each halo-exchanged frame; then, at the main
   path's blocks (2048^2, eps=8 and 128^3, eps=4, f32), held and timed
   beside their plain versions, their bounds and F.conv2d/F.conv3d over
   the frame.  Counted: Solver2DDistributed at 4096^2, eps=8, on a 2x2
   mesh of virtual devices of the card and Solver3DDistributed at 256^3,
   eps=4, on 2x2x2, 20 production steps each with comm='fused' (the
   in-kernel exchange, the card's default), comm='fused' with
   NLHEAT_FUSED_TRANSPORT=interp (band copies, then the split kernels) and
   comm='collective', all three bitwise equal; and CASES_2D_DISTRIBUTED
   through solve2d_distributed --test_batch (float64, 8 virtual devices,
   --comm fused and the default), which must print "Tests Passed"; the
   counts must be exactly the solves' and the rows'.  Each solve is held
   within 1e-5 of the tuned single-device Solver2D/Solver3D, and the steps
   are timed on the card.
9. The kernels' JSON line, then {"ok": true, "device": {...}}.

Exits non-zero and prints no result when torch.cuda.is_available() is false
or when the port package is not beside this script.
"""

from __future__ import annotations

import atexit
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
NX, EPS, STEPS, TEST_STEPS = 4096, 8, 500, 20
SMALL = 512        # the small production grid, where resident fits
VARIANT_STEPS = 100  # steps per timed multi-step run at 4096^2 (500 at 512^2)
GRAPH_LAUNCHES = 100  # launches per CUDA graph when timing a kernel alone at 512^2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TOL = {"float64": 1e-12, "float32": 1e-5}
CHILDREN: list = []    # the CLI processes this run started
N3, EPS3 = 256, 4      # the 3D headline: 256^3, eps=4, f32 (64 MiB of state)
N3S, EPS3S = 128, 6    # the small 3D grid, where resident3d fits the L2
STEPS3 = 200           # steps of the 3D production solves and timed variant runs
ENS_B, ENS_N = 8, 1024  # the JAX package's ensemble8x1024: 8 cases of 1024^2 (32 MiB f32)
ENS_MIXED_N = 512      # the mixed-physics ensemble bucket, 8 cases of 512^2
# nx ny nz nt eps k dt dh: a copy of tests/test_oracle_3d.py's CASES_3D (that
# file imports JAX; tests/test_torch_3d.py holds the copy equal to it)
CASES_3D = [
    (16, 16, 16, 20, 3, 1.0, 0.0005, 0.0625),
    (12, 12, 12, 40, 2, 1.0, 0.0002, 1.0 / 12),
    (16, 12, 8, 20, 3, 0.5, 0.0005, 0.05),
    (6, 6, 6, 10, 8, 1.0, 0.0001, 1.0 / 6),   # eps > grid: degenerate halo
]


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def cases_module():
    path = ROOT / "tests" / "cases.py"
    if not path.is_file():
        fail(f"{path} not found: run from a checkout of the repository")
    spec = importlib.util.spec_from_file_location("nlheat_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cases():
    mod = cases_module()
    return mod.CASES_2D, mod.CASES_1D, mod.L2_THRESHOLD


def cuda_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Mean milliseconds per call of fn over reps calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it) on an H100 SXM at its published peaks."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def kernel_ops(eps: int, epilogue: int) -> float:
    """Operations per output point of the kernels' algorithm (the tile body,
    csrc/stencil_tile.cuh):
    the row window sums add 2*eps terms into each cell of a tile's
    (32+2eps) x 32 window rows, shared by its 32 output rows; each output then
    adds 2*eps+1 of them, and the step ``epilogue`` more: 41 + epilogue at
    eps=8, where the direct sum over the mask takes 196 adds."""
    return 2 * eps * (32 + 2 * eps) / 32 + (2 * eps + 1) + epilogue


def kernel_ops_3d(eps: int, tp: int, epilogue: int) -> float:
    """Operations per output point of the 3D kernels' algorithm (the tile
    body, csrc/stencil_tile3d.cuh, at plane width tp): the z window sums add
    2*eps terms into each of a tile's (tp+2eps)^2 x 32 window cells, shared
    by its tp^2 x 32 outputs; each output then adds one term per sphere
    column, and the step ``epilogue`` more: 81 + epilogue at eps=4, tp=8,
    where the direct sum over the sphere takes 256 adds."""
    from nonlocalheatequation_torch.ops.stencil import sphere_column_heights

    columns = int((sphere_column_heights(eps) >= 0).sum())
    return 2 * eps * (tp + 2 * eps) ** 2 / tp ** 2 + columns + epilogue


def phase_checks(torch, ck, np) -> dict:
    """Phase 2: every kernel against its plain version on the card."""
    rng = np.random.default_rng(SEED)
    shapes = [(1, 1), (37, 50), (64, 64), (13, 45), (3, 100)]
    plan = [(e, s) for e in (1, 3, 5, 8, 10, 16) for s in shapes]
    plan += [(40, (50, 45)), (40, (20, 90))]  # eps above the 32-point tile
    worst = {}
    n = {"nsum2d": 0, "step2d": 0}
    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for prec in ("f32", "bf16"):
            for e, (nx, ny) in plan:
                upad = torch.tensor(rng.standard_normal((nx + 2 * e, ny + 2 * e)),
                                    dtype=dtype, device="cuda")
                u = upad[e:e + nx, e:e + ny].contiguous()
                g, lg = torch.randn_like(u), torch.randn_like(u)
                wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(e)))
                scale, dt = 2.0 + e, 0.8 / ((2.0 + e) * wsum)
                runs = [("nsum2d", lambda p: ck.nsum2d(upad, e, p),
                         lambda p: ck.nsum2d_plain(upad, e, p))]
                for kw in ({}, {"g": g, "lg": lg, "t": 7}):
                    runs.append(("step2d",
                                 lambda p, kw=kw: ck.step2d(u, e, scale, wsum, dt,
                                                            precision=p, **kw),
                                 lambda p, kw=kw: ck.step2d_plain(u, e, scale, wsum, dt,
                                                                  precision=p, **kw)))
                for name, kern, plain in runs:
                    a, b = kern(prec), plain(prec)
                    torch.cuda.synchronize()
                    ref = float(b.abs().max()) or 1.0
                    err = float((a - b).abs().max()) / ref
                    if not err <= tol:
                        fail(f"{name} {dtype} {prec} eps={e} {nx}x{ny}: rel err {err:.3e} "
                             f"> {tol:g}")
                    key = f"{name}/{str(dtype).split('.')[1]}/{prec}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    n[name] += 1
    # a CUDA tensor the kernel cannot take raises; it never falls back
    try:
        ck.nsum2d(torch.zeros(200, 200, device="cuda", dtype=torch.float64), 70)
        fail("nsum2d accepted eps=70 (beyond its shared-memory tile) on the card")
    except ValueError:
        pass
    say("kernel checks (max |kernel-plain| / max|plain|): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + f"; cases nsum2d {n['nsum2d']}, step2d {n['step2d']}: pass")
    return n


def rel_err(torch, got, ref) -> tuple:
    """(max|got - ref|, that over max|ref|), after a synchronize."""
    torch.cuda.synchronize()
    abs_err = float((got.double() - ref.double()).abs().max())
    return abs_err, abs_err / (float(ref.abs().max()) or 1.0)


def phase_multistep_checks(torch, ck, np) -> dict:
    """Phase 2, multi-step kernels: each against its plain version and,
    bitwise, against the same number of step2d launches.

    In the bf16 tier a kernel and its plain version sum in different orders,
    so after the first step their states differ in the last bits, and a value
    on a bfloat16 rounding boundary can round the other way: the next
    operand then differs by one bfloat16 ulp (2^-8 relative), passed on with
    the operator's gain dt*scale*wsum.  The tolerance there grows by that
    much per step after the first; the bitwise check against step2d is the
    exact one."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 1)
    shapes = [(1, 1), (37, 50), (64, 64), (13, 45), (3, 100), (70, 90)]
    plan = [(e, s) for e in (1, 3, 5, 8, 10, 16) for s in shapes]
    plan += [(40, (50, 45)), (60, (20, 90))]  # eps above the tile; about the largest in f64
    worst, n = {}, {"carried2d": 0, "superstep2d": 0, "resident2d": 0}

    def hold(name, form, got, plain, tol, bits):
        _abs, err = rel_err(torch, got, plain)
        if not torch.equal(got, bits):
            fail(f"{name} {form}: not bitwise equal to the same number of step2d launches")
        if not err <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {err:.3e} > {tol:.3e}")
        key = f"{name}/{form.split()[0]}/{form.split()[1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        n[name] += 1

    for dtype in (torch.float64, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for prec in ("f32", "bf16"):
            for e, (nx, ny) in plan:
                u = torch.tensor(rng.standard_normal((nx, ny)), dtype=dtype, device="cuda")
                wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(e)))
                scale, dt = 2.0 + e, 0.8 / ((2.0 + e) * wsum)
                flip = dt * scale * wsum * 2.0 ** -8 if prec == "bf16" else 0.0
                form = f"{str(dtype).split('.')[1]} {prec} eps={e} {nx}x{ny}"
                op = types.SimpleNamespace(eps=e, c=scale, dh=1.0, wsum=wsum, dt=dt,
                                           precision=prec)
                steps = [u]
                for _ in range(7):
                    steps.append(ck.step2d(steps[-1], e, scale, wsum, dt, precision=prec))
                # carried: three launches, the last against one plain step
                frame = F.pad(u, (e,) * 4).contiguous()
                pair = (frame, ck.shadow_of(frame) if prec == "bf16" else None)
                for _ in range(3):
                    prev = pair
                    res = ck.carried2d(pair[0], e, scale, wsum, dt, shadow=pair[1])
                    pair = res if prec == "bf16" else (res, None)
                plain = ck.carried2d_plain(prev[0], e, scale, wsum, dt, prev[1])
                bits = F.pad(steps[3], (e,) * 4)
                hold("carried2d", form, pair[0], plain[0] if prec == "bf16" else plain, tol,
                     bits)
                if prec == "bf16" and not torch.equal(pair[1], ck.shadow_of(pair[0])):
                    fail(f"carried2d {form}: the shadow is not the master's rounding")
                # superstep: one launch at each K it takes, and 7 steps at K=3 (3+3+1)
                for k in (1, 2, 3, 4):
                    if ck.fits_superstep(nx, ny, e, k, dtype, prec):
                        hold("superstep2d", f"{form} K={k}",
                             ck.superstep2d(u, e, scale, wsum, dt, k, prec),
                             ck.superstep2d_plain(u, e, scale, wsum, dt, k, prec),
                             tol + (k - 1) * flip, steps[k])
                if ck.fits_superstep(nx, ny, e, 3, dtype, prec):
                    hold("superstep2d", f"{form} 7 steps K=3",
                         ck.make_superstep_multi_step_fn(op, 7, ksteps=3)(u, 0),
                         ck.superstep2d_plain(u, e, scale, wsum, dt, 7, prec),
                         tol + 6 * flip, steps[7])
                # resident: the whole run in one launch (no bf16 tier)
                if prec == "f32" and ck.fits_resident(nx, ny, e, dtype):
                    for k in (1, 2, 5):
                        hold("resident2d", f"{form} {k} steps",
                             ck.resident2d(u, e, scale, wsum, dt, k),
                             ck.resident2d_plain(u, e, scale, wsum, dt, k), tol, steps[k])
    try:  # a grid beyond the gate raises, naming the kernel; nothing falls back
        ck.resident2d(torch.zeros(NX, NX, device="cuda"), EPS, 1.0, 197.0, 1e-3, 2)
        fail(f"resident2d accepted a {NX}^2 grid, beyond its gate, on the card")
    except ValueError as e:
        if "resident kernel" not in str(e):
            fail(f"resident2d's refusal does not name the kernel: {e}")
    say("multi-step kernel checks (max |kernel-plain| / max|plain|; every case bitwise "
        "equal to step2d launches): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + f"; cases carried2d {n['carried2d']}, superstep2d {n['superstep2d']}, resident2d "
        f"{n['resident2d']}; resident2d refuses {NX}^2: pass")
    return n


def phase_checks_3d(torch, k3, np) -> dict:
    """Phase 2, the 3D kernels: nsum3d and step3d (production and test form)
    in float64, float32 and the bf16 operand tier against their plain
    versions; carried3d and resident3d (no bf16 tier) against theirs and,
    bitwise, against the same number of step3d launches (carried3d after
    each of 3 launches, resident3d over 1, 2 and 5 steps); eps in
    {1, 2, 3, 4, 6, 8} over ragged shapes (1x1x1, non tile multiples,
    n < 2*eps, nx != ny != nz).  resident3d at 256^3, eps=4 must raise
    ValueError, and nsum3d beyond its eps limit too."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.ops.stencil import horizon_mask_3d

    rng = np.random.default_rng(SEED + 3)
    shapes = [(1, 1, 1), (5, 7, 9), (9, 17, 33), (3, 12, 40), (20, 11, 6)]
    plan = [(e, s) for e in (1, 2, 3, 4, 6, 8) for s in shapes]
    worst, n = {}, dict.fromkeys(("nsum3d", "step3d", "carried3d", "resident3d"), 0)

    def hold(name, form, got, plain, tol, bits=None):
        _abs, err = rel_err(torch, got, plain)
        if bits is not None and not torch.equal(got, bits):
            fail(f"{name} {form}: not bitwise equal to the same number of step3d launches")
        if not err <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {err:.3e} > {tol:g}")
        key = f"{name}/{form.split()[0]}/{form.split()[1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        n[name] += 1

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for e, (nx, ny, nz) in plan:
            wsum = float(horizon_mask_3d(e).sum())
            scale, dt = 2.0 + e, 0.8 / ((2.0 + e) * wsum)
            upad = torch.tensor(rng.standard_normal((nx + 2 * e, ny + 2 * e, nz + 2 * e)),
                                dtype=dtype, device="cuda")
            u = upad[e:e + nx, e:e + ny, e:e + nz].contiguous()
            g, lg = torch.randn_like(u), torch.randn_like(u)
            for prec in ("f32", "bf16"):
                form = f"{dname} {prec} eps={e} {nx}x{ny}x{nz}"
                hold("nsum3d", form, k3.nsum3d(upad, e, prec), k3.nsum3d_plain(upad, e, prec),
                     tol)
                for kw in ({}, {"g": g, "lg": lg, "t": 7}):
                    hold("step3d", form + (" test form" if kw else ""),
                         k3.step3d(u, e, scale, wsum, dt, precision=prec, **kw),
                         k3.step3d_plain(u, e, scale, wsum, dt, precision=prec, **kw), tol)
            # the multi-step kernels (no bf16 tier) against one chain of plain
            # frame steps from u and, bitwise, against step3d launches
            form = f"{dname} f32 eps={e} {nx}x{ny}x{nz}"
            steps, plain = [u], [F.pad(u, (e,) * 6)]
            for _ in range(5):
                steps.append(k3.step3d(steps[-1], e, scale, wsum, dt))
                plain.append(k3.carried3d_plain(plain[-1], e, scale, wsum, dt))
            frame = plain[0].contiguous()
            for s in range(1, 4):
                frame = k3.carried3d(frame, e, scale, wsum, dt)
                hold("carried3d", f"{form} launch {s}", frame, plain[s], tol,
                     F.pad(steps[s], (e,) * 6))
            if k3.fits_resident_3d(nx, ny, nz, e, dtype):
                for k in (1, 2, 5):
                    hold("resident3d", f"{form} {k} steps", k3.resident3d(u, e, scale, wsum, dt, k),
                         plain[k][e:e + nx, e:e + ny, e:e + nz], tol, steps[k])
    if not n["resident3d"]:
        fail("resident3d took none of the phase-2 grids")
    try:  # a grid beyond the gate raises, naming the kernel; nothing falls back
        k3.resident3d(torch.zeros(N3, N3, N3, device="cuda"), EPS3, 1.0, 257.0, 1e-3, 2)
        fail(f"resident3d accepted {N3}^3 eps={EPS3} f32, beyond its gate, on the card")
    except ValueError as e:
        if "resident 3D kernel" not in str(e):
            fail(f"resident3d's refusal does not name the kernel: {e}")
    try:
        k3.nsum3d(torch.zeros(30, 30, 30, device="cuda", dtype=torch.float64), 13)
        fail("nsum3d accepted eps=13 (beyond its shared-memory tile) on the card")
    except ValueError:
        pass
    say("3D kernel checks (max |kernel-plain| / max|plain|; carried3d and resident3d every "
        "case bitwise equal to step3d launches): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + "; cases " + ", ".join(f"{k} {v}" for k, v in n.items())
        + f"; resident3d refuses {N3}^3 eps={EPS3}: pass")
    return n


CLI_ARGS = ["--test_batch", "--platform", "gpu", "--x64", "1"]


def batch_text(rows) -> str:
    """A batch table as the CLIs read it on stdin."""
    return f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)


def start_cli(module: str, rows, extra=()) -> subprocess.Popen:
    """Start a port CLI's batch mode on the card in float64 with ``rows`` as
    its stdin (a temporary file, so the CLIs run side by side)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryFile("w+") as stdin:
        stdin.write(batch_text(rows))
        stdin.seek(0)
        return subprocess.Popen([sys.executable, "-m", module, *CLI_ARGS, *extra], cwd=ROOT,
                                env=env, stdin=stdin, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


def start_clis(cases_2d, cases_1d) -> tuple:
    """Phase 3's batch tables through the CLIs (CASES_2D, CASES_1D, CASES_3D,
    float64), and CASES_1D and CASES_3D through the ensemble engine
    (``--ensemble``; the 2D table runs it in phase 6, counted), started right
    after the build so that they run beside phase 2; (jobs, start time).
    Any still running at exit are stopped."""
    jobs = {}
    for name, rows, extra in (("solve2d", cases_2d, ()), ("solve1d", cases_1d, ()),
                              ("solve3d", CASES_3D, ()),
                              ("solve1d", cases_1d, ("--ensemble",)),
                              ("solve3d", CASES_3D, ("--ensemble",))):
        proc = start_cli(f"nonlocalheatequation_torch.cli.{name}", rows, extra)
        CHILDREN.append(proc)
        jobs[" ".join((name, *extra))] = (rows, proc)
    return jobs, time.perf_counter()


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_main_path_tables(torch, clis, cases_2d, l2_threshold):
    """Phase 3: the CLIs' batch tables (f64) must print "Tests Passed", then
    CASES_2D and CASES_3D in f32 through Solver2D and Solver3D."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D

    jobs, t0 = clis
    for name, (rows, proc) in jobs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0 or "Tests Passed" not in out:
            fail(f"{name} --test_batch --platform gpu --x64 1: rc {proc.returncode}\n"
                 f"{out}\n{err[-4000:]}")
        summary = [line for line in err.splitlines() if line.startswith("ensemble: ")]
        say(f"cli {name} --test_batch --platform gpu --x64 1: Tests Passed ({len(rows)} rows)"
            + (f"; {summary[-1]}" if summary else ""))
    say(f"cli wall (beside phase 2): {time.perf_counter() - t0:.1f} s")
    worst = 0.0
    for nx, ny, nt, eps, k, dt, dh in cases_2d:
        s = Solver2D(nx, ny, nt, eps, k=k, dt=dt, dh=dh, dtype=torch.float32, device="cuda")
        s.test_init()
        s.do_work()
        worst = max(worst, s.error_l2 / (nx * ny))
    if not worst <= l2_threshold:
        fail(f"CASES_2D in float32: error_l2/#points {worst:.3e} > {l2_threshold:g}")
    say(f"CASES_2D float32 through Solver2D (cuda): largest error_l2/#points {worst:.3e} "
        f"<= {l2_threshold:g}")
    worst = 0.0
    for nx, ny, nz, nt, eps, k, dt, dh in CASES_3D:
        s = Solver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, dtype=torch.float32,
                     device="cuda")
        s.test_init()
        s.do_work()
        worst = max(worst, s.error_l2 / (nx * ny * nz))
    if not worst <= l2_threshold:
        fail(f"CASES_3D in float32: error_l2/#points {worst:.3e} > {l2_threshold:g}")
    say(f"CASES_3D float32 through Solver3D (cuda): largest error_l2/#points {worst:.3e} "
        f"<= {l2_threshold:g}")


def phase_headline(torch, np, ck, l2_threshold) -> list:
    """Phase 4: kernel timings at the headline shape, then the main path."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        NonlocalOp2D,
        case_scale,
        full_fp32,
        make_multi_step_fn,
    )
    from nonlocalheatequation_torch.utils import autotune

    dh = 1.0 / NX
    probe = NonlocalOp2D(EPS, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)  # 0.8x the Euler bound, as bench.py
    op = NonlocalOp2D(EPS, 1.0, dt, dh, method="cuda")
    scale, wsum = case_scale(op), op.wsum
    u0 = np.random.default_rng(SEED).standard_normal((NX, NX))
    u = torch.as_tensor(u0, device="cuda").to(torch.float32)
    upad = F.pad(u, (EPS,) * 4)
    out = torch.empty_like(u)
    g, lg = torch.randn_like(u), torch.randn_like(u)
    isz, npts = 4, NX * NX

    # every form at the main path's shape against its plain version
    held = {k: [] for k in ck.LAUNCHES}

    def hold(name, form, got, ref, tol):
        torch.cuda.synchronize()
        abs_err = float((got - ref).abs().max())
        rel = abs_err / (float(ref.abs().max()) or 1.0)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form} at {NX}^2 eps={EPS}: |kernel-plain| / max|plain| "
                 f"{rel:.3e} > {tol:g}")

    tol32 = TOL["float32"]
    for prec in ("f32", "bf16"):
        hold("nsum2d", f"float32 {prec}", ck.nsum2d(upad, EPS, prec),
             ck.nsum2d_plain(upad, EPS, prec), tol32)
        hold("step2d", f"float32 {prec} production",
             ck.step2d(u, EPS, scale, wsum, dt, precision=prec),
             ck.step2d_plain(u, EPS, scale, wsum, dt, precision=prec), tol32)
        hold("step2d", f"float32 {prec} test form",
             ck.step2d(u, EPS, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec),
             ck.step2d_plain(u, EPS, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec), tol32)
    gpad = F.pad(torch.as_tensor(op.spatial_profile(NX, NX), device="cuda"), (EPS,) * 4)
    hold("nsum2d", "float64 f32 (padded G, the test-form source's input)",
         ck.nsum2d(gpad, EPS), ck.nsum2d_plain(gpad, EPS), TOL["float64"])
    del gpad
    say(f"kernels at the main path's shape {NX}^2 eps={EPS} "
        "(|kernel-plain| / max|plain|): "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e} <= {c['tol']:g}"
                    for n, cs in held.items() for c in cs))

    # the test-form source's set-up: (G, L(G)) on the card, as Solver2D makes
    # it (L(G) through nsum2d in float64), against NumPy float64 (the
    # oracle's way); both sum the same 197 terms in other orders, and L(G)
    # cancels them, so the tolerance is relative to the terms' size
    t0 = time.perf_counter()
    g_np, lg_np = op.source_parts(NX, NX)
    src_np_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _g_dev, lg_dev = op.source_parts_on(NX, NX, "cuda")
    torch.cuda.synchronize()
    src_dev_s = time.perf_counter() - t0
    terms = scale * wsum * float(np.abs(g_np).max())
    src_err = float(np.abs(lg_dev.cpu().numpy() - lg_np).max()) / terms
    if not src_err <= TOL["float64"]:
        fail(f"L(G) on the card vs NumPy at {NX}^2: {src_err:.3e} of the terms' size > "
             f"{TOL['float64']:g}")
    del g_np, lg_np, _g_dev, lg_dev
    say(f"test-form source set-up (G, L(G)) float64 {NX}^2 eps={EPS}: on the card "
        f"(Solver2D, nsum2d) {src_dev_s:.4f} s, NumPy (oracle) {src_np_s:.4f} s; "
        f"|card-NumPy| / (scale*wsum*max|G|) {src_err:.2e} <= {TOL['float64']:g}")

    step_ms = cuda_ms(torch, lambda: ck.step2d(u, EPS, scale, wsum, dt, out=out), 200)
    step_test_ms = cuda_ms(torch, lambda: ck.step2d(u, EPS, scale, wsum, dt, g=g, lg=lg,
                                                    t=3, out=out), 200)
    step_plain_ms = cuda_ms(torch, lambda: ck.step2d_plain(u, EPS, scale, wsum, dt), 5, 1)
    nsum_ms = cuda_ms(torch, lambda: ck.nsum2d(upad, EPS), 200)
    nsum_plain_ms = cuda_ms(torch, lambda: ck.nsum2d_plain(upad, EPS), 5, 1)
    kern = torch.as_tensor(op.weights, dtype=torch.float32, device="cuda")[None, None]
    with full_fp32():
        conv_ms = cuda_ms(torch, lambda: F.conv2d(upad[None, None], kern), 20)
        conv_out = F.conv2d(upad[None, None], kern)[0, 0]
    conv_err = float((conv_out - ck.nsum2d_plain(upad, EPS)).abs().max())
    # epilogue: 5 operations for u + dt*(scale*(nsum - wsum*u)), 4 more for the
    # test form's source terms
    nsum_bound = bound(((NX + 2 * EPS) ** 2 + npts) * isz, npts * kernel_ops(EPS, 0))
    step_bound = bound(2 * npts * isz, npts * kernel_ops(EPS, 5))
    step_test_bound = bound(4 * npts * isz, npts * kernel_ops(EPS, 9))
    say("TF32 disabled for the F.conv2d yardstick (cudnn.allow_tf32=False, "
        "cuda.matmul.allow_tf32=False)")
    say(f"nsum2d {NX}^2 eps={EPS} f32: kernel {nsum_ms:.4f} ms, plain {nsum_plain_ms:.3f} ms, "
        f"F.conv2d {conv_ms:.4f} ms (max abs diff to plain {conv_err:.2e}), "
        f"bound {nsum_bound[0]:.4f} ms ({nsum_bound[1]})")
    say(f"step2d {NX}^2 eps={EPS} f32 production: kernel {step_ms:.4f} ms, "
        f"plain {step_plain_ms:.3f} ms, bound {step_bound[0]:.4f} ms ({step_bound[1]})")
    say(f"step2d {NX}^2 eps={EPS} f32 test form: kernel {step_test_ms:.4f} ms, "
        f"bound {step_test_bound[0]:.4f} ms ({step_test_bound[1]})")

    # the multi-step kernels at the main path's shape: against their plain
    # versions, and bitwise against step2d launches
    bits = [u]
    for _ in range(3):
        bits.append(ck.step2d(bits[-1], EPS, scale, wsum, dt))
    frame = F.pad(u, (EPS,) * 4).contiguous()
    fout = torch.empty_like(frame)
    hold("carried2d", "float32 f32 one launch", ck.carried2d(frame, EPS, scale, wsum, dt),
         ck.carried2d_plain(frame, EPS, scale, wsum, dt), tol32)
    shadow = ck.shadow_of(frame)
    hold("carried2d", "float32 bf16 one launch",
         ck.carried2d(frame, EPS, scale, wsum, dt, shadow=shadow)[0],
         ck.carried2d_plain(frame, EPS, scale, wsum, dt, shadow)[0], tol32)
    del shadow
    bitwise = {"carried2d 3 steps": torch.equal(
        ck.make_carried_multi_step_fn(op, 3)(u, 0), bits[3])}
    for k in (2, 3):
        got = ck.superstep2d(u, EPS, scale, wsum, dt, k)
        hold("superstep2d", f"float32 f32 K={k}", got,
             ck.superstep2d_plain(u, EPS, scale, wsum, dt, k), tol32)
        bitwise[f"superstep2d K={k}"] = torch.equal(got, bits[k])
    del bits, got
    if not all(bitwise.values()):
        fail(f"multi-step kernels at {NX}^2 eps={EPS}: bitwise equal to step2d launches "
             f"{bitwise}")
    say(f"multi-step kernels at {NX}^2 eps={EPS}: bitwise equal to step2d launches "
        f"{json.dumps(bitwise)}; |kernel-plain| / max|plain| "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e}" for n in ("carried2d", "superstep2d")
                    for c in held[n]))

    carried_ms = cuda_ms(torch, lambda: ck.carried2d(frame, EPS, scale, wsum, dt, out=fout),
                         200)
    carried_plain_ms = cuda_ms(torch, lambda: ck.carried2d_plain(frame, EPS, scale, wsum, dt),
                               5, 1)
    sup_ms = {k: cuda_ms(torch, lambda k=k: ck.superstep2d(u, EPS, scale, wsum, dt, k,
                                                           out=out), 100) for k in (2, 3)}
    sup_plain_ms = {k: cuda_ms(torch, lambda k=k: ck.superstep2d_plain(u, EPS, scale, wsum,
                                                                       dt, k), 3, 1)
                    for k in (2, 3)}
    # bounds: one frame read and one written per launch; K levels of the
    # step's operations for a K-step launch
    carried_bound = bound(2 * frame.numel() * isz, npts * kernel_ops(EPS, 5))
    sup_bound = {k: bound(2 * npts * isz, k * npts * kernel_ops(EPS, 5)) for k in (2, 3)}
    say(f"carried2d {NX}^2 eps={EPS} f32: kernel {carried_ms:.4f} ms/launch (one step), "
        f"plain {carried_plain_ms:.3f} ms, bound {carried_bound[0]:.4f} ms "
        f"({carried_bound[1]})")
    for k in (2, 3):
        say(f"superstep2d {NX}^2 eps={EPS} f32 K={k}: kernel {sup_ms[k]:.4f} ms/launch "
            f"({sup_ms[k] / k:.4f} ms/step), plain {sup_plain_ms[k]:.3f} ms, bound "
            f"{sup_bound[k][0]:.4f} ms ({sup_bound[k][1]})")
    del frame, fout
    big = time_variants(torch, op, u, VARIANT_STEPS)
    fits_big = ck.fits_resident(NX, NX, EPS, torch.float32)
    say(f"multi-step candidates {NX}^2 eps={EPS} f32, {VARIANT_STEPS}-step runs (CUDA events), "
        f"ms/step: {json.dumps(big)}; resident2d "
        + ("fits" if fits_big else "does not fit (its two frames exceed the card's L2)"))

    # the small production grid, where the whole run fits the resident kernel
    dh_s = 1.0 / SMALL
    probe_s = NonlocalOp2D(EPS, 1.0, 1.0, dh_s)
    dt_s = 0.8 / (probe_s.c * dh_s * dh_s * probe_s.wsum)
    op_s = NonlocalOp2D(EPS, 1.0, dt_s, dh_s, method="cuda")
    scale_s, npts_s = case_scale(op_s), SMALL * SMALL
    us0 = np.random.default_rng(SEED + 2).standard_normal((SMALL, SMALL))
    us = torch.as_tensor(us0, device="cuda").to(torch.float32)
    if not ck.fits_resident(SMALL, SMALL, EPS, torch.float32):
        fail(f"resident2d does not fit {SMALL}^2 eps={EPS} f32 on this card")
    ref = us
    for _ in range(TEST_STEPS):
        ref = ck.step2d(ref, EPS, scale_s, wsum, dt_s)
    got = ck.resident2d(us, EPS, scale_s, wsum, dt_s, TEST_STEPS)
    hold("resident2d", f"float32 f32 {SMALL}^2 {TEST_STEPS} steps", got,
         ck.resident2d_plain(us, EPS, scale_s, wsum, dt_s, TEST_STEPS), tol32)
    if not torch.equal(got, ref):
        fail(f"resident2d at {SMALL}^2: not bitwise equal to {TEST_STEPS} step2d launches")
    small = time_variants(torch, op_s, us, STEPS)
    res_ms = cuda_ms(torch, lambda: ck.resident2d(us, EPS, scale_s, wsum, dt_s, STEPS), 3, 1)
    res_plain_ms = cuda_ms(torch, lambda: ck.resident2d_plain(us, EPS, scale_s, wsum, dt_s,
                                                              STEPS), 1, 0)
    res_bound = bound(2 * npts_s * isz, STEPS * npts_s * kernel_ops(EPS, 5))
    say(f"resident2d {SMALL}^2 eps={EPS} f32, {STEPS} steps in one launch: kernel "
        f"{res_ms:.4f} ms/launch ({res_ms / STEPS:.5f} ms/step), plain {res_plain_ms:.1f} ms, "
        f"bound {res_bound[0]:.4f} ms ({res_bound[1]}); |kernel-plain| / max|plain| "
        f"{held['resident2d'][0]['rel_err']:.2e}, bitwise equal to {TEST_STEPS} step2d launches")
    say(f"multi-step candidates {SMALL}^2 eps={EPS} f32, {STEPS}-step runs (CUDA events), "
        f"ms/step: {json.dumps(small)}")
    small_kernel_ms = kernels_alone(torch, ck, us, EPS, scale_s, wsum, dt_s)
    say(f"kernels alone at {SMALL}^2 eps={EPS} f32 (a CUDA graph of {GRAPH_LAUNCHES} launches "
        f"replayed, CUDA events), ms/launch: {json.dumps(small_kernel_ms)}")

    multi = make_multi_step_fn(op, STEPS, dtype=torch.float32)
    multi(u, 0)  # the first call tunes the shape and runs the winner
    loop_ms = cuda_ms(torch, lambda: multi(u, 0), 1, 0) / STEPS
    say(f"headline {NX}^2 eps={EPS} f32, {STEPS} steps (make_multi_step_fn, tuned, CUDA "
        f"events): {loop_ms:.4f} ms/step, {npts / (loop_ms * 1e-3):.4e} points*steps/s; "
        f"byte bound {2 * npts * isz / HBM_BYTES_PER_S * 1e3:.4f} ms/step")
    say(f"clocks/power after timing: {nvidia_smi('clocks.sm,power.draw,power.limit')}")

    # the main path, through the solver entry points, counted: a first
    # production call per shape tunes it (every fitting candidate runs its
    # probe program) and then runs the winner
    autotune.reset()
    ck.reset_launch_counts()
    walls = {}
    for n, x0, step_dt, step_dh in ((NX, u0, dt, dh), (SMALL, us0, dt_s, dh_s)):
        s = Solver2D(n, n, STEPS, EPS, k=1.0, dt=step_dt, dh=step_dh, method="cuda",
                     dtype=torch.float32, device="cuda")
        s.input_init(x0)
        t0 = time.perf_counter()
        res = s.do_work()
        walls[n] = time.perf_counter() - t0
        if res.shape != (n, n) or not np.isfinite(res).all():
            fail(f"production solve {n}^2: result not finite or of the wrong shape")
        if not float(np.abs(res).max()) <= float(np.abs(x0).max()):
            fail(f"production solve {n}^2: the free decay grew (max|u| rose)")
    st = Solver2D(NX, NX, TEST_STEPS, EPS, k=1.0, dt=dt, dh=dh, method="cuda",
                  dtype=torch.float32, device="cuda")
    st.test_init()
    st.do_work()
    counts = {k: v for k, v in ck.launch_counts().items()
              if k.endswith("2d") and not k.startswith(("batched_", "split_", "fused_"))}
    recs = autotune.records()
    test_err = st.error_l2 / (NX * NX)
    if len(recs) != 2:
        fail(f"the production solves tuned {len(recs)} shapes, not 2: {sorted(recs)}")
    expected = dict.fromkeys(counts, 0)
    expected["step2d"] = TEST_STEPS
    for entry in recs.values():
        for name in entry["ms_per_step"]:
            kernel, k = variant_launches(name, autotune.PROBE_STEPS)
            expected[kernel] += (1 + autotune.PROBE_ITERS) * k
        kernel, k = variant_launches(entry["winner"], STEPS)
        expected[kernel] += k
    wrong = {k: (counts[k], expected[k]) for k in counts
             if k != "nsum2d" and counts[k] != expected[k]}
    if wrong:
        fail(f"main-path launches (got, expected from the probes and the winners): {wrong}")
    if not all(counts.values()):
        fail(f"a kernel of the main path was not launched: {json.dumps(counts)}")
    if not test_err <= l2_threshold:
        fail(f"test-form headline solve: error_l2/#points {test_err:.3e} > {l2_threshold:g}")
    say(f"tuner records: {json.dumps(recs)}")
    winner = {n: recs[autotune.tuning_key(o, (n, n), torch.float32, "cuda")]["winner"]
              for n, o in ((NX, op), (SMALL, op_s))}
    say(f"main path: Solver2D eps={EPS} f32 method=cuda production solves of {STEPS} steps, "
        f"tuned, at {NX}^2 (winner {winner[NX]}, do_work wall {walls[NX]:.3f} s incl. tuning "
        f"and host<->device copies) and {SMALL}^2 (winner {winner[SMALL]}, "
        f"{walls[SMALL]:.3f} s) + {TEST_STEPS} test-form steps at {NX}^2 (error_l2/#points "
        f"{test_err:.3e}); launches {json.dumps(counts)} = the probes' and the winners'")

    def row(name, source, line, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_kernel.py:{line}", **kw,
                "launches": counts[name], "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs)}

    no_call = "no one PyTorch call takes Euler steps"
    return [
        {**row("nsum2d", "nsum2d.cu", 468),
         "ms": nsum_ms, "plain_ms": nsum_plain_ms, "bound_ms": nsum_bound[0],
         "bound_by": nsum_bound[1], "library_ms": conv_ms},
        {**row("step2d", "nsum2d.cu", 515),
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None, "library_note": no_call,
         "ms_512_graph": small_kernel_ms["step2d"]},
        {**row("carried2d", "carried2d.cu", 856),
         "ms": carried_ms, "plain_ms": carried_plain_ms, "bound_ms": carried_bound[0],
         "bound_by": carried_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{NX}^2", "ms_512_graph": small_kernel_ms["carried2d"]},
        {**row("superstep2d", "superstep2d.cu", 1032),
         "ms": sup_ms[3], "plain_ms": sup_plain_ms[3], "bound_ms": sup_bound[3][0],
         "bound_by": sup_bound[3][1], "library_ms": None, "library_note": no_call,
         "shape": f"{NX}^2", "ksteps": 3, "ms_k2": sup_ms[2], "bound_ms_k2": sup_bound[2][0],
         "ms_512_graph": small_kernel_ms["superstep2d K=3"],
         "ms_512_graph_k2": small_kernel_ms["superstep2d K=2"]},
        {**row("resident2d", "resident2d.cu", 1292),
         "ms": res_ms, "plain_ms": res_plain_ms, "bound_ms": res_bound[0],
         "bound_by": res_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{SMALL}^2", "steps_per_launch": STEPS},
    ]


def op_3d(n: int, eps: int):
    """The 3D operator on an n^3 unit cube (dh = 1/n) at 0.8x the Euler bound."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp3D

    dh = 1.0 / n
    probe = NonlocalOp3D(eps, 1.0, 1.0, dh)
    return NonlocalOp3D(eps, 1.0, 0.8 / (probe.c * dh**3 * probe.wsum), dh, method="cuda")


def phase_headline_3d(torch, np, ck, k3, l2_threshold) -> list:
    """Phase 4, the 3D path: the kernels at 256^3, eps=4 (held to their plain
    versions, timed beside them, their bound and F.conv3d), the tuner's
    candidates at 256^3 and at 128^3, eps=6 (where resident3d fits), then
    the main path through Solver3D, counted."""
    import torch.nn.functional as F

    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.ops.nonlocal_op import case_scale, full_fp32
    from nonlocalheatequation_torch.utils import autotune

    op = op_3d(N3, EPS3)
    scale, wsum, dt = case_scale(op), op.wsum, op.dt
    u0 = np.random.default_rng(SEED + 4).standard_normal((N3,) * 3)
    u = torch.as_tensor(u0, device="cuda").to(torch.float32)
    upad = F.pad(u, (EPS3,) * 6)
    out = torch.empty_like(u)
    g, lg = torch.randn_like(u), torch.randn_like(u)
    isz, npts, tol32 = 4, N3 ** 3, TOL["float32"]
    tp = k3.tile3d(EPS3, torch.float32)
    held = {k: [] for k in ("nsum3d", "step3d", "carried3d", "resident3d")}

    def hold(name, form, got, ref, tol):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol:g}")

    for prec in ("f32", "bf16"):
        hold("nsum3d", f"float32 {prec} {N3}^3", k3.nsum3d(upad, EPS3, prec),
             k3.nsum3d_plain(upad, EPS3, prec), tol32)
        hold("step3d", f"float32 {prec} production {N3}^3",
             k3.step3d(u, EPS3, scale, wsum, dt, precision=prec),
             k3.step3d_plain(u, EPS3, scale, wsum, dt, precision=prec), tol32)
        hold("step3d", f"float32 {prec} test form {N3}^3",
             k3.step3d(u, EPS3, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec),
             k3.step3d_plain(u, EPS3, scale, wsum, dt, g=g, lg=lg, t=3, precision=prec), tol32)
    gpad = F.pad(torch.as_tensor(op.spatial_profile(N3, N3, N3), device="cuda"), (EPS3,) * 6)
    hold("nsum3d", f"float64 f32 {N3}^3 (padded G, the test-form source's input)",
         k3.nsum3d(gpad, EPS3), k3.nsum3d_plain(gpad, EPS3), TOL["float64"])
    del gpad
    bits = [u]
    for _ in range(3):
        bits.append(k3.step3d(bits[-1], EPS3, scale, wsum, dt))
    frame = F.pad(u, (EPS3,) * 6).contiguous()
    fout = torch.empty_like(frame)
    hold("carried3d", f"float32 f32 {N3}^3 one launch", k3.carried3d(frame, EPS3, scale, wsum, dt),
         k3.carried3d_plain(frame, EPS3, scale, wsum, dt), tol32)
    if not torch.equal(k3.make_carried_multi_step_fn_3d(op, 3)(u, 0), bits[3]):
        fail(f"carried3d at {N3}^3: 3 launches not bitwise equal to 3 step3d launches")
    del bits
    say(f"3D kernels at the main path's shape {N3}^3 eps={EPS3} (plane tile {tp}; "
        "|kernel-plain| / max|plain|): "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e} <= {c['tol']:g}"
                    for n, cs in held.items() for c in cs)
        + "; carried3d 3 launches bitwise equal to 3 step3d launches")

    nsum_ms = cuda_ms(torch, lambda: k3.nsum3d(upad, EPS3), 50)
    nsum_plain_ms = cuda_ms(torch, lambda: k3.nsum3d_plain(upad, EPS3), 3, 1)
    step_ms = cuda_ms(torch, lambda: k3.step3d(u, EPS3, scale, wsum, dt, out=out), 50)
    step_plain_ms = cuda_ms(torch, lambda: k3.step3d_plain(u, EPS3, scale, wsum, dt), 3, 1)
    step_test_ms = cuda_ms(torch, lambda: k3.step3d(u, EPS3, scale, wsum, dt, g=g, lg=lg, t=3,
                                                    out=out), 50)
    step_test_plain_ms = cuda_ms(torch, lambda: k3.step3d_plain(u, EPS3, scale, wsum, dt, g=g,
                                                                lg=lg, t=3), 3, 1)
    carried_ms = cuda_ms(torch, lambda: k3.carried3d(frame, EPS3, scale, wsum, dt, out=fout), 50)
    carried_plain_ms = cuda_ms(torch, lambda: k3.carried3d_plain(frame, EPS3, scale, wsum, dt),
                               3, 1)
    kern = torch.as_tensor(op.weights, dtype=torch.float32, device="cuda")[None, None]
    with full_fp32():
        conv_ms = cuda_ms(torch, lambda: F.conv3d(upad[None, None], kern), 5, 1)
        conv_out = F.conv3d(upad[None, None], kern)[0, 0]
    conv_err = float((conv_out - k3.nsum3d_plain(upad, EPS3)).abs().max())
    del conv_out, kern
    # epilogue: 5 operations for u + dt*(scale*(nsum - wsum*u)), 4 more for the
    # test form's source terms
    nsum_bound = bound((upad.numel() + npts) * isz, npts * kernel_ops_3d(EPS3, tp, 0))
    step_bound = bound(2 * npts * isz, npts * kernel_ops_3d(EPS3, tp, 5))
    step_test_bound = bound(4 * npts * isz, npts * kernel_ops_3d(EPS3, tp, 9))
    carried_bound = bound(2 * frame.numel() * isz, npts * kernel_ops_3d(EPS3, tp, 5))
    say("TF32 disabled for the F.conv3d yardstick (cudnn.allow_tf32=False, "
        "cuda.matmul.allow_tf32=False)")
    say(f"nsum3d {N3}^3 eps={EPS3} f32: kernel {nsum_ms:.4f} ms, plain {nsum_plain_ms:.3f} ms, "
        f"F.conv3d {conv_ms:.4f} ms (max abs diff to plain {conv_err:.2e}), "
        f"bound {nsum_bound[0]:.4f} ms ({nsum_bound[1]})")
    say(f"step3d {N3}^3 eps={EPS3} f32 production: kernel {step_ms:.4f} ms, "
        f"plain {step_plain_ms:.3f} ms, bound {step_bound[0]:.4f} ms ({step_bound[1]})")
    say(f"step3d {N3}^3 eps={EPS3} f32 test form: kernel {step_test_ms:.4f} ms, "
        f"plain {step_test_plain_ms:.3f} ms, bound {step_test_bound[0]:.4f} ms "
        f"({step_test_bound[1]})")
    say(f"carried3d {N3}^3 eps={EPS3} f32: kernel {carried_ms:.4f} ms/launch (one step), "
        f"plain {carried_plain_ms:.3f} ms, bound {carried_bound[0]:.4f} ms "
        f"({carried_bound[1]})")
    del frame, fout, upad
    big = time_variants(torch, op, u, STEPS3)
    say(f"3D multi-step candidates {N3}^3 eps={EPS3} f32, {STEPS3}-step runs (CUDA events), "
        f"ms/step: {json.dumps(big)}; resident3d "
        + ("fits" if k3.fits_resident_3d(N3, N3, N3, EPS3, torch.float32)
           else "does not fit (its two frames exceed the card's L2)"))

    # the small 3D grid, where the whole run fits the resident kernel
    op_s = op_3d(N3S, EPS3S)
    scale_s, wsum_s, dt_s, npts_s = case_scale(op_s), op_s.wsum, op_s.dt, N3S ** 3
    tp_s = k3.tile3d(EPS3S, torch.float32)
    us0 = np.random.default_rng(SEED + 5).standard_normal((N3S,) * 3)
    us = torch.as_tensor(us0, device="cuda").to(torch.float32)
    if not k3.fits_resident_3d(N3S, N3S, N3S, EPS3S, torch.float32):
        fail(f"resident3d does not fit {N3S}^3 eps={EPS3S} f32 on this card")
    ref = us
    for _ in range(TEST_STEPS):
        ref = k3.step3d(ref, EPS3S, scale_s, wsum_s, dt_s)
    got = k3.resident3d(us, EPS3S, scale_s, wsum_s, dt_s, TEST_STEPS)
    hold("resident3d", f"float32 f32 {N3S}^3 eps={EPS3S} {TEST_STEPS} steps", got,
         k3.resident3d_plain(us, EPS3S, scale_s, wsum_s, dt_s, TEST_STEPS), tol32)
    if not torch.equal(got, ref):
        fail(f"resident3d at {N3S}^3: not bitwise equal to {TEST_STEPS} step3d launches")
    small = time_variants(torch, op_s, us, STEPS3)
    # one launch of TEST_STEPS steps, beside the plain version's same steps
    res_ms = cuda_ms(torch, lambda: k3.resident3d(us, EPS3S, scale_s, wsum_s, dt_s, TEST_STEPS),
                     5, 1)
    res_plain_ms = cuda_ms(torch, lambda: k3.resident3d_plain(us, EPS3S, scale_s, wsum_s, dt_s,
                                                              TEST_STEPS), 1, 0)
    res_bound = bound(2 * npts_s * isz, TEST_STEPS * npts_s * kernel_ops_3d(EPS3S, tp_s, 5))
    outs = torch.empty_like(us)
    step_s_ms = cuda_ms(torch, lambda: k3.step3d(us, EPS3S, scale_s, wsum_s, dt_s, out=outs), 50)
    step_s_bound = bound(2 * npts_s * isz, npts_s * kernel_ops_3d(EPS3S, tp_s, 5))
    say(f"resident3d {N3S}^3 eps={EPS3S} f32 (plane tile {tp_s}), {TEST_STEPS} steps in one "
        f"launch: kernel {res_ms:.4f} ms/launch ({res_ms / TEST_STEPS:.5f} ms/step), plain "
        f"{res_plain_ms:.1f} "
        f"ms, bound {res_bound[0]:.4f} ms ({res_bound[1]}); "
        f"step3d there {step_s_ms:.4f} ms/launch, bound {step_s_bound[0]:.4f} ms "
        f"({step_s_bound[1]}); resident3d {TEST_STEPS} steps bitwise equal to step3d launches")
    say(f"3D multi-step candidates {N3S}^3 eps={EPS3S} f32, {STEPS3}-step runs (CUDA events), "
        f"ms/step: {json.dumps(small)}")
    say(f"clocks/power after the 3D timing: {nvidia_smi('clocks.sm,power.draw,power.limit')}")

    # the 3D main path, through the solver entry points, counted: a first
    # production call per shape tunes it and then runs the winner
    autotune.reset()
    ck.reset_launch_counts()
    walls = {}
    for n, x0, o in ((N3, u0, op), (N3S, us0, op_s)):
        s = Solver3D(n, n, n, STEPS3, o.eps, k=1.0, dt=o.dt, dh=o.dh, method="cuda",
                     dtype=torch.float32, device="cuda")
        s.input_init(x0)
        t0 = time.perf_counter()
        res = s.do_work()
        walls[n] = time.perf_counter() - t0
        if res.shape != (n, n, n) or not np.isfinite(res).all():
            fail(f"3D production solve {n}^3: result not finite or of the wrong shape")
        if not float(np.abs(res).max()) <= float(np.abs(x0).max()):
            fail(f"3D production solve {n}^3: the free decay grew (max|u| rose)")
    st = Solver3D(N3, N3, N3, TEST_STEPS, EPS3, k=1.0, dt=dt, dh=op.dh, method="cuda",
                  dtype=torch.float32, device="cuda")
    st.test_init()
    st.do_work()
    counts = {k: v for k, v in ck.launch_counts().items()
              if k.endswith("3d") and not k.startswith(("split_", "fused_"))}
    recs = autotune.records()
    test_err = st.error_l2 / npts
    if len(recs) != 2:
        fail(f"the 3D production solves tuned {len(recs)} shapes, not 2: {sorted(recs)}")
    expected = dict.fromkeys(counts, 0)
    expected["step3d"], expected["nsum3d"] = TEST_STEPS, 1  # the test form: L(G) once
    for entry in recs.values():
        for name in entry["ms_per_step"]:
            kernel, k = variant_launches(name, autotune.PROBE_STEPS, 3)
            expected[kernel] += (1 + autotune.PROBE_ITERS) * k
        kernel, k = variant_launches(entry["winner"], STEPS3, 3)
        expected[kernel] += k
    if counts != expected:
        fail(f"3D main-path launches {counts} != {expected} (the probes', the winners' and "
             "the test form's)")
    if not all(counts.values()):
        fail(f"a kernel of the 3D main path was not launched: {json.dumps(counts)}")
    if not test_err <= l2_threshold:
        fail(f"3D test-form solve: error_l2/#points {test_err:.3e} > {l2_threshold:g}")
    say(f"3D tuner records: {json.dumps(recs)}")
    winner = {n: recs[autotune.tuning_key(o, (n, n, n), torch.float32, "cuda")]["winner"]
              for n, o in ((N3, op), (N3S, op_s))}
    say(f"3D main path: Solver3D f32 method=cuda production solves of {STEPS3} steps, tuned, "
        f"at {N3}^3 eps={EPS3} (winner {winner[N3]}, do_work wall {walls[N3]:.3f} s incl. "
        f"tuning and host<->device copies) and {N3S}^3 eps={EPS3S} (winner {winner[N3S]}, "
        f"{walls[N3S]:.3f} s) + {TEST_STEPS} test-form steps at {N3}^3 (error_l2/#points "
        f"{test_err:.3e}); launches {json.dumps(counts)} = the probes', the winners' and the "
        "test form's")

    def row(name, source, line, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_kernel.py:{line}", **kw,
                "launches": counts[name], "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs)}

    no_call = "no one PyTorch call takes Euler steps"
    return [
        {**row("nsum3d", "nsum3d.cu", 793),
         "ms": nsum_ms, "plain_ms": nsum_plain_ms, "bound_ms": nsum_bound[0],
         "bound_by": nsum_bound[1], "library_ms": conv_ms, "shape": f"{N3}^3"},
        {**row("step3d", "nsum3d.cu", 793),
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{N3}^3", "ms_test_form": step_test_ms,
         "plain_ms_test_form": step_test_plain_ms, "bound_ms_test_form": step_test_bound[0],
         f"ms_{N3S}": step_s_ms},
        {**row("carried3d", "carried3d.cu", 1507),
         "ms": carried_ms, "plain_ms": carried_plain_ms, "bound_ms": carried_bound[0],
         "bound_by": carried_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{N3}^3"},
        {**row("resident3d", "resident3d.cu", 1419),
         "ms": res_ms, "plain_ms": res_plain_ms, "bound_ms": res_bound[0],
         "bound_by": res_bound[1], "library_ms": None, "library_note": no_call,
         "shape": f"{N3S}^3 eps={EPS3S}", "steps_per_launch": TEST_STEPS},
    ]


def phase_batched_checks(torch, ck, cb, np) -> dict:
    """Phase 2, the batched kernels: batched_step2d (production and test
    form), batched_carried2d and batched_superstep2d (K = 1-4) in float64,
    float32 and the bf16 operand tier, uniform and mixed physics, B in
    {1, 2, 3, 8}, eps 1-8 over ragged grids (1x1, smaller than one tile, non
    tile multiples) plus eps 16 and 40: each against its plain version
    (batched_step2d BITWISE: its register design at eps <= 16 and the
    shared tile body above sum in the plain versions' disc_sum order) and
    each lane BITWISE against one solo launch of the same kernel (step2d,
    carried2d, superstep2d) on that case.  In the bf16 tier the K-step
    tolerance grows by one bfloat16 rounding flip per step after the first
    (see phase_multistep_checks)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(SEED + 6)
    shapes = [(1, 1), (13, 45), (37, 50), (70, 90)]
    plan = [(e, s) for e in (1, 2, 3, 5, 8) for s in shapes] + [(16, (20, 90)), (40, (50, 45))]
    worst, n = {}, dict.fromkeys(("batched_step2d", "batched_carried2d",
                                  "batched_superstep2d"), 0)

    def hold(name, form, got, plain, tol, solo):
        _abs, err = rel_err(torch, got, plain)
        if not all(torch.equal(got[b], s) for b, s in enumerate(solo)):
            fail(f"{name} {form}: a lane is not bitwise equal to its solo launch")
        if name == "batched_step2d" and not torch.equal(got, plain):
            fail(f"batched_step2d {form}: not bitwise equal to its plain version (largest "
                 f"|kernel-plain| / max|plain| {err:.3e})")
        if not err <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {err:.3e} > {tol:.3e}")
        key = f"{name}/{form.split()[0]}/{form.split()[1]}"
        worst[key] = max(worst.get(key, 0.0), err)
        n[name] += 1

    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for prec in ("f32", "bf16"):
            for e, (nx, ny) in plan:
                wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(e)))
                for batch, mixed in ((1, False), (2, True), (3, False), (3, True), (8, True)):
                    scales = [2.0 + e + (b if mixed else 0) for b in range(batch)]
                    dts = [0.8 / (sc * wsum) * (1 + (0.1 * b if mixed else 0))
                           for b, sc in enumerate(scales)]
                    flip = max(dt * sc * wsum for sc, dt in zip(scales, dts, strict=True)) \
                        * 2.0 ** -8 if prec == "bf16" else 0.0
                    params = cb.case_params(scales, dts, dtype, "cuda")
                    U = torch.tensor(rng.standard_normal((batch, nx, ny)), dtype=dtype,
                                     device="cuda")
                    G, LG = torch.randn_like(U), torch.randn_like(U)
                    coefs = cb.source_coef_table([7], dts, dtype, "cuda")[0]
                    lanes = [U[b].contiguous() for b in range(batch)]
                    form = (f"{dname} {prec} eps={e} {batch}x{nx}x{ny} "
                            + ("mixed" if mixed else "uniform"))
                    hold("batched_step2d", form,
                         cb.batched_step2d(U, e, params, wsum, precision=prec),
                         cb.batched_step2d_plain(U, e, params, wsum, precision=prec), tol,
                         [ck.step2d(u, e, scales[b], wsum, dts[b], precision=prec)
                          for b, u in enumerate(lanes)])
                    hold("batched_step2d", form + " test form",
                         cb.batched_step2d(U, e, params, wsum, G=G, LG=LG, coefs=coefs,
                                           precision=prec),
                         cb.batched_step2d_plain(U, e, params, wsum, G=G, LG=LG, coefs=coefs,
                                                 precision=prec), tol,
                         [ck.step2d(u, e, scales[b], wsum, dts[b], g=G[b].contiguous(),
                                    lg=LG[b].contiguous(), t=7, precision=prec)
                          for b, u in enumerate(lanes)])
                    frames = F.pad(U, (e,) * 4).contiguous()
                    shadow = ck.shadow_of(frames) if prec == "bf16" else None
                    got = cb.batched_carried2d(frames, e, params, wsum, shadow=shadow)
                    plain = cb.batched_carried2d_plain(frames, e, params, wsum, shadow)
                    solo = [ck.carried2d(frames[b].contiguous(), e, scales[b], wsum, dts[b],
                                         shadow=None if shadow is None
                                         else shadow[b].contiguous())
                            for b in range(batch)]
                    if prec == "bf16":
                        if not all(torch.equal(got[1][b], s[1]) for b, s in enumerate(solo)):
                            fail(f"batched_carried2d {form}: a shadow lane differs from "
                                 "its solo launch")
                        got, plain, solo = got[0], plain[0], [s[0] for s in solo]
                    hold("batched_carried2d", form, got, plain, tol, solo)
                    for k in (1, 2, 3, 4):
                        if cb.fits_batched_superstep(e, k, dtype, prec):
                            hold("batched_superstep2d", f"{form} K={k}",
                                 cb.batched_superstep2d(U, e, params, wsum, k, prec),
                                 cb.batched_superstep2d_plain(U, e, params, wsum, k, prec),
                                 tol + (k - 1) * flip,
                                 [ck.superstep2d(u, e, scales[b], wsum, dts[b], k, prec)
                                  for b, u in enumerate(lanes)])
    try:  # a CUDA tensor the kernel cannot take raises; it never falls back
        z = torch.zeros(2, 200, 200, device="cuda", dtype=torch.float64)
        cb.batched_step2d(z, 70, cb.case_params([1.0] * 2, [1e-3] * 2, z.dtype, "cuda"), 1.0)
        fail("batched_step2d accepted eps=70 (beyond its shared-memory tile) on the card")
    except ValueError:
        pass
    say("batched kernel checks (max |kernel-plain| / max|plain|; every lane bitwise equal to "
        "its solo launch): " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + "; cases " + ", ".join(f"{k} {v}" for k, v in n.items()) + ": pass")
    return n


def ensemble_cases(np, n: int, physics, seed: int, nt: int) -> list:
    """``len(physics)`` production cases of n^2, eps=EPS, one per (k, dt, dh),
    each from its own seeded random state."""
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase

    rng = np.random.default_rng(seed)
    return [EnsembleCase(shape=(n, n), nt=nt, eps=EPS, k=k, dt=dt, dh=dh, test=False,
                         u0=rng.standard_normal((n, n))) for k, dt, dh in physics]


def euler_dt(dh: float, k: float = 1.0, frac: float = 0.8) -> float:
    """dt at which dt*c*dh^2*wsum = frac (at most 1: each step is then a
    convex combination of zero-extended values, so max|u| cannot grow)."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D

    probe = NonlocalOp2D(EPS, k, 1.0, dh)
    return frac / (probe.c * dh * dh * probe.wsum)


def phase_ensemble(torch, np, ck, cb, cases_2d) -> list:
    """Phase 6, the ensemble engine at the JAX package's own ensemble size
    (ensemble8x1024: 8 production cases of 1024^2, eps=8, f32, 500 steps)
    and a mixed-physics 8 x 512^2 bucket.  First, outside the count: each
    batched kernel at 8 x 1024^2 held to its plain version and each lane
    bitwise to the solo kernel, the kernels timed beside their plain
    versions and bounds, the engine's run timed (device and wall) beside
    the same 8 cases as 8 sequential tuned Solver2D solves, and each
    bucket's lanes held bitwise to the solo per-step loop; batched_step2d
    (bitwise its plain version) is also timed at B=1 against step2d on the
    same 1024^2 and 4096^2 planes (the register design against the shared
    tile body, in one run).  Then the counted
    main path: CASES_2D through the 2D CLI with --ensemble (float64), both
    buckets through EnsembleEngine(method="cuda"), and both again under
    NLHEAT_TUNE_BATCH=1 (the batched tuner's probes and winner)."""
    import contextlib
    import io

    import torch.nn.functional as F

    from nonlocalheatequation_torch.cli import solve2d
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        NonlocalOp2D,
        case_scale,
        make_multi_step_fn,
        make_multi_step_fn_base,
    )
    from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine
    from nonlocalheatequation_torch.utils import autotune

    B, N, steps = ENS_B, ENS_N, STEPS
    dh = 1.0 / N
    dt = euler_dt(dh)
    big = ensemble_cases(np, N, [(1.0, dt, dh)] * B, SEED + 7, steps)
    # eight physics: conductivities, spacings and fractions of each one's bound
    mixed = ensemble_cases(
        np, ENS_MIXED_N,
        [(k, euler_dt(h, k, f), h) for k, f, h in (
            (1.0, 0.8, 1 / 512), (0.5, 0.6, 1 / 512), (2.0, 0.7, 1 / 512), (1.0, 0.4, 1 / 640),
            (0.2, 0.8, 1 / 512), (1.0, 0.8, 1 / 400), (0.7, 0.5, 1 / 512), (1.5, 0.3, 1 / 560))],
        SEED + 8, steps)
    op = NonlocalOp2D(EPS, 1.0, dt, dh, method="cuda")
    scale, wsum = case_scale(op), op.wsum
    U = torch.as_tensor(np.stack([c.u0 for c in big]), device="cuda").to(torch.float32)
    params = cb.case_params([scale] * B, [dt] * B, torch.float32, "cuda")
    isz, npts, tol32 = 4, B * N * N, TOL["float32"]
    held = {k: [] for k in ("batched_step2d", "batched_carried2d", "batched_superstep2d")}

    def hold(name, form, got, ref, solo):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol32})
        if not rel <= tol32:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol32:g}")
        if name == "batched_step2d" and not torch.equal(got, ref):
            fail(f"batched_step2d {form}: not bitwise equal to its plain version")
        if not all(torch.equal(got[b], s) for b, s in enumerate(solo)):
            fail(f"{name} {form}: a lane is not bitwise equal to its solo launch")

    # every batched kernel at the main path's shape: plain and, per lane, solo
    lanes = [U[b].contiguous() for b in range(B)]
    G, LG = torch.randn_like(U), torch.randn_like(U)
    coefs = cb.source_coef_table([3], [dt] * B, torch.float32, "cuda")[0]
    form = f"float32 f32 {B}x{N}^2 eps={EPS}"
    hold("batched_step2d", form + " production", cb.batched_step2d(U, EPS, params, wsum),
         cb.batched_step2d_plain(U, EPS, params, wsum),
         [ck.step2d(u, EPS, scale, wsum, dt) for u in lanes])
    hold("batched_step2d", form + " test form",
         cb.batched_step2d(U, EPS, params, wsum, G=G, LG=LG, coefs=coefs),
         cb.batched_step2d_plain(U, EPS, params, wsum, G=G, LG=LG, coefs=coefs),
         [ck.step2d(u, EPS, scale, wsum, dt, g=G[b].contiguous(), lg=LG[b].contiguous(), t=3)
          for b, u in enumerate(lanes)])
    frames = F.pad(U, (EPS,) * 4).contiguous()
    hold("batched_carried2d", form, cb.batched_carried2d(frames, EPS, params, wsum),
         cb.batched_carried2d_plain(frames, EPS, params, wsum),
         [ck.carried2d(frames[b].contiguous(), EPS, scale, wsum, dt) for b in range(B)])
    for k in (2, 3):
        hold("batched_superstep2d", f"{form} K={k}",
             cb.batched_superstep2d(U, EPS, params, wsum, k),
             cb.batched_superstep2d_plain(U, EPS, params, wsum, k),
             [ck.superstep2d(u, EPS, scale, wsum, dt, k) for u in lanes])
    del lanes
    say(f"batched kernels at the main path's shape {B}x{N}^2 eps={EPS} (|kernel-plain| / "
        "max|plain|; every lane bitwise equal to its solo launch): "
        + "; ".join(f"{n} {c['form']} {c['rel_err']:.2e}" for n, cs in held.items() for c in cs))

    out, fout = torch.empty_like(U), torch.empty_like(frames)
    step_ms = cuda_ms(torch, lambda: cb.batched_step2d(U, EPS, params, wsum, out=out), 200)
    step_graph_ms = graph_ms(torch, lambda: cb.batched_step2d(U, EPS, params, wsum, out=out))
    step_test_ms = cuda_ms(torch, lambda: cb.batched_step2d(U, EPS, params, wsum, G=G, LG=LG,
                                                            coefs=coefs, out=out), 200)
    step_plain_ms = cuda_ms(torch, lambda: cb.batched_step2d_plain(U, EPS, params, wsum), 5, 1)
    carried_ms = cuda_ms(torch, lambda: cb.batched_carried2d(frames, EPS, params, wsum,
                                                             out=fout), 200)
    carried_plain_ms = cuda_ms(torch, lambda: cb.batched_carried2d_plain(frames, EPS, params,
                                                                         wsum), 5, 1)
    sup_ms = {k: cuda_ms(torch, lambda k=k: cb.batched_superstep2d(U, EPS, params, wsum, k,
                                                                   out=out), 100)
              for k in (2, 3)}
    sup_plain_ms = cuda_ms(torch, lambda: cb.batched_superstep2d_plain(U, EPS, params, wsum, 3),
                           3, 1)
    # the A/B of the two 2D bodies in this run: batched_step2d at B=1 (the
    # register design) against step2d (the shared tile body) on the same
    # plane, in turns step2d, batched, batched, step2d
    ab = {}
    for n_ab in (N, NX):
        plane = U[:1] if n_ab == N else torch.as_tensor(
            np.random.default_rng(SEED + 9).standard_normal((1, n_ab, n_ab)),
            device="cuda").float()
        one = cb.case_params([scale], [dt], torch.float32, "cuda")
        if not torch.equal(cb.batched_step2d(plane, EPS, one, wsum)[0],
                           ck.step2d(plane[0], EPS, scale, wsum, dt)):
            fail(f"batched_step2d 1x{n_ab}^2: not bitwise equal to step2d")
        o1 = torch.empty_like(plane)
        solo_fn = lambda plane=plane, o1=o1: ck.step2d(plane[0], EPS, scale, wsum, dt,  # noqa: E731
                                                     out=o1[0])
        batch_fn = lambda plane=plane, o1=o1, one=one: cb.batched_step2d(  # noqa: E731
            plane, EPS, one, wsum, out=o1)
        times = [cuda_ms(torch, f, 200) for f in (solo_fn, batch_fn, batch_fn, solo_fn)]
        graph = [graph_ms(torch, f) for f in (solo_fn, batch_fn, batch_fn, solo_fn)]
        ab[f"1x{n_ab}^2"] = {"step2d_ms": (times[0] + times[3]) / 2,
                             "batched_step2d_ms": (times[1] + times[2]) / 2, "turns": times,
                             "step2d_ms_graph": (graph[0] + graph[3]) / 2,
                             "batched_step2d_ms_graph": (graph[1] + graph[2]) / 2,
                             "turns_graph": graph,
                             "bound_ms": bound(2 * n_ab * n_ab * isz,
                                               n_ab * n_ab * kernel_ops(EPS, 5))[0]}
        del plane, o1
    solo_step_ms = ab[f"1x{N}^2"]["step2d_ms"]
    step_bound = bound(2 * npts * isz, npts * kernel_ops(EPS, 5))
    step_test_bound = bound(4 * npts * isz, npts * kernel_ops(EPS, 9))
    carried_bound = bound(2 * frames.numel() * isz, npts * kernel_ops(EPS, 5))
    sup_bound = {k: bound(2 * npts * isz, k * npts * kernel_ops(EPS, 5)) for k in (2, 3)}
    del G, LG, frames, fout
    say(f"batched_step2d {B}x{N}^2 eps={EPS} f32: kernel {step_ms:.4f} ms/launch (in a CUDA "
        f"graph {step_graph_ms:.4f}) "
        f"({step_ms / B:.5f} ms per case-step; step2d alone at {N}^2 {solo_step_ms:.5f} ms), "
        f"plain {step_plain_ms:.3f} ms, bound {step_bound[0]:.4f} ms ({step_bound[1]}); "
        f"test form {step_test_ms:.4f} ms, bound {step_test_bound[0]:.4f} ms "
        f"({step_test_bound[1]})")
    say("A/B of the register design (batched_step2d, B=1) against the shared tile body "
        f"(step2d) on the same plane, eps={EPS} f32, ms per launch in a loop and in a CUDA "
        "graph (turns step2d, batched, batched, step2d): " + "; ".join(
            f"{k}: batched_step2d {v['batched_step2d_ms']:.4f}, step2d {v['step2d_ms']:.4f} "
            f"(ratio {v['step2d_ms'] / v['batched_step2d_ms']:.3f}); graph "
            f"{v['batched_step2d_ms_graph']:.4f} against {v['step2d_ms_graph']:.4f} (ratio "
            f"{v['step2d_ms_graph'] / v['batched_step2d_ms_graph']:.3f}); bound "
            f"{v['bound_ms']:.4f}; turns {json.dumps([round(t, 5) for t in v['turns']])}, "
            f"graph {json.dumps([round(t, 5) for t in v['turns_graph']])}"
            for k, v in ab.items()))
    say(f"batched_carried2d {B}x{N}^2 eps={EPS} f32: kernel {carried_ms:.4f} ms/launch, plain "
        f"{carried_plain_ms:.3f} ms, bound {carried_bound[0]:.4f} ms ({carried_bound[1]})")
    for k in (2, 3):
        say(f"batched_superstep2d {B}x{N}^2 eps={EPS} f32 K={k}: kernel {sup_ms[k]:.4f} "
            f"ms/launch ({sup_ms[k] / k:.4f} ms/step), bound {sup_bound[k][0]:.4f} ms "
            f"({sup_bound[k][1]})" + (f", plain {sup_plain_ms:.3f} ms" if k == 3 else ""))

    # the engine's run and the same 8 cases as 8 sequential tuned solves
    engine = EnsembleEngine(method="cuda", device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    res = engine.run(big)
    first_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.run(big)
    eng_wall = time.perf_counter() - t0
    multi = engine.build_program(big[0].bucket_key(), big)
    eng_ms = cuda_ms(torch, lambda: multi(U, 0), 2, 1)
    for b, case in enumerate(big):
        ref = make_multi_step_fn_base(op, steps)(U[b], 0)
        if not np.array_equal(res[b], ref.cpu().numpy()):
            fail(f"ensemble {B}x{N}^2: lane {b} is not bitwise equal to its solo per-step loop")
    autotune.pick_multi_step_fn(op, steps, (N, N), torch.float32, "cuda")  # tune the shape once
    solo = make_multi_step_fn(op, steps, dtype=torch.float32)
    seq_ms = cuda_ms(torch, lambda: [solo(U[b], 0) for b in range(B)], 2, 1)
    t0 = time.perf_counter()
    for case in big:
        s = Solver2D(N, N, steps, EPS, k=case.k, dt=case.dt, dh=case.dh, method="cuda",
                     dtype=torch.float32, device="cuda")
        s.input_init(case.u0)
        s.do_work()
    seq_wall = time.perf_counter() - t0
    solo_winner = autotune.records()[autotune.tuning_key(op, (N, N), torch.float32, "cuda")][
        "winner"]
    work = B * N * N * steps
    say(f"ensemble {B}x{N}^2 eps={EPS} f32, {steps} steps: EnsembleEngine(method='cuda') "
        f"{eng_ms:.3f} ms on the card ({work / (eng_ms * 1e-3):.4e} cases*points*steps/s), "
        f"run() wall {eng_wall:.3f} s (first run, building the program, {first_wall:.3f} s); "
        f"8 sequential tuned solves (winner {solo_winner}) {seq_ms:.3f} ms on the card "
        f"({work / (seq_ms * 1e-3):.4e} cases*points*steps/s), Solver2D.do_work wall "
        f"{seq_wall:.3f} s; ratio sequential/ensemble on the card {seq_ms / eng_ms:.3f}")
    # the lanes held bitwise here are what the counted runs below must return
    held_res = {"8x1024": res}
    res = held_res["8x512 mixed"] = EnsembleEngine(method="cuda", device="cuda",
                                                   dtype=torch.float32).run(mixed)
    for case, got in zip(mixed, res, strict=True):
        o = NonlocalOp2D(case.eps, case.k, case.dt, case.dh, method="cuda")
        ref = make_multi_step_fn_base(o, case.nt)(
            torch.as_tensor(case.u0, device="cuda").float(), 0)
        if not np.array_equal(got, ref.cpu().numpy()):
            fail(f"mixed ensemble 8x{ENS_MIXED_N}^2: a lane is not bitwise equal to its solo "
                 "per-step loop")
    del U, out
    say(f"mixed-physics ensemble 8x{ENS_MIXED_N}^2 eps={EPS} f32, {steps} steps: every lane "
        "bitwise equal to its solo per-step loop")

    # the counted main path
    autotune.reset()
    ck.reset_launch_counts()
    runs = {}

    def counted(name, fn):
        before = ck.launch_counts()
        t0 = time.perf_counter()
        out = fn()
        runs[name] = {"wall_s": round(time.perf_counter() - t0, 3),
                      "launches": {k: v - before[k] for k, v in ck.launch_counts().items()
                                   if v != before[k]}}
        return out

    def cli_2d():
        stdout, stderr = io.StringIO(), io.StringIO()
        stdin, sys.stdin = sys.stdin, io.StringIO(batch_text(cases_2d))
        try:
            with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
                rc = solve2d.main([*CLI_ARGS, "--ensemble"])
        finally:
            sys.stdin = stdin
        if rc != 0 or stdout.getvalue().splitlines()[-1] != "Tests Passed":
            fail(f"solve2d --ensemble: rc {rc}\n{stdout.getvalue()}\n{stderr.getvalue()}")
        return stderr.getvalue().strip().splitlines()[-1]

    cli_summary = counted("cli solve2d --ensemble", cli_2d)
    ran = runs["cli solve2d --ensemble"]["launches"]
    if ran.get("step2d", 0) or not ran.get("batched_step2d", 0):
        fail(f"solve2d --ensemble: launches {ran}; the rows must run batched_step2d, not step2d")
    reports = {}
    for name, cases in (("8x1024", big), ("8x512 mixed", mixed)):
        eng = EnsembleEngine(method="cuda", device="cuda", dtype=torch.float32)
        res = counted(name, lambda eng=eng, cases=cases: eng.run(cases))
        r = eng.report
        reports[name] = r.summary()
        if (r.buckets, r.programs_built, r.dispatches) != (1, 1, 1) \
                or runs[name]["launches"] != {"batched_step2d": steps}:
            fail(f"ensemble {name}: {r.summary()}, launches {runs[name]['launches']}; expected "
                 f"1 bucket, 1 program, 1 dispatch and {steps} batched_step2d launches")
        for case, got in zip(cases, res, strict=True):
            if got.shape != case.shape or not np.isfinite(got).all() \
                    or not float(np.abs(got).max()) <= float(np.abs(case.u0).max()):
                fail(f"ensemble {name}: a result is not finite, of the wrong shape, or grew")
        if not all(np.array_equal(g, h) for g, h in zip(res, held_res[name], strict=True)):
            fail(f"ensemble {name}: a lane of the counted run is not bitwise equal to the "
                 "same lane held against its solo per-step loop above")
    os.environ["NLHEAT_TUNE_BATCH"] = "1"
    try:
        for name, cases in (("tuned 8x1024", big), ("tuned 8x512 mixed", mixed)):
            eng = EnsembleEngine(method="cuda", device="cuda", dtype=torch.float32)
            res = counted(name, lambda eng=eng, cases=cases: eng.run(cases))
            reports[name] = f"{eng.report.summary()}; {list(eng.report.strategies.values())}"
            # every batched winner is bitwise the per-step loop; vmap (an nsum
            # per case, then the update in PyTorch) is held to the tolerance
            exact = "tuned:vmap" not in eng.report.strategies.values()
            for got, want in zip(res, held_res[name[len("tuned "):]], strict=True):
                ok = (np.array_equal(got, want) if exact else
                      float(np.abs(got - want).max()) <= tol32 * float(np.abs(want).max()))
                if not ok:
                    fail(f"ensemble {name}: a lane differs from the lane held against its "
                         f"solo per-step loop ({eng.report.strategies})")
    finally:
        del os.environ["NLHEAT_TUNE_BATCH"]
    recs = autotune.records()
    counts = ck.launch_counts()
    expected = dict.fromkeys(held, 0)
    expected["batched_step2d"] = ran["batched_step2d"] + 2 * steps
    for entry in recs.values():
        for cand in entry["ms_per_step"]:
            kernel, k = variant_launches(cand, autotune.PROBE_STEPS)
            if kernel in expected:
                expected[kernel] += (1 + autotune.PROBE_ITERS) * k
        kernel, k = variant_launches(entry["winner"], steps)
        if kernel in expected:
            expected[kernel] += k
    got = {k: counts[k] for k in expected}
    if len(recs) != 2 or got != expected:
        fail(f"ensemble main path: batched launches {got} != {expected} (the CLI rows', the "
             f"buckets', the probes' and the winners'); {len(recs)} tuning records")
    if not all(got.values()):
        fail(f"a batched kernel of the ensemble path was not launched: {got}")
    say(f"batch tuner records: {json.dumps(recs)}")
    say(f"ensemble main path (counted): CASES_2D through solve2d --ensemble ({cli_summary}); "
        + "; ".join(f"{k}: {v}" for k, v in reports.items())
        + f"; runs {json.dumps(runs)}; batched launches {json.dumps(got)} = the rows', the "
        "buckets', the probes' and the winners'")

    def row(name, line, source, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_kernel.py:{line}", **kw,
                "launches": counts[name], "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs), "library_ms": None,
                "library_note": "no one PyTorch call takes a batched Euler step",
                "shape": f"{B}x{N}^2"}

    return [
        row("batched_step2d", 1694, "batched_step2d.cu", ms=step_ms, plain_ms=step_plain_ms,
            bound_ms=step_bound[0], bound_by=step_bound[1], ms_test_form=step_test_ms,
            bound_ms_test_form=step_test_bound[0], ms_step2d_one_case=solo_step_ms,
            ms_graph=step_graph_ms, ab_b1_against_step2d=ab, ensemble_ms=eng_ms,
            sequential_ms=seq_ms),
        row("batched_carried2d", 1839, "batched_carried2d.cu", ms=carried_ms,
            plain_ms=carried_plain_ms, bound_ms=carried_bound[0], bound_by=carried_bound[1]),
        row("batched_superstep2d", 1963, "batched_superstep2d.cu", ms=sup_ms[3],
            plain_ms=sup_plain_ms, bound_ms=sup_bound[3][0], bound_by=sup_bound[3][1],
            ksteps=3, ms_k2=sup_ms[2], bound_ms_k2=sup_bound[2][0]),
    ]


# -- phase 7: the unstructured path ------------------------------------------------

UN_M = 512           # the shuffled jittered 512^2 cloud, eps = 3h: 262,144 nodes
UN_STEPS = 20        # steps of the CLI run on it (B13 launches exactly this many)
MESH_NM = 256        # bench.py's graded cloud at grid 512 (nm = grid // 2): 65,536 nodes
MESH_STEPS = 100     # steps of each 8-case mesh bucket
MESHES = ("10x10", "50x50", "100x100", "200x200")


def jittered_cloud(np, m: int, d: int, seed: int, shuffle: bool = False):
    """An m^d lattice on [0, 1)^d jittered by +/-0.2 spacings, optionally
    shuffled; (points, spacing)."""
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    grids = np.meshgrid(*([np.arange(m) * h] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    return (pts[rng.permutation(len(pts))] if shuffle else pts), h


def graded_cloud(np, nm: int, eps_factor: float = EPS, a: float = 0.6):
    """bench.py's BENCH_MESH cloud (bench.py:1236-1248), copied: the
    tensor-product map g(xi) = xi + a*sin(2*pi*xi)/(2*pi) on [0,1]^2, spacing
    (1-a)/nm at the centre and (1+a)/nm at the edge, eps = eps_factor x the
    local spacing, vol = the local cell volume; (points, eps, vol)."""
    xi = (np.arange(nm) + 0.5) / nm
    gmap = xi + a * np.sin(2 * np.pi * xi) / (2 * np.pi)
    gp = 1 + a * np.cos(2 * np.pi * xi)
    X, Y = np.meshgrid(gmap, gmap, indexing="ij")
    HX, HY = np.meshgrid(gp / nm, gp / nm, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    return pts, float(eps_factor) * (0.5 * (HX + HY)).ravel(), (HX * HY).ravel()


def small_clouds(np):
    """Phase 7a's clouds: (name, points, eps, vol, windowed-plan kwargs)."""
    out = []
    pts, h = jittered_cloud(np, 40, 2, SEED)
    out.append(("2D jittered", pts, 3 * h * (1 + 0.2 * np.sin(7 * pts[:, 0])), h * h, {}))
    pts, h = jittered_cloud(np, 40, 2, SEED + 1, shuffle=True)
    out.append(("2D shuffled", pts, 3 * h, h * h, {}))
    pts, h = jittered_cloud(np, 12, 3, SEED + 2)
    out.append(("3D", pts, 2.5 * h, h ** 3, {}))
    pts, h = jittered_cloud(np, 700, 1, SEED + 3)
    out.append(("1D", pts, 4 * h, h, {}))
    rng = np.random.default_rng(SEED + 4)
    out.append(("n=1000 (not a multiple of 128)", rng.uniform(size=(1000, 2)), 0.08, 1e-3, {}))
    pts, h = jittered_cloud(np, 40, 2, SEED + 5)
    out.append(("forced residual (wmax=128)", pts, 3 * h, h * h, {"wmax": 128}))
    out.append(("self-only horizon", np.stack([np.linspace(0, 1, 300), np.zeros(300)], 1),
                1e-6, 1.0, {}))
    pts = rng.uniform(size=(600, 2))
    eps = 0.06 * (1 + 0.5 * rng.uniform(size=600))
    eps[0] = 2.0  # a hub sees every node
    out.append(("variable horizon with a hub", pts, eps, 1.0 / 600, {}))
    return out


def phase_unstructured_checks(torch, np) -> dict:
    """Phase 7a: windowed_matvec (f64, f32) and gather_L (f64, f32, bf16
    operand) against their plain versions on small clouds, the windowed
    operator (residual included) against the NumPy oracle, and each lane of
    a stacked gather chunk bitwise equal to its solo run."""
    from nonlocalheatequation_torch.ops import cuda_unstructured as cu
    from nonlocalheatequation_torch.ops.gather import (
        GatherTable,
        make_batched_gather_multi_step_fn,
        make_gather_multi_step_fn,
    )
    from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp

    rng = np.random.default_rng(SEED + 6)
    worst, n = {}, {"windowed_matvec": 0, "gather_L": 0}

    def held(key, got, ref, tol):
        err = rel_err(torch, got, ref)[1]
        if not err <= tol:
            fail(f"{key}: |kernel-plain| / max|plain| {err:.3e} > {tol:g}")
        worst[key] = max(worst.get(key, 0.0), err)

    for name, pts, eps, vol, kw in small_clouds(np):
        op = UnstructuredNonlocalOp(pts, eps, k=1.0, dt=1e-6, vol=vol, device="cuda")
        plan = op.windowed_plan(**kw)
        for dtype in (torch.float64, torch.float32):
            tname = str(dtype).split(".")[1]
            tol = TOL[tname]
            u = torch.tensor(rng.standard_normal(op.n), device="cuda", dtype=dtype)
            ex = plan.for_dtype(dtype, "cuda")
            packed = (ex.rowptr, ex.cols, ex.vals, ex.s128)
            held(f"windowed_matvec/{tname}", cu.windowed_matvec(*packed, u, ex.we),
                 cu.windowed_matvec_plain(*packed, u, ex.we), tol)
            held(f"windowed L vs oracle/{tname}", ex.L(u),
                 torch.as_tensor(op.apply_np(u.double().cpu().numpy()), device="cuda"), tol)
            n["windowed_matvec"] += 1
            table = GatherTable(op, dtype, "cuda")
            for prec in ("f32", "bf16"):
                got = cu.gather_L(table.rowptr, table.col, table.w, u, prec)
                held(f"gather_L/{tname}/{prec}", got,
                     cu.gather_L_plain(table.rowptr, table.col, table.w, u, prec), tol)
                if not torch.equal(got, cu.gather_L(table.rowptr, table.col, table.w, u, prec)):
                    fail(f"gather_L {name} {tname} {prec}: two launches differ")
                n["gather_L"] += 1
        say(f"  {name}: {op.n} nodes, {len(op.tgt)} edges, kmax {op.kmax}, windows "
            f"{plan.R} x {plan.we}, coverage {plan.coverage:.4f}")
    # a stacked chunk of three physics: every lane bitwise its solo run
    pts, h = jittered_cloud(np, 30, 2, SEED + 7)
    ops = [UnstructuredNonlocalOp(pts, 3 * h, k=k, dt=dt, vol=h * h, device="cuda")
           for k, dt in ((1.0, 1e-5), (0.5, 2e-5), (2.0, 5e-6))]
    U0 = torch.tensor(rng.standard_normal((3, ops[0].n)), device="cuda")
    for dtype in (torch.float64, torch.float32):
        for test in (False, True):
            out = make_batched_gather_multi_step_fn(ops, 5, dtype=dtype, test=test)(U0, 0)
            for b, op in enumerate(ops):
                solo = make_gather_multi_step_fn(op, 5, dtype=dtype, test=test)(U0[b], 0)
                if not torch.equal(out[b], solo):
                    fail(f"stacked gather lane {b} ({dtype}, test={test}) is not bitwise its "
                         "solo run")
    say("unstructured kernel checks (max |kernel-plain| / max|plain|): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + f"; cases windowed_matvec {n['windowed_matvec']}, gather_L {n['gather_L']}; "
        "stacked gather lanes bitwise solo: pass")
    return n


def csr_library(torch, rowptr, col, w, n: int):
    """``x -> torch.sparse.mm(A, x)`` for the CSR matrix (rowptr, col, w):
    the library yardstick (the port never calls it)."""
    A = torch.sparse_csr_tensor(rowptr, col.long(), w, size=(n, n))
    return lambda x: torch.sparse.mm(A, x.unsqueeze(1)).squeeze(1)


def start_unstructured_clis() -> tuple:
    """solve_unstructured --test on each data/*.msh on the card in float64,
    --layout auto then windowed, one process per mesh running the two in
    turn, started right after the build so that they run beside phase 2;
    (jobs, start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    jobs = {}
    for name in MESHES:
        runs = " && ".join(
            f"{sys.executable} -m nonlocalheatequation_torch.cli.solve_unstructured --mesh "
            f"data/{name}.msh --test --platform gpu --x64 1 --layout {lay}"
            for lay in ("auto", "windowed"))
        proc = subprocess.Popen(["bash", "-c", runs], cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        CHILDREN.append(proc)
        jobs[name] = proc
    return jobs, time.perf_counter()


def phase_unstructured_cli(clis, l2_threshold):
    """Phase 3b: each data/*.msh solve (f64, auto and windowed) must print
    error_l2/N <= 1e-6."""
    jobs, t0 = clis
    errs = {}
    for name, proc in jobs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"solve_unstructured on data/{name}.msh: rc {proc.returncode}\n{out}\n"
                 f"{err[-4000:]}")
        lines = [x for x in out.splitlines() if x.startswith("error_l2/N ")]
        if len(lines) != 2:
            fail(f"solve_unstructured on data/{name}.msh: {len(lines)} error lines\n{out}")
        for lay, line in zip(("auto", "windowed"), lines, strict=True):
            errs[f"{name} {lay}"] = cli_error(line, f"solve_unstructured {name} --layout {lay}",
                                              l2_threshold)
    say("solve_unstructured --test --platform gpu --x64 1 on data/*.msh (error_l2/N, --layout "
        "auto and windowed): " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; wall (beside phase 2) {time.perf_counter() - t0:.1f} s")


def run_cli_unstructured(argv) -> str:
    """solve_unstructured in-process on the card; its stdout (fails on rc != 0)."""
    import contextlib
    import io

    from nonlocalheatequation_torch.cli import solve_unstructured

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = solve_unstructured.main(argv)
    if rc != 0:
        fail(f"solve_unstructured {' '.join(argv)}: rc {rc}\n{out.getvalue()}\n"
             f"{err.getvalue()}")
    return out.getvalue()


def cli_error(text: str, what: str, l2_threshold: float) -> float:
    line = next((x for x in text.splitlines() if x.startswith("error_l2/N ")), None)
    if line is None:
        fail(f"{what}: no error_l2/N line\n{text}")
    err = float(line.split()[1])
    if not err <= l2_threshold:
        fail(f"{what}: error_l2/N {err:.3e} > {l2_threshold:g}")
    return err


def phase_unstructured(torch, np, ck, l2_threshold) -> list:
    """Phase 7, the unstructured path: (b) the shuffled jittered 512^2 cloud
    (eps = 3h, f32): host walls of the edge and plan builds, the card memory
    of building the windowed exec (the packed in-window entries; the dense
    strips are never allocated), windowed_matvec and gather_L held to their
    plain versions and timed beside them, their bounds and torch.sparse.mm,
    one step of each layout and one auto-picked step (counted); (c) counted, the
    CLI on the 512^2 cloud from a 2.2 .msh with --layout auto (windowed,
    UN_STEPS launches; data/*.msh ran beside phase 2, phase_unstructured_cli);
    (d) bench.py's graded cloud at nm=256 in a throwaway mesh
    registry: gather_L held and timed at its shape, then, counted, an 8-case
    bucket and a mixed-physics 8-case bucket through EnsembleEngine (lanes x
    MESH_STEPS launches each), every lane bitwise its solo gather loop."""
    from nonlocalheatequation_torch.ops import cuda_unstructured as cu
    from nonlocalheatequation_torch.ops.gather import GatherTable, make_gather_multi_step_fn
    from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
    from nonlocalheatequation_torch.serve.meshes import MeshStore, get_mesh_op
    from nonlocalheatequation_torch.utils.gmsh import write_point_cloud_msh

    f32, tol32, isz = torch.float32, TOL["float32"], 4
    rng = np.random.default_rng(SEED + 8)
    t_phase = time.perf_counter()
    held = {"windowed_matvec": [], "gather_L": []}

    def hold(name, form, got, ref, tol):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol:g}")

    # (b) the realistic cloud
    pts, h = jittered_cloud(np, UN_M, 2, SEED + 9, shuffle=True)
    t0 = time.perf_counter()
    op = UnstructuredNonlocalOp(pts, 3 * h, k=1.0, dt=1.0, vol=h * h, device="cuda")
    edge_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    layout = op.choose_layout()
    gate_wall = time.perf_counter() - t0
    if layout != "windowed":
        fail(f"the shuffled {UN_M}^2 cloud: auto chose {layout!r} on the card, not windowed")
    t0 = time.perf_counter()
    plan = op.windowed_plan()
    plan_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ex = plan.for_dtype(f32, "cuda")
    torch.cuda.synchronize()
    fill_wall = time.perf_counter() - t0
    exec_peak = torch.cuda.max_memory_allocated() - mem0
    n, nnz_w = op.n, len(plan.p_vals)
    packed = (ex.rowptr, ex.cols, ex.vals, ex.s128)
    packed_bytes = sum(t.numel() * t.element_size() for t in packed)
    if hasattr(ex, "P") or exec_peak >= plan.p_bytes_f32:
        fail(f"the windowed exec allocated {exec_peak} B on the card: the dense strips "
             f"({plan.p_bytes_f32} B) must never be allocated")
    shape13 = f"{n} nodes, R={plan.R} windows of we={plan.we}, {nnz_w} packed entries"
    say(f"shuffled {UN_M}^2 cloud, eps=3h: {n} nodes, {len(op.tgt)} edges, kmax {op.kmax}; "
        f"host walls: build_edges {edge_wall:.2f} s, auto gate (offset stats + window search) "
        f"{gate_wall:.2f} s, plan {plan_wall:.2f} s, exec built (packed on the host, copied) "
        f"{fill_wall:.2f} s; windows {plan.R} x {plan.we}, coverage {plan.coverage:.4f}, "
        f"{nnz_w} in-window entries ({nnz_w / (plan.n_pad * plan.W):.4f} of the dense "
        f"strips' {plan.p_bytes_f32} B), packed rowptr+cols+vals+s128 {packed_bytes} B; "
        f"torch.cuda.max_memory_allocated while building the f32 windowed exec: {exec_peak} B "
        f"above the {mem0} B before it; residual {plan.ov_tgt.size} edges")
    u = torch.tensor(rng.standard_normal(n), device="cuda", dtype=f32)
    mv = cu.windowed_matvec(*packed, u, ex.we)
    hold("windowed_matvec", f"float32 shuffled {UN_M}^2", mv,
         cu.windowed_matvec_plain(*packed, u, ex.we), tol32)
    if not torch.equal(mv, cu.windowed_matvec(*packed, u, ex.we)):
        fail("windowed_matvec: two launches on the same input differ")
    u64 = u.double()
    ex64 = plan.for_dtype(torch.float64, "cuda")
    packed64 = (ex64.rowptr, ex64.cols, ex64.vals, ex64.s128)
    hold("windowed_matvec", f"float64 shuffled {UN_M}^2",
         cu.windowed_matvec(*packed64, u64, ex64.we),
         cu.windowed_matvec_plain(*packed64, u64, ex64.we), TOL["float64"])
    del ex64, packed64
    torch.cuda.empty_cache()
    # the library yardstick for B13: the in-window entries as one CSR matrix
    s128 = plan.s128.astype(np.int64)
    gcol = s128[plan.p_rows // 128, plan.p_cols // plan.we] * 128 + plan.p_cols % plan.we
    by = np.lexsort((gcol, plan.p_rows))
    rowptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(plan.p_rows, minlength=plan.n_pad)[:n], out=rowptr[1:])
    lib13 = csr_library(torch, torch.as_tensor(rowptr, device="cuda"),
                        torch.as_tensor(gcol[by], device="cuda"),
                        torch.as_tensor(plan.p_vals[by], device="cuda", dtype=f32), n)
    lib_err = rel_err(torch, lib13(u), mv)[1]
    if not lib_err <= tol32:
        fail(f"torch.sparse.mm of the in-window entries differs from windowed_matvec: "
             f"{lib_err:.3e}")
    # in turns: library, kernel, kernel, library; each as a replayed CUDA
    # graph of launches (the wrapper's host cost per call is of the order of
    # the kernel's time here) and as a loop of launches from Python
    k13 = lambda: cu.windowed_matvec(*packed, u, ex.we)  # noqa: E731
    l13 = lambda: lib13(u)  # noqa: E731
    t13 = [graph_ms(torch, f) for f in (l13, k13, k13, l13)]
    t13_loop = [cuda_ms(torch, f, 100) for f in (l13, k13, k13, l13)]
    out13 = {"ms": (t13[1] + t13[2]) / 2, "library_ms": (t13[0] + t13[3]) / 2, "turns": t13,
             "ms_loop": (t13_loop[1] + t13_loop[2]) / 2,
             "library_ms_loop": (t13_loop[0] + t13_loop[3]) / 2, "turns_loop": t13_loop,
             "plain_ms": cuda_ms(torch, lambda: cu.windowed_matvec_plain(*packed, u, ex.we),
                                 10, 2)}
    # the same work done the least way: each packed entry (value, uint16
    # column), the row pointer and the window starts read once, u read once,
    # out written once; a multiply-add an entry
    b13_bytes = nnz_w * (isz + 2) + packed[0].numel() * 4 + packed[3].numel() * 4 + 2 * n * isz
    b13 = bound(b13_bytes, 2 * nnz_w)
    del lib13
    # B12 at the same cloud (original order)
    table = GatherTable(op, f32, "cuda")
    g = cu.gather_L(table.rowptr, table.col, table.w, u)
    hold("gather_L", f"float32 shuffled {UN_M}^2", g,
         cu.gather_L_plain(table.rowptr, table.col, table.w, u), tol32)
    lib12 = csr_library(torch, table.rowptr, table.col, table.w, n)
    out12s = {"ms": cuda_ms(torch, lambda: cu.gather_L(table.rowptr, table.col, table.w, u),
                            50),
              "plain_ms": cuda_ms(torch, lambda: cu.gather_L_plain(table.rowptr, table.col,
                                                                   table.w, u), 5, 1),
              "library_ms": cuda_ms(torch, lambda: lib12(u), 20)}
    b12s = bound(table.nnz * (isz + 4) + (n + 1) * 8 + 2 * n * isz, 2 * table.nnz)
    del lib12, table
    say(f"B13 windowed_matvec {UN_M}^2 f32: kernel {out13['ms']:.4f} ms in a CUDA graph "
        f"({out13['ms_loop']:.4f} in a loop of launches), plain (gather from the windows, row "
        f"segment sum) {out13['plain_ms']:.3f} ms, torch.sparse.mm CSR of the {nnz_w} "
        f"in-window entries {out13['library_ms']:.4f} ms in a graph "
        f"({out13['library_ms_loop']:.4f} in a loop; turns library, kernel, kernel, library: "
        f"graph {json.dumps([round(t, 5) for t in t13])}, loop "
        f"{json.dumps([round(t, 5) for t in t13_loop])}), bound {b13[0]:.4f} ms ({b13[1]}: "
        f"{b13_bytes} B = the packed entries at {isz + 2} B, rowptr, s128, u, out)")
    say(f"B12 gather_L {UN_M}^2 f32 (CSR, {len(op.tgt) + n} entries with the centres): kernel "
        f"{out12s['ms']:.4f} ms, plain {out12s['plain_ms']:.3f} ms, torch.sparse.mm "
        f"{out12s['library_ms']:.4f} ms, bound {b12s[0]:.4f} ms ({b12s[1]})")
    # one L(u) per layout, each held to the float64 NumPy oracle (a random
    # state: a smooth one cancels in L and leaves float32 noise in its place)
    steps = {}
    uo_np = rng.standard_normal(n)
    uo = torch.tensor(uo_np, device="cuda", dtype=f32)
    oracle = torch.as_tensor(op.apply_np(uo_np), device="cuda")
    for lay in ("windowed", "offsets", "ell", "edges"):
        lay_err = rel_err(torch, op.apply(uo, layout=lay), oracle)[1]
        if not lay_err <= tol32:
            fail(f"layout {lay} on the shuffled cloud: |L - oracle| / max|oracle| "
                 f"{lay_err:.3e} > {tol32:g}")
        steps[lay] = cuda_ms(torch, lambda lay=lay: op.apply(uo, layout=lay), 5, 1)
    # one auto-picked L(u), counted: the layout the card's policy takes
    ck.reset_launch_counts()
    auto_err = rel_err(torch, op.apply(uo), oracle)[1]
    auto_launches = {k: v for k, v in ck.launch_counts().items() if v}
    if not auto_err <= tol32 or auto_launches != {"windowed_matvec": 1}:
        fail(f"auto L(u) on the shuffled cloud: error {auto_err:.3e}, launches {auto_launches}"
             " (the policy picks windowed on the card)")
    steps["auto"] = cuda_ms(torch, lambda: op.apply(uo), 5, 1)
    off = op.offset_plan()
    say(f"one L(u) per layout at {UN_M}^2 f32, ms: {json.dumps(steps)} (auto picks "
        f"{op.choose_layout()!r}, launches {json.dumps(auto_launches)}, |L - oracle| / "
        f"max|oracle| {auto_err:.3e}; offsets keeps {len(off.offs)} diagonals, coverage "
        f"{off.coverage:.4f})")
    plan_strip_bytes = plan.p_bytes_f32
    del ex, op, off, uo, oracle, u, mv, g, packed
    plan = None
    torch.cuda.empty_cache()

    walls = {"b": time.perf_counter() - t_phase}

    # (c) the CLI on the card, counted (data/*.msh ran beside phase 2)
    counted = {}
    with tempfile.TemporaryDirectory() as tmp:
        msh = os.path.join(tmp, f"shuffled{UN_M}.msh")
        write_point_cloud_msh(msh, pts)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        text = run_cli_unstructured(["--mesh", msh, "--test", "--platform", "gpu", "--layout",
                                     "auto", "--eps", repr(3 * h), "--nt", str(UN_STEPS)])
        cli_wall = time.perf_counter() - t0
        counted["cli"] = {k: v for k, v in ck.launch_counts().items() if v}
    err = cli_error(text, f"solve_unstructured shuffled {UN_M}^2", l2_threshold)
    if counted["cli"] != {"windowed_matvec": UN_STEPS}:
        fail(f"solve_unstructured --layout auto on the shuffled {UN_M}^2 cloud: launches "
             f"{counted['cli']}, expected windowed_matvec x {UN_STEPS} (auto must choose "
             "windowed on the card)")
    say(f"main path (counted): solve_unstructured --layout auto on the shuffled {UN_M}^2 cloud "
        f"(a 2.2 .msh, f32, {UN_STEPS} steps): launches {json.dumps(counted['cli'])}, "
        f"error_l2/N {err:.3e}, wall {cli_wall:.2f} s; "
        + " | ".join(x for x in text.splitlines()[1:2]))

    walls["c"] = time.perf_counter() - t_phase - walls["b"]

    # (d) the mesh buckets on bench.py's graded cloud
    mpts, meps, mvol = graded_cloud(np, MESH_NM)
    with tempfile.TemporaryDirectory() as mdir:
        os.environ["NLHEAT_MESH_DIR"] = mdir
        try:
            t0 = time.perf_counter()
            mhash = MeshStore(mdir).put(mpts, meps, mvol)
            put_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            mop = get_mesh_op(mhash, 1.0, 1.0, device="cuda")
            op_wall = time.perf_counter() - t0
            bound1 = float(np.max(mop.c * mop.wsum))
            dt1 = 0.8 / bound1
            nm = mop.n
            # B12 at the bucket's shape, every tier against its plain version, on a
            # random state as in the other checks (on the smooth profile G, L(G) is a
            # small difference of large sums, and two float32 orders of the same
            # sum differ by more than 1e-5 of its largest value: printed below)
            u = torch.tensor(rng.standard_normal(mop.n), device="cuda", dtype=f32)
            for dtype, tname in ((torch.float64, "float64"), (f32, "float32")):
                table = GatherTable(mop, dtype, "cuda")
                ud = u.to(dtype)
                for prec in ("f32", "bf16"):
                    hold("gather_L", f"{tname} {prec} graded nm={MESH_NM}",
                         cu.gather_L(table.rowptr, table.col, table.w, ud, prec),
                         cu.gather_L_plain(table.rowptr, table.col, table.w, ud, prec),
                         TOL[tname])
            gp = torch.tensor(mop.spatial_profile(), device="cuda", dtype=f32)
            smooth = rel_err(torch, cu.gather_L(table.rowptr, table.col, table.w, gp),
                             cu.gather_L_plain(table.rowptr, table.col, table.w, gp))[1]
            lib12 = csr_library(torch, table.rowptr, table.col, table.w, nm)
            lib_err = rel_err(torch, lib12(u), cu.gather_L(table.rowptr, table.col, table.w,
                                                           u))[1]
            if not lib_err <= tol32:
                fail(f"torch.sparse.mm of the baked table differs from gather_L: {lib_err:.3e}")
            out12 = {"ms": cuda_ms(torch, lambda: cu.gather_L(table.rowptr, table.col,
                                                              table.w, u), 100),
                     "plain_ms": cuda_ms(torch, lambda: cu.gather_L_plain(
                         table.rowptr, table.col, table.w, u), 5, 1),
                     "library_ms": cuda_ms(torch, lambda: lib12(u), 50)}
            b12 = bound(table.nnz * (isz + 4) + (nm + 1) * 8 + 2 * nm * isz, 2 * table.nnz)
            kpad = -(-(mop.kmax + 1) // 128) * 128
            say(f"graded cloud nm={MESH_NM}: {nm} nodes, {len(mop.tgt)} edges, kmax "
                f"{mop.kmax} (strips kpad {kpad}; CSR {table.nnz} entries with the centres); "
                f"host walls: MeshStore.put {put_wall:.2f} s, get_mesh_op {op_wall:.2f} s; "
                f"B12 gather_L f32: kernel {out12['ms']:.4f} ms, plain {out12['plain_ms']:.3f} "
                f"ms, torch.sparse.mm {out12['library_ms']:.4f} ms, bound {b12[0]:.4f} ms "
                f"({b12[1]}); on the smooth profile G (not held: cancellation) the float32 "
                f"|kernel-plain| / max|plain| is {smooth:.3e}")
            del lib12, table
            mixed_phys = [(1.0, 0.8), (0.5, 0.6), (2.0, 0.7), (1.0, 0.4), (0.2, 0.8),
                          (1.5, 0.5), (0.7, 0.5), (3.0, 0.3)]
            buckets = {
                "uniform": [EnsembleCase(shape=(nm,), nt=MESH_STEPS, eps=0, k=1.0, dt=dt1,
                                         dh=0.0, test=True, mesh=mhash)] * 8,
                "mixed": [EnsembleCase(shape=(nm,), nt=MESH_STEPS, eps=0, k=k,
                                       dt=f * 0.8 / (k * bound1), dh=0.0, test=True,
                                       mesh=mhash) for k, f in mixed_phys],
            }
            run_wall, dev_ms = {}, {}
            for name, cases in buckets.items():
                eng = EnsembleEngine(device="cuda", dtype=f32)
                ck.reset_launch_counts()
                t0 = time.perf_counter()
                res = eng.run(cases)
                run_wall[name] = time.perf_counter() - t0
                counted[name] = {k: v for k, v in ck.launch_counts().items() if v}
                r = eng.report
                if (r.buckets, r.programs_built, r.dispatches) != (1, 1, 1) \
                        or counted[name] != {"gather_L": 8 * MESH_STEPS}:
                    fail(f"mesh bucket {name}: {r.summary()}, launches {counted[name]}; "
                         f"expected 1 bucket, 1 program, 1 dispatch, gather_L x "
                         f"{8 * MESH_STEPS}")
                worst = 0.0
                for case, got in zip(cases, res, strict=True):
                    cop = eng._make_op(case)
                    solo = make_gather_multi_step_fn(cop, MESH_STEPS, dtype=f32, test=True)(
                        torch.as_tensor(cop.spatial_profile(), device="cuda"), 0)
                    if got.shape != (nm,) or not np.array_equal(got, solo.cpu().numpy()):
                        fail(f"mesh bucket {name}: a lane is not bitwise its solo gather loop")
                    d = got.astype(np.float64) - cop.manufactured_solution(MESH_STEPS)
                    worst = max(worst, float(np.sum(d * d)) / nm)
                if not worst <= l2_threshold:
                    fail(f"mesh bucket {name}: error_l2/#points {worst:.3e} > {l2_threshold:g}")
                key = cases[0].bucket_key()
                multi = eng.build_program(key, cases)
                U0 = eng.stage_inputs(cases)
                dev_ms[name] = cuda_ms(torch, lambda multi=multi, U0=U0: multi(U0, 0), 1, 1)
                say(f"mesh bucket {name} (8 x {nm} nodes, f32, {MESH_STEPS} steps; "
                    f"{r.strategies[key]}): run() wall {run_wall[name]:.3f} s (first run, "
                    f"building the tables), {dev_ms[name]:.3f} ms on the card per run "
                    f"({dev_ms[name] / (8 * MESH_STEPS):.4f} ms per case-step); launches "
                    f"{json.dumps(counted[name])}; every lane bitwise its solo loop; largest "
                    f"error_l2/#points {worst:.3e}")
        finally:
            del os.environ["NLHEAT_MESH_DIR"]
    walls["d"] = time.perf_counter() - t_phase - walls["b"] - walls["c"]
    say(f"phase 7 part walls, s: (b) the 512^2 cloud {walls['b']:.1f}, (c) the counted CLI "
        f"{walls['c']:.1f}, (d) the mesh buckets {walls['d']:.1f}")

    launches = {"windowed_matvec": counted["cli"].get("windowed_matvec", 0),
                "gather_L": counted["uniform"].get("gather_L", 0)
                + counted["mixed"].get("gather_L", 0)}

    def row(name, source, replaces, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": replaces, **kw, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs)}

    return [
        row("windowed_matvec", "windowed_matvec.cu",
            "nonlocalheatequation_tpu/ops/windowed.py:151", ms=out13["ms"],
            plain_ms=out13["plain_ms"], bound_ms=b13[0], bound_by=b13[1],
            library_ms=out13["library_ms"],
            library_note="torch.sparse.mm of the in-window entries as one CSR matrix; ms "
                         "and library_ms in a replayed CUDA graph, *_loop in a loop of launches",
            ms_loop=out13["ms_loop"], library_ms_loop=out13["library_ms_loop"],
            shape=f"shuffled {UN_M}^2, eps=3h, {shape13}",
            layout_step_ms=steps, exec_peak_bytes=exec_peak, packed_bytes=packed_bytes,
            dense_strip_bytes_f32=plan_strip_bytes),
        row("gather_L", "gather_L.cu", "nonlocalheatequation_tpu/ops/pallas_gather.py:144",
            ms=out12["ms"], plain_ms=out12["plain_ms"], bound_ms=b12[0], bound_by=b12[1],
            library_ms=out12["library_ms"],
            library_note="torch.sparse.mm of the baked table as one CSR matrix",
            shape=f"graded nm={MESH_NM} ({nm} nodes, kpad {kpad})",
            ms_shuffled=out12s["ms"], plain_ms_shuffled=out12s["plain_ms"],
            bound_ms_shuffled=b12s[0], library_ms_shuffled=out12s["library_ms"],
            bucket_ms=dev_ms, bucket_wall_s=run_wall),
    ]


# -- phase 8: the distributed grid solves ----------------------------------------------

DN, DEPS = 4096, 8       # the 2D distributed solve: 4096^2, eps=8, 2x2 mesh (2048^2 blocks)
D3N, D3EPS = 256, 4      # the 3D distributed solve: 256^3, eps=4, 2x2x2 mesh (128^3 blocks)
DSTEPS = 20              # steps of each distributed solve


def phase_halo_checks(torch, np) -> dict:
    """Phase 8 (kernels): split_nsum2d and split_nsum3d on frames, and
    fused_nsum2d and fused_nsum3d on every block of meshes of virtual
    devices of the card, against their plain versions in float64, float32
    and the bf16 operand tier, on normal, degenerate (a side <= 2*eps) and
    multi-hop (eps above the block edge) blocks, and BITWISE against the
    one-pass nsum2d/nsum3d on the same (halo-exchanged) frame; the
    refusals beyond the shared-memory tile and the neighbour table."""
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.ops import cuda_kernel as ck
    from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    from nonlocalheatequation_torch.parallel import halo as thalo
    from nonlocalheatequation_torch.parallel import mesh as tmesh

    rng = np.random.default_rng(SEED + 20)
    cases2 = [((70, 45), 5), ((300, 200), 8), ((100, 90), 40), ((2048, 64), 8),
              ((8, 40), 4), ((33, 33), 16), ((8, 8), 9), ((5, 7), 12)]
    cases3 = [((20, 12, 40), 3), ((33, 17, 40), 4), ((16, 16, 70), 6), ((12, 12, 12), 1),
              ((4, 4, 4), 2), ((6, 9, 8), 3), ((4, 4, 4), 5), ((3, 5, 2), 6)]
    worst, n = {}, {"split_nsum2d": 0, "split_nsum3d": 0}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        tol = TOL[dname]
        for prec in ("f32", "bf16"):
            for name, cases, split, plain, one_pass in (
                    ("split_nsum2d", cases2, th.split_nsum2d, th.split_nsum2d_plain, ck.nsum2d),
                    ("split_nsum3d", cases3, th.split_nsum3d, th.split_nsum3d_plain,
                     k3.nsum3d)):
                for block, e in cases:
                    frame = torch.tensor(rng.standard_normal(tuple(b + 2 * e for b in block)),
                                         dtype=dtype, device="cuda")
                    got, ref = split(frame, e, prec), plain(frame, e, prec)
                    _abs, rel = rel_err(torch, got, ref)
                    kind = ("degenerate" if th.degenerate(block, e)
                            else "multi-hop" if e > min(block) else "normal")
                    if not rel <= tol:
                        fail(f"{name} {dname} {prec} {block} eps={e} ({kind}): rel err "
                             f"{rel:.3e} > {tol:g}")
                    if not torch.equal(got, one_pass(frame, e, prec)):
                        fail(f"{name} {dname} {prec} {block} eps={e} ({kind}): not bitwise the "
                             "one-pass sum on the same frame")
                    key = f"{name}/{dname}/{prec}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    n[name] += 1
    # the in-kernel exchange: every block of a mesh of virtual devices of
    # the card, its halo read from the blocks around it
    meshes = [((2, 2), (70, 45), 5), ((2, 2), (300, 200), 8), ((4, 2), (8, 8), 9),
              ((3, 3), (2, 2), 5), ((2, 4), (33, 33), 16), ((1, 3), (5, 7), 12),
              ((2, 2), (8, 40), 4), ((2, 2), (100, 90), 40), ((2, 2, 2), (20, 12, 40), 3),
              ((2, 2, 2), (33, 17, 40), 4), ((2, 2, 2), (4, 4, 4), 5), ((3, 2, 2), (6, 9, 8), 3),
              ((2, 2, 2), (12, 12, 12), 1), ((2, 2, 2), (16, 16, 70), 6),
              ((2, 2, 2), (3, 5, 2), 6)]
    n.update(fused_nsum2d=0, fused_nsum3d=0)
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[1]
        for prec in ("f32", "bf16"):
            for mesh_shape, block, e in meshes:
                d = len(mesh_shape)
                name = f"fused_nsum{d}d"
                fused = th.fused_nsum2d if d == 2 else th.fused_nsum3d
                one_pass = ck.nsum2d if d == 2 else k3.nsum3d
                mesh = tmesh.create_mesh(("x", "y", "z")[:d], mesh_shape,
                                         tmesh.device_list("cuda", int(np.prod(mesh_shape))))
                u = rng.standard_normal(tuple(m * b for m, b in zip(mesh_shape, block)))
                blocks = tmesh.put_global(u, mesh, dtype)
                frames = thalo.halo_pad_nd(blocks, e)
                kind = ("degenerate" if th.degenerate(block, e)
                        else "multi-hop" if e > min(block) else "normal")
                for pos in np.ndindex(*mesh_shape):
                    got = fused(blocks, pos, e, prec)
                    if not torch.equal(got, one_pass(frames[pos], e, prec)):
                        fail(f"{name} {dname} {prec} mesh {mesh_shape} {block} eps={e} ({kind}) "
                             f"block {pos}: not bitwise the one-pass sum on the exchanged frame")
                    _abs, rel = rel_err(torch, got, th.fused_nsum_plain(blocks, pos, e, prec))
                    if not rel <= TOL[dname]:
                        fail(f"{name} {dname} {prec} mesh {mesh_shape} {block} eps={e} block "
                             f"{pos}: rel err {rel:.3e} > {TOL[dname]:g}")
                    key = f"{name}/{dname}/{prec}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    n[name] += 1
    for what, call in (
            ("split_nsum2d accepted eps=70 (beyond its shared-memory tile)",
             lambda: th.split_nsum2d(torch.zeros(200, 200, device="cuda",
                                                 dtype=torch.float64), 70)),
            ("fused_nsum2d accepted eps=70 (beyond its shared-memory tile)",
             lambda: th.fused_nsum2d(tmesh.put_global(
                 np.zeros((400, 400)), tmesh.make_mesh(2, 2, tmesh.device_list("cuda", 4)),
                 torch.float64), (0, 0), 70)),
            ("fused_nsum2d accepted a neighbour table beyond 125 blocks",
             lambda: th.fused_nsum2d(tmesh.put_global(
                 np.zeros((12, 12)), tmesh.make_mesh(12, 12, tmesh.device_list("cuda", 144)),
                 torch.float64), (0, 0), 6))):
        try:
            call()
            fail(f"{what} on the card")
        except ValueError:
            pass
    say("halo kernel checks (max |kernel-plain| / max|plain|; every case bitwise the one-pass "
        "nsum2d/nsum3d on its halo-exchanged frame; normal, degenerate and multi-hop blocks): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items()))
        + "; cases " + ", ".join(f"{k} {v}" for k, v in n.items()) + ": pass")
    return n


def split_launches(grid, mesh_shape, eps: int, nt: int) -> int:
    """split_nsum launches of an nt-step comm='fused' solve: one per phase
    per block per step (interior and ring, or one whole-block pass)."""
    block = [g // m for g, m in zip(grid, mesh_shape)]
    nblocks = 1
    for m in mesh_shape:
        nblocks *= m
    phases = 1 if eps == 0 or any(b <= 2 * eps for b in block) else 2
    return nt * nblocks * phases


def phase_distributed(torch, np, ck, l2_threshold) -> list:
    """Phase 8: (a) the halo kernels at the main path's blocks, f32:
    fused_nsum2d on the (0, 0) 2048^2 block of a 2x2 mesh of virtual
    devices at eps=8 and fused_nsum3d on the (0, 0, 0) 128^3 block of a
    2x2x2 mesh at eps=4, split_nsum2d/3d on that block's exchanged frame,
    each held to its plain version and bitwise to the one-pass sum on the
    frame, timed per call (CUDA events; and in a CUDA graph, without the
    host's cost) beside its plain version, its bound and F.conv2d/F.conv3d
    over the frame (TF32 off); (b) counted, the main path:
    Solver2DDistributed at 4096^2, eps=8, on a 2x2 mesh of virtual devices
    of the card and Solver3DDistributed at 256^3, eps=4, on a 2x2x2 mesh,
    each DSTEPS production steps in f32 with comm='fused' (the in-kernel
    exchange), comm='fused' under NLHEAT_FUSED_TRANSPORT=interp (band
    copies, then the split kernels) and comm='collective', all bitwise
    equal; then the distributed CLI's CASES_2D_DISTRIBUTED table (float64,
    8 virtual devices, --comm fused and the collective default); the counts
    must be exactly the solves' and the rows'; (c) each solve within the
    f32 tolerance of the tuned single-device Solver2D/Solver3D, and the
    distributed steps timed on the card."""
    import contextlib
    import io

    import torch.nn.functional as F

    from nonlocalheatequation_torch.cli import solve2d_distributed
    from nonlocalheatequation_torch.models.solver2d import Solver2D
    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    from nonlocalheatequation_torch.ops.nonlocal_op import (
        NonlocalOp2D,
        full_fp32,
        make_multi_step_fn,
    )
    from nonlocalheatequation_torch.parallel.distributed2d import (
        Solver2DDistributed,
        choose_mesh_shape,
    )
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.halo import halo_pad_nd
    from nonlocalheatequation_torch.parallel.mesh import (
        create_mesh,
        device_list,
        make_mesh,
        make_mesh_3d,
        put_global,
    )

    f32, tol32, isz = torch.float32, TOL["float32"], 4
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    names = ("split_nsum2d", "fused_nsum2d", "split_nsum3d", "fused_nsum3d")
    held = {k: [] for k in names}

    def hold(name, form, got, ref, tol):
        abs_err, rel = rel_err(torch, got, ref)
        held[name].append({"form": form, "max_abs_err": abs_err, "rel_err": rel, "tol": tol})
        if not rel <= tol:
            fail(f"{name} {form}: |kernel-plain| / max|plain| {rel:.3e} > {tol:g}")

    # (a) the kernels at the blocks of the main path
    timing = {}
    for d, nblk, e, conv in ((2, DN // 2, DEPS, F.conv2d), (3, D3N // 2, D3EPS, F.conv3d)):
        block, pos = (nblk,) * d, (0,) * d
        shape = "x".join(map(str, block))
        mesh = create_mesh(("x", "y", "z")[:d], (2,) * d, device_list("cuda", 2 ** d))
        blocks = put_global(torch.randn((2 * nblk,) * d, generator=gen, device="cuda"), mesh,
                            f32)
        frame = halo_pad_nd(blocks, e)[pos]
        one_pass = ck.nsum2d if d == 2 else k3.nsum3d
        split = th.split_nsum2d if d == 2 else th.split_nsum3d
        fused = th.fused_nsum2d if d == 2 else th.fused_nsum3d
        kernels = {
            f"split_nsum{d}d": (lambda p, split=split: split(frame, e, p),
                                lambda p, split=split: (th.split_nsum2d_plain if d == 2
                                                        else th.split_nsum3d_plain)(frame, e, p)),
            f"fused_nsum{d}d": (lambda p, fused=fused: fused(blocks, pos, e, p),
                                lambda p: th.fused_nsum_plain(blocks, pos, e, p)),
        }
        ops = (NonlocalOp2D(e, 1.0, 1.0, 1.0) if d == 2 else op_3d(8, e))
        kern = torch.as_tensor(ops.weights, dtype=f32, device="cuda")[None, None]
        with full_fp32():
            lib_ms = cuda_ms(torch, lambda: conv(frame[None, None], kern), 5, 1)
            lib_err = float((conv(frame[None, None], kern)[0, 0] - one_pass(frame, e)).abs().max())
        one_pass_ms = cuda_ms(torch, lambda: one_pass(frame, e), 50)
        npts = int(np.prod(block))
        per_point = kernel_ops(e, 0) if d == 2 else kernel_ops_3d(e, k3.tile3d(e, f32), 0)
        bnd = bound((frame.numel() + npts) * isz, npts * per_point)
        for name, (call, plain) in kernels.items():
            for prec in ("f32", "bf16"):
                got = call(prec)
                hold(name, f"float32 {prec} {shape} block eps={e}", got, plain(prec), tol32)
                if not torch.equal(got, one_pass(frame, e, prec)):
                    fail(f"{name} {prec} at the {shape} block: not bitwise the one-pass sum on "
                         "the exchanged frame")
            ms = cuda_ms(torch, lambda call=call: call("f32"), 50)
            ms_graph = graph_ms(torch, lambda call=call: call("f32"), 20)
            plain_ms = cuda_ms(torch, lambda plain=plain: plain("f32"), 3, 1)
            timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                                library_ms=lib_ms, ms_graph=ms_graph, one_pass_ms=one_pass_ms,
                                shape=f"{shape} block of a {'x'.join(['2'] * d)} mesh, "
                                      f"eps={e}, f32")
            extra = ""
            if name.startswith("split_"):
                out = torch.empty(block, dtype=f32, device="cuda")
                phase_ms = {p: cuda_ms(torch, lambda p=p: th.launch_phase(name, frame, out, e,
                                                                          "f32", p), 50)
                            for p in ("interior", "ring")}
                timing[name].update(ms_interior=phase_ms["interior"], ms_ring=phase_ms["ring"])
                extra = (f" (interior {phase_ms['interior']:.4f} + ring "
                         f"{phase_ms['ring']:.4f} ms alone)")
                del out
            say(f"{name} {shape} block eps={e} f32: kernel {ms:.4f} ms per call{extra}, "
                f"{ms_graph:.4f} in a CUDA graph; one-pass nsum on the exchanged frame "
                f"{one_pass_ms:.4f} ms, plain {plain_ms:.3f} ms, {conv.__name__} {lib_ms:.4f} "
                f"ms (TF32 off; max abs diff to one-pass {lib_err:.2e}), bound {bnd[0]:.4f} "
                f"ms ({bnd[1]})")
        del blocks, frame, kern

    # (b) the main path, counted
    devs4, devs8 = device_list("cuda", 4), device_list("cuda", 8)
    dh = 1.0 / DN
    probe = NonlocalOp2D(DEPS, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)  # 0.8x the Euler bound, as phase 4
    u2 = np.random.default_rng(SEED + 22).standard_normal((DN, DN))
    op3 = op_3d(D3N, D3EPS)
    u3 = np.random.default_rng(SEED + 23).standard_normal((D3N,) * 3)
    cases = cases_module().CASES_2D_DISTRIBUTED
    forms = (("fused", ""), ("fused", "interp"), ("collective", ""))
    solvers, res, walls = {}, {}, {}
    ck.reset_launch_counts()
    for comm, transport in forms:
        os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
        label = f"{comm} {transport}".strip()
        for d in ("2d", "3d"):
            if d == "2d":
                s = Solver2DDistributed(DN // 2, DN // 2, 2, 2, DSTEPS, DEPS, k=1.0, dt=dt,
                                        dh=dh, mesh=make_mesh(2, 2, devs4), method="cuda",
                                        dtype=f32, comm=comm)
                s.input_init(u2)
            else:
                s = Solver3DDistributed(D3N, D3N, D3N, DSTEPS, D3EPS, k=1.0, dt=op3.dt,
                                        dh=op3.dh, mesh=make_mesh_3d(2, 2, 2, devs8),
                                        method="cuda", dtype=f32, comm=comm)
                s.input_init(u3)
            t0 = time.perf_counter()
            res[f"{d} {label}"] = s.do_work()
            walls[f"{d} {label}"] = time.perf_counter() - t0
            solvers[f"{d} {label}"] = (s, transport)
    os.environ.pop("NLHEAT_FUSED_TRANSPORT")
    cli_out = {}
    for extra in (["--method", "cuda", "--comm", "fused"], []):
        stdout, stderr = io.StringIO(), io.StringIO()
        stdin, sys.stdin = sys.stdin, io.StringIO(batch_text(cases))
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
                rc = solve2d_distributed.main([*CLI_ARGS, "--devices", "8", *extra])
        finally:
            sys.stdin = stdin
        label = " ".join(extra) or "--comm collective (default, method auto)"
        if rc != 0 or stdout.getvalue().splitlines()[-1] != "Tests Passed":
            fail(f"solve2d_distributed --test_batch {label}: rc {rc}\n{stdout.getvalue()}\n"
                 f"{stderr.getvalue()[-4000:]}")
        cli_out[label] = time.perf_counter() - t0
    counts = {k: v for k, v in ck.launch_counts().items() if v}

    # the counts the path must show: the solves' and the rows'
    row_blocks = sum(nt * int(np.prod(choose_mesh_shape(nx * npx, ny * npy, 8)))
                     for nx, ny, npx, npy, nt, *_ in cases)
    expected = {
        "fused_nsum2d": DSTEPS * 4 + row_blocks,
        "fused_nsum3d": DSTEPS * 8,
        "split_nsum2d": split_launches((DN, DN), (2, 2), DEPS, DSTEPS),
        "split_nsum3d": split_launches((D3N,) * 3, (2, 2, 2), D3EPS, DSTEPS),
        # the collective solves, the collective CLI rows, and L(G) once per row per run
        "nsum2d": DSTEPS * 4 + row_blocks + 2 * len(cases),
        "nsum3d": DSTEPS * 8,
    }
    if counts != expected:
        fail(f"distributed main path: launches {counts} != {expected} (the solves' and the "
             "CLI rows')")
    for d in ("2d", "3d"):
        for label in ("fused", "fused interp"):
            if not np.array_equal(res[f"{d} {label}"], res[f"{d} collective"]):
                fail(f"the {d} distributed solve: comm='{label}' is not bitwise "
                     "comm='collective'")
        if not np.isfinite(res[f"{d} fused"]).all():
            fail(f"the {d} distributed solve: non-finite values")
    say(f"distributed main path: {DN}^2 eps={DEPS} on a 2x2 mesh of virtual devices of the "
        f"card and {D3N}^3 eps={D3EPS} on 2x2x2, {DSTEPS} production steps f32 each, "
        "comm='fused' (in-kernel exchange), 'fused' under NLHEAT_FUSED_TRANSPORT=interp (split "
        "kernels) and 'collective' bitwise equal (do_work walls, s: "
        f"{json.dumps({k: round(v, 3) for k, v in walls.items()})}); CASES_2D_DISTRIBUTED "
        "through solve2d_distributed --test_batch --platform gpu --x64 1 --devices 8: Tests "
        f"Passed ({json.dumps({k: round(v, 2) for k, v in cli_out.items()})} s); launches "
        f"{json.dumps(counts)} = the solves' and the rows'")

    # (c) against the tuned single-device solves, and the steps timed on the card
    solo = {"2d": Solver2D(DN, DN, DSTEPS, DEPS, k=1.0, dt=dt, dh=dh, method="cuda",
                           dtype=f32, device="cuda"),
            "3d": Solver3D(D3N, D3N, D3N, DSTEPS, D3EPS, k=1.0, dt=op3.dt, dh=op3.dh,
                           method="cuda", dtype=f32, device="cuda")}
    solo["2d"].input_init(u2)
    solo["3d"].input_init(u3)
    step_ms = {}
    for d, s in solo.items():
        ref = s.do_work()
        rel = float(np.abs(res[f"{d} fused"] - ref).max()) / float(np.abs(ref).max())
        if not rel <= tol32:
            fail(f"the {d} distributed solve vs the tuned single-device solve: {rel:.3e} > "
                 f"{tol32:g}")
        step_ms[f"{d} vs tuned solo, max rel diff"] = rel
        for comm, transport in forms:
            label = f"{comm} {transport}".strip()
            dist, transport = solvers[f"{d} {label}"]
            os.environ["NLHEAT_FUSED_TRANSPORT"] = transport
            blocks = dist._device_state()[0]
            run = dist._make_runner(DSTEPS)
            step_ms[f"{d} {label}"] = cuda_ms(torch, lambda: run(blocks, 0, ()), 1, 1) / DSTEPS
        os.environ.pop("NLHEAT_FUSED_TRANSPORT")
        u_dev = torch.as_tensor(s.u0, device="cuda").to(f32)
        multi = make_multi_step_fn(s.op, DSTEPS, dtype=f32)
        step_ms[f"{d} tuned solo"] = cuda_ms(torch, lambda: multi(u_dev, 0), 1, 1) / DSTEPS
    say(f"distributed steps on the card, ms/step (CUDA events over {DSTEPS}-step runs, the "
        f"exchange's copies included): {json.dumps(step_ms)}")
    del res, solvers, solo

    def row(name, source, line):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": f"nonlocalheatequation_torch/csrc/{source}",
                "replaces": f"nonlocalheatequation_tpu/ops/pallas_halo.py:{line}",
                **timing[name], "launches": counts.get(name, 0),
                "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs),
                "library_note": "F.conv over the exchanged frame in full f32 (TF32 off)"}

    return [row("split_nsum2d", "split_nsum2d.cu", 437),
            row("split_nsum3d", "split_nsum3d.cu", 474),
            row("fused_nsum2d", "fused_nsum2d.cu", 611),
            row("fused_nsum3d", "fused_nsum3d.cu", 653)]


def variant_launches(name: str, nsteps: int, ndim: int = 2) -> tuple:
    """(kernel, launches) of an nsteps run of the tuner's candidate ``name``
    for an ``ndim``-D solve."""
    if name == "per-step":
        return f"step{ndim}d", nsteps
    if name == "vmap":  # one nsum2d per case per step
        return "nsum2d", nsteps * ENS_B
    if name.startswith("batched-"):
        kernel, k = variant_launches(name[len("batched-"):], nsteps, ndim)
        return f"batched_{kernel}", k
    if name in ("carried", "carried3d"):
        return f"carried{ndim}d", nsteps
    if name in ("resident", "resident3d"):
        return f"resident{ndim}d", 1
    return "superstep2d", -(-nsteps // int(name[len("superstep"):]))


def graph_ms(torch, fn, launches: int = GRAPH_LAUNCHES, reps: int = 5) -> float:
    """Device milliseconds per call of fn: a CUDA graph of ``launches`` calls,
    replayed ``reps`` times, so the host's cost per launch is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    return cuda_ms(torch, graph.replay, reps, 1) / launches


def kernels_alone(torch, ck, u, eps: int, scale: float, wsum: float, dt: float) -> dict:
    """ms per launch of the per-step, carried and superstep kernels on u,
    without the host's cost per launch (at a small grid that cost is larger
    than the kernel's, so a loop of launches times the host)."""
    import torch.nn.functional as F

    out = torch.empty_like(u)
    frame = F.pad(u, (eps,) * 4).contiguous()
    fout = torch.empty_like(frame)
    runs = {"step2d": lambda: ck.step2d(u, eps, scale, wsum, dt, out=out),
            "carried2d": lambda: ck.carried2d(frame, eps, scale, wsum, dt, out=fout)}
    for k in (2, 3):
        runs[f"superstep2d K={k}"] = lambda k=k: ck.superstep2d(u, eps, scale, wsum, dt, k,
                                                                out=out)
    return {name: graph_ms(torch, fn) for name, fn in runs.items()}


def time_variants(torch, op, u, nsteps: int) -> dict:
    """ms/step of every candidate the tuner has for u's shape, each by CUDA
    events over one nsteps run after a warm-up run."""
    from nonlocalheatequation_torch.utils import autotune

    out = {}
    for name, maker in autotune.candidates(op, tuple(u.shape), nsteps, u.dtype, u.device):
        fn = maker(op, nsteps, u.dtype)
        out[name] = cuda_ms(torch, lambda fn=fn: fn(u, 0), 1, 1) / nsteps
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"numpy and torch are required: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        from nonlocalheatequation_torch.ops import _build
        from nonlocalheatequation_torch.ops import cuda_batched as cb
        from nonlocalheatequation_torch.ops import cuda_kernel as ck
        from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
    except ImportError as e:
        fail(f"the port package nonlocalheatequation_torch is not beside this script: {e}")
    cases_2d, cases_1d, l2_threshold = load_cases()
    # the default production path: tuned on the card, records kept in this
    # process only (nothing written outside the checkout)
    os.environ.pop("NLHEAT_TUNE_PRECISION", None)
    os.environ["NLHEAT_AUTOTUNE_CACHE"] = ""
    t_start = time.perf_counter()

    say(nvidia_smi("name,power.limit"))
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build(_build.ALL_SOURCES)
    say(f"build: {time.perf_counter() - t0:.1f} s ({json.dumps(built)})")
    for source in _build.ALL_SOURCES:
        log = _build.library_path(source).with_suffix(".log")
        if log.exists():
            text = log.read_text()
            regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
            spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
            say(f"ptxas {source}: {len(re.findall('Compiling entry', text))} kernels, "
                f"registers per thread {regs}, spill stores {spills} bytes")

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 1)
        return out

    atexit.register(stop_children)
    clis = start_clis(cases_2d, cases_1d)
    uclis = start_unstructured_clis()
    checks = timed("checks 2d", phase_checks, torch, ck, np)
    checks.update(timed("multi-step checks 2d", phase_multistep_checks, torch, ck, np))
    checks.update(timed("checks 3d", phase_checks_3d, torch, k3, np))
    checks.update(timed("batched checks", phase_batched_checks, torch, ck, cb, np))
    checks.update(timed("unstructured checks", phase_unstructured_checks, torch, np))
    checks.update(timed("halo checks", phase_halo_checks, torch, np))
    timed("tables", phase_main_path_tables, torch, clis, cases_2d, l2_threshold)
    timed("unstructured cli", phase_unstructured_cli, uclis, l2_threshold)
    kernels = timed("headline 2d", phase_headline, torch, np, ck, l2_threshold)
    kernels += timed("headline 3d", phase_headline_3d, torch, np, ck, k3, l2_threshold)
    kernels += timed("ensemble", phase_ensemble, torch, np, ck, cb, cases_2d)
    kernels += timed("unstructured", phase_unstructured, torch, np, ck, l2_threshold)
    kernels += timed("distributed", phase_distributed, torch, np, ck, l2_threshold)
    say(f"phase walls, s: {json.dumps(walls)}")
    for k in kernels:
        k["checks"] = checks[k["name"]]
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
