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
3. The main path's correctness: the batch tables (CASES_2D and CASES_1D of
   tests/cases.py, CASES_3D of tests/test_oracle_3d.py, copied here) through
   the port's CLIs on the card in float64, each must print "Tests Passed";
   then CASES_2D and CASES_3D in float32 through Solver2D and Solver3D,
   reporting the largest error_l2/#points.
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
6. The kernels' JSON line, then {"ok": true, "device": {...}}.

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


def load_cases():
    path = ROOT / "tests" / "cases.py"
    if not path.is_file():
        fail(f"{path} not found: run from a checkout of the repository")
    spec = importlib.util.spec_from_file_location("nlheat_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
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


def start_cli(module: str, rows) -> subprocess.Popen:
    """Start a port CLI's batch mode on the card in float64 with ``rows`` as
    its stdin (a temporary file, so the CLIs run side by side)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryFile("w+") as stdin:
        stdin.write(f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows))
        stdin.seek(0)
        return subprocess.Popen([sys.executable, "-m", module, "--test_batch", "--platform",
                                 "gpu", "--x64", "1"], cwd=ROOT, env=env, stdin=stdin,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_clis(cases_2d, cases_1d) -> tuple:
    """Phase 3's batch tables through the CLIs (CASES_2D, CASES_1D, CASES_3D,
    float64), started right after the build so that they run beside phase 2;
    (jobs, start time).  Any still running at exit are stopped."""
    jobs = {}
    for name, rows in (("solve2d", cases_2d), ("solve1d", cases_1d), ("solve3d", CASES_3D)):
        proc = start_cli(f"nonlocalheatequation_torch.cli.{name}", rows)
        CHILDREN.append(proc)
        jobs[name] = (rows, proc)
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
        say(f"cli {name} --test_batch --platform gpu --x64 1: Tests Passed ({len(rows)} rows)")
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
    counts = {k: v for k, v in ck.launch_counts().items() if k.endswith("2d")}
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
    counts = {k: v for k, v in ck.launch_counts().items() if k.endswith("3d")}
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


def variant_launches(name: str, nsteps: int, ndim: int = 2) -> tuple:
    """(kernel, launches) of an nsteps run of the tuner's candidate ``name``
    for an ``ndim``-D solve."""
    if name == "per-step":
        return f"step{ndim}d", nsteps
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
    built = _build.build()
    say(f"build: {time.perf_counter() - t0:.1f} s ({json.dumps(built)})")
    for source in _build.SOURCES:
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
    checks = timed("checks 2d", phase_checks, torch, ck, np)
    checks.update(timed("multi-step checks 2d", phase_multistep_checks, torch, ck, np))
    checks.update(timed("checks 3d", phase_checks_3d, torch, k3, np))
    timed("tables", phase_main_path_tables, torch, clis, cases_2d, l2_threshold)
    kernels = timed("headline 2d", phase_headline, torch, np, ck, l2_threshold)
    kernels += timed("headline 3d", phase_headline_3d, torch, np, ck, k3, l2_threshold)
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
