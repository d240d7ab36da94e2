#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nonlocalheatequation_torch) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the last
line is printed):

1. Device and build: the card's name and power limit, then the kernels built
   by nvcc from csrc/ (one nvcc per source, started together).
2. Kernels against their plain PyTorch versions on the card, in float64,
   float32 and the bf16 operand tier, over eps in {1, 3, 5, 8, 10, 16, 40}
   and ragged shapes (1x1, non tile multiples, nx < 2*eps, eps above the
   32-point tile).  Tolerance: max|kernel - plain| <= 1e-12 (float64) or
   1e-5 (float32) times the largest magnitude of the plain result.
3. The main path's correctness: the reference's batch tables (CASES_2D and
   CASES_1D of tests/cases.py) through the port's CLIs on the card in
   float64, each must print "Tests Passed"; then CASES_2D in float32
   through Solver2D, reporting the largest error_l2/#points.
4. The headline configuration: 4096^2, eps=8, float32, method="cuda".  At
   the main path's shapes every kernel form (nsum2d f32 and bf16 operand,
   and in float64 on the padded G the test-form solve gives it; step2d
   production and test form, f32 and bf16 operand) is held against its plain
   version with the phase-2 tolerances.  The kernels are timed with CUDA
   events beside their plain versions, their byte/operation bound and
   F.conv2d (the library yardstick, with TF32 disabled; the port never calls
   it), and the test-form source's set-up is timed on the card and in NumPy.
   Then the launch counts are reset and the main path runs through Solver2D:
   the production solve on a seeded random state and a test-form solve
   (whose L(G) goes through nsum2d); the counts must show every kernel
   launched.
5. The kernels' JSON line, then {"ok": true, "device": {...}}.

Exits non-zero and prints no result when torch.cuda.is_available() is false
or when the port package is not beside this script.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
NX, EPS, STEPS, TEST_STEPS = 4096, 8, 500, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
TOL = {"float64": 1e-12, "float32": 1e-5}


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
    """Operations per output point of the kernels' algorithm (csrc/nsum2d.cu):
    the row window sums add 2*eps terms into each cell of a tile's
    (32+2eps) x 32 window rows, shared by its 32 output rows; each output then
    adds 2*eps+1 of them, and the step ``epilogue`` more: 41 + epilogue at
    eps=8, where the direct sum over the mask takes 196 adds."""
    return 2 * eps * (32 + 2 * eps) / 32 + (2 * eps + 1) + epilogue


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


def phase_main_path_tables(torch, cases_2d, cases_1d, l2_threshold):
    """Phase 3: the batch tables through the CLIs (f64) and CASES_2D in f32."""
    from nonlocalheatequation_torch.models.solver2d import Solver2D

    t0 = time.perf_counter()
    jobs = {"solve2d": (cases_2d, None), "solve1d": (cases_1d, None)}
    try:
        for name, (rows, _) in jobs.items():
            jobs[name] = (rows, start_cli(f"nonlocalheatequation_torch.cli.{name}", rows))
        for name, (rows, proc) in jobs.items():
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0 or "Tests Passed" not in out:
                fail(f"{name} --test_batch --platform gpu --x64 1: rc {proc.returncode}\n"
                     f"{out}\n{err[-4000:]}")
            say(f"cli {name} --test_batch --platform gpu --x64 1: Tests Passed "
                f"({len(rows)} rows)")
    finally:
        for _rows, proc in jobs.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    say(f"cli wall: {time.perf_counter() - t0:.1f} s")
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
    held = {"nsum2d": [], "step2d": []}

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

    multi = make_multi_step_fn(op, STEPS, dtype=torch.float32)
    make_multi_step_fn(op, 10, dtype=torch.float32)(u, 0)  # warm-up
    loop_ms = cuda_ms(torch, lambda: multi(u, 0), 1, 0) / STEPS
    say(f"headline {NX}^2 eps={EPS} f32, {STEPS} steps (make_multi_step_fn, CUDA events): "
        f"{loop_ms:.4f} ms/step, {npts / (loop_ms * 1e-3):.4e} points*steps/s; "
        f"byte bound {2 * npts * isz / HBM_BYTES_PER_S * 1e3:.4f} ms/step")
    say(f"clocks/power after timing: {nvidia_smi('clocks.sm,power.draw,power.limit')}")

    # the main path, through the solver entry points, counted
    ck.reset_launch_counts()
    s = Solver2D(NX, NX, STEPS, EPS, k=1.0, dt=dt, dh=dh, method="cuda",
                 dtype=torch.float32, device="cuda")
    s.input_init(u0)
    t0 = time.perf_counter()
    res = s.do_work()
    wall = time.perf_counter() - t0
    if res.shape != (NX, NX) or not np.isfinite(res).all():
        fail("headline solve: result not finite or of the wrong shape")
    if not float(np.abs(res).max()) <= float(np.abs(u0).max()):
        fail("headline solve: the free decay grew (max|u| rose)")
    st = Solver2D(NX, NX, TEST_STEPS, EPS, k=1.0, dt=dt, dh=dh, method="cuda",
                  dtype=torch.float32, device="cuda")
    st.test_init()
    st.do_work()
    counts = ck.launch_counts()
    test_err = st.error_l2 / (NX * NX)
    if counts["step2d"] != STEPS + TEST_STEPS:
        fail(f"step2d launches {counts['step2d']} != {STEPS + TEST_STEPS} steps")
    if counts["nsum2d"] < 1:
        fail("nsum2d was not launched on the main path")
    if not test_err <= l2_threshold:
        fail(f"test-form headline solve: error_l2/#points {test_err:.3e} > {l2_threshold:g}")
    say(f"main path: Solver2D {NX}^2 eps={EPS} f32 method=cuda, {STEPS} production steps "
        f"(do_work wall {wall:.3f} s incl. host<->device copies) + {TEST_STEPS} test-form "
        f"steps (error_l2/#points {test_err:.3e}); launches {json.dumps(counts)}")
    def row(name, **kw):
        cs = held[name]
        return {"name": name, "route": "cuda",
                "source": "nonlocalheatequation_torch/csrc/nsum2d.cu", **kw,
                "launches": counts[name], "max_abs_err": max(c["max_abs_err"] for c in cs),
                "verdict": "pass" if all(c["rel_err"] <= c["tol"] for c in cs) else "fail",
                "main_shape_forms": len(cs)}

    return [
        {**row("nsum2d", replaces="nonlocalheatequation_tpu/ops/pallas_kernel.py:468"),
         "ms": nsum_ms, "plain_ms": nsum_plain_ms, "bound_ms": nsum_bound[0],
         "bound_by": nsum_bound[1], "library_ms": conv_ms},
        {**row("step2d", replaces="nonlocalheatequation_tpu/ops/pallas_kernel.py:515"),
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound[0],
         "bound_by": step_bound[1], "library_ms": None},
    ]


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
    except ImportError as e:
        fail(f"the port package nonlocalheatequation_torch is not beside this script: {e}")
    cases_2d, cases_1d, l2_threshold = load_cases()
    t_start = time.perf_counter()

    say(nvidia_smi("name,power.limit"))
    say(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build()
    say(f"build: {time.perf_counter() - t0:.1f} s ({json.dumps(built)})")
    log = _build.library_path(ck.SOURCE).with_suffix(".log")
    if log.exists():
        text = log.read_text()
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers", text)})
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
        say(f"ptxas: {len(re.findall('Compiling entry', text))} kernels, registers per "
            f"thread {regs}, spill stores {spills} bytes")

    checks = phase_checks(torch, ck, np)
    phase_main_path_tables(torch, cases_2d, cases_1d, l2_threshold)
    kernels = phase_headline(torch, np, ck, l2_threshold)
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
