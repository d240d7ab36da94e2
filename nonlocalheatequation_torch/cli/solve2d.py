"""2D solver CLI — the batch-test and single-solve surface of the reference's
2d_nonlocal_serial binary (src/2d_nonlocal_serial.cpp:382-415), on the port.

    echo "1
    50 50 45 5 1 0.0005 0.02" | python -m nonlocalheatequation_torch.cli.solve2d --test_batch

runs on the CUDA card (``--platform cpu`` for the CPU) and prints
"Tests Passed" when every row meets error_l2/#points <= 1e-6.  A single
solve takes ``--log`` (CSV/VTU logs every ``--nlog`` steps under out_csv/
and out_vtk/, utils/csvlog.py), ``--checkpoint``/``--ncheckpoint``/
``--resume`` (utils/checkpoint.py) and ``--profile DIR`` (a torch.profiler
trace, utils/profiling.py), as the JAX CLI does.  ``--stepper
euler|rkc|expo`` (with ``--superstep-stages``) picks the time integrator and
``--method fft`` the spectral apply, in every mode.  ``--test_batch --serve D``
streams the rows through the serving pipeline (serve/server.py) with D chunks
in flight; ``--trace DIR``, ``--metrics-out FILE`` and ``--metrics-port PORT``
are the observability flags (cli/common.obs_session).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_checkpoint_flags,
    add_ensemble_flag,
    add_obs_flags,
    add_platform_flags,
    add_precision_flags,
    add_profile_flag,
    add_program_store_flag,
    add_serve_flags,
    add_stepper_flags,
    announce_stable_dt,
    apply_program_store,
    bool_flag,
    checkpoint_refusal,
    ensemble_refusal,
    ensemble_runner,
    obs_session,
    platform_kwargs,
    precision_kwargs,
    publish_solve_metrics,
    run_batch,
    serve_batch,
    stepper_kwargs,
    validate_obs_args,
    validate_serve_args,
    validate_stepper_args,
    version_banner,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="2d_nonlocal", add_help=True)
    p.add_argument("--test", action="store_true",
                   help="use the manufactured solution for testing")
    p.add_argument("--test_batch", action="store_true", help="run batch tests from stdin")
    p.add_argument("--results", action="store_true", help="print the final state")
    bool_flag(p, "cmp", True, "print expected vs actual outputs")
    p.add_argument("--nx", type=int, default=50)
    p.add_argument("--ny", type=int, default=50)
    p.add_argument("--nt", type=int, default=45)
    p.add_argument("--nlog", type=int, default=5)
    p.add_argument("--eps", type=int, default=5)
    p.add_argument("--k", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.0005)
    p.add_argument("--dh", type=float, default=0.02)
    p.add_argument("--no-header", action="store_true", dest="no_header")
    p.add_argument("--backend", default="torch", choices=("oracle", "torch"))
    p.add_argument("--method", default="auto",
                   choices=("auto", "cuda", "conv", "shift", "sat", "fft"),
                   help="neighbour-sum evaluation: auto (cuda on the card, conv on "
                        "the CPU), cuda (the hand-written kernels), conv, shift, sat, fft "
                        "(the padded-box spectral apply)")
    add_stepper_flags(p)
    p.add_argument("--log", action="store_true",
                   help="write csv/vtu logs every nlog steps")
    add_checkpoint_flags(p)
    add_profile_flag(p)
    add_platform_flags(p)
    add_precision_flags(p)
    add_ensemble_flag(p)
    add_serve_flags(p)
    add_obs_flags(p)
    add_program_store_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    err = (checkpoint_refusal(args) or ensemble_refusal(args) or validate_stepper_args(args)
           or validate_serve_args(args, [
               (args.serve and (args.checkpoint or args.resume),
                "--checkpoint/--resume cannot be combined with --serve")])
           or validate_obs_args(args))
    if err:
        print(err, file=sys.stderr)
        return 1
    version_banner("2d_nonlocal")
    sk = stepper_kwargs(args)
    if not args.test_batch:
        rc = announce_stable_dt(2, args.k, args.eps, args.dh, args.dt, **sk)
        if rc is not None:
            return rc
    try:
        kw = {"method": args.method, "backend": args.backend, "nlog": args.nlog,
              **platform_kwargs(args), **precision_kwargs(args), **sk}
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2
    apply_program_store(args)
    with obs_session(args):
        return _run(args, kw, sk)


def _run(args, kw, sk) -> int:
    from nonlocalheatequation_torch.models.solver2d import Solver2D

    engine_kw = {"method": args.method, "precision": args.precision, "device": kw["device"],
                 "dtype": kw["dtype"], **sk}
    if args.test_batch:
        # row: nx ny nt eps k dt dh  (tests/2d.txt)
        def read_case(toks, pos):
            v = toks[pos:pos + 7]
            return ((int(v[0]), int(v[1]), int(v[2]), int(v[3]),
                     float(v[4]), float(v[5]), float(v[6])), pos + 7)

        def make_solver(case):
            nx, ny, nt, eps, k, dt, dh = case
            return Solver2D(nx, ny, nt, eps, k=k, dt=dt, dh=dh, **kw)

        def run_case(case):
            s = make_solver(case)
            s.test_init()
            s.do_work()
            return s.error_l2, s.nx * s.ny

        run_ensemble = ensemble_runner(make_solver, **engine_kw) if args.ensemble else None
        run_serve = None
        if args.serve:
            def run_serve(case_iter):
                return serve_batch(case_iter, make_solver, engine_kw, args)

        return run_batch(read_case, run_case, row_tokens=7, run_ensemble=run_ensemble,
                         run_serve=run_serve, profile=args.profile)

    s = Solver2D(args.nx, args.ny, args.nt, args.eps, k=args.k, dt=args.dt, dh=args.dh,
                 checkpoint_path=args.checkpoint, ncheckpoint=args.ncheckpoint, **kw)
    if args.log:
        from nonlocalheatequation_torch.utils.csvlog import SimulationCsvLogger

        s.logger = SimulationCsvLogger(s.op, test=args.test, tag="2d", nlog=args.nlog)
    if args.test:
        s.test_init()
    elif not args.resume:
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[: args.nx * args.ny])
    if args.resume:
        s.resume(args.checkpoint)

    from nonlocalheatequation_torch.utils.profiling import trace

    t0 = time.perf_counter()
    with trace(args.profile):
        s.do_work()
    elapsed = time.perf_counter() - t0
    publish_solve_metrics("2d", elapsed, args.nx * args.ny, args.nt,
                          error_l2=s.error_l2 if args.test else None)
    if args.test:
        s.print_error(args.cmp)
    if args.results:
        s.print_soln()

    from nonlocalheatequation_torch.utils.timing import print_time_results_2d

    print_time_results_2d(os.cpu_count() or 1, elapsed, args.nx, args.ny, args.nt,
                          header=not args.no_header)
    return 0


if __name__ == "__main__":
    sys.exit(main())
