"""1D solver CLI — the batch-test and single-solve surface of the reference's
1d_nonlocal_serial binary (src/1d_nonlocal_serial.cpp:313-344), on the port.

    echo "1
    50 45 5 1 0.001 0.02" | python -m nonlocalheatequation_torch.cli.solve1d --test_batch

A single solve takes ``--log`` (CSV/VTU logs every ``--nlog`` steps,
utils/csvlog.py) and ``--profile DIR`` (a torch.profiler trace), as the JAX
CLI does.  ``--method shift|fft`` picks the neighbour sum and ``--stepper
euler|rkc|expo`` (with ``--superstep-stages``) the time integrator, in every
mode.  ``--test_batch --serve D`` streams the rows through the serving
pipeline (serve/server.py) with D chunks in flight; ``--trace DIR``,
``--metrics-out FILE`` and ``--metrics-port PORT`` are the observability
flags (cli/common.obs_session).  ``--listen PORT`` serves cases over HTTP from
a replica fleet instead (cli/common.run_listen).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_ensemble_flag,
    add_listen_flags,
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
    ensemble_refusal,
    ensemble_runner,
    obs_session,
    platform_kwargs,
    precision_kwargs,
    publish_solve_metrics,
    run_batch,
    run_listen,
    serve_batch,
    stepper_kwargs,
    validate_listen_args,
    validate_obs_args,
    validate_serve_args,
    validate_stepper_args,
    version_banner,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="1d_nonlocal", add_help=True)
    p.add_argument("--test", action="store_true",
                   help="use the manufactured solution for testing")
    p.add_argument("--test_batch", action="store_true", help="run batch tests from stdin")
    p.add_argument("--results", action="store_true", help="print the final state")
    bool_flag(p, "cmp", True, "print expected vs actual outputs")
    p.add_argument("--nx", type=int, default=50)
    p.add_argument("--nt", type=int, default=45)
    p.add_argument("--nlog", type=int, default=5)
    p.add_argument("--eps", type=int, default=5)
    p.add_argument("--k", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.001)
    p.add_argument("--dx", type=float, default=0.02)
    p.add_argument("--no-header", action="store_true", dest="no_header")
    p.add_argument("--backend", default="torch", choices=("oracle", "torch"))
    p.add_argument("--method", default="shift", choices=("shift", "fft"),
                   help="neighbour-sum evaluation: shift (default, the reference-shaped "
                        "slice-add loop) or fft (the padded-box spectral apply, O(N log N) "
                        "and eps-independent; within 1e-12 of shift)")
    add_stepper_flags(p)
    p.add_argument("--log", action="store_true",
                   help="write csv/vtu logs every nlog steps")
    add_profile_flag(p)
    add_platform_flags(p)
    add_precision_flags(p)
    add_ensemble_flag(p)
    add_serve_flags(p)
    add_listen_flags(p)
    add_obs_flags(p)
    add_program_store_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    err = (ensemble_refusal(args) or validate_stepper_args(args) or validate_serve_args(args)
           or validate_listen_args(args, dim=1) or validate_obs_args(args))
    if err:
        print(err, file=sys.stderr)
        return 1
    version_banner("1d_nonlocal")
    sk = stepper_kwargs(args)
    if not args.test_batch and args.listen is None:
        rc = announce_stable_dt(1, args.k, args.eps, args.dx, args.dt, **sk)
        if rc is not None:
            return rc
    try:
        kw = {"backend": args.backend, "method": args.method, "nlog": args.nlog,
              **platform_kwargs(args), **precision_kwargs(args), **sk}
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2
    apply_program_store(args)
    with obs_session(args):
        return _run(args, kw, sk)


def _run(args, kw, sk) -> int:
    from nonlocalheatequation_torch.models.solver1d import Solver1D

    engine_kw = {"method": "fft" if args.method == "fft" else "auto",
                 "precision": args.precision, "device": kw["device"], "dtype": kw["dtype"],
                 **sk}
    if args.listen is not None:
        # the network front door (serve/http.py + serve/router.py): a
        # replica fleet over the same engine settings --serve would use
        return run_listen(args, engine_kw)

    if args.test_batch:
        # row: nx nt eps k dt dx  (tests/1d.txt)
        def read_case(toks, pos):
            v = toks[pos:pos + 6]
            return ((int(v[0]), int(v[1]), int(v[2]),
                     float(v[3]), float(v[4]), float(v[5])), pos + 6)

        def make_solver(case):
            nx, nt, eps, k, dt, dx = case
            return Solver1D(nx, nt, eps, k=k, dt=dt, dx=dx, **kw)

        def run_case(case):
            s = make_solver(case)
            s.test_init()
            s.do_work()
            return s.error_l2, s.nx

        run_ensemble = ensemble_runner(make_solver, **engine_kw) if args.ensemble else None
        run_serve = None
        if args.serve:
            def run_serve(case_iter):
                return serve_batch(case_iter, make_solver, engine_kw, args)

        return run_batch(read_case, run_case, row_tokens=6, run_ensemble=run_ensemble,
                         run_serve=run_serve, profile=args.profile)

    s = Solver1D(args.nx, args.nt, args.eps, k=args.k, dt=args.dt,
                 dx=args.dx, **kw)
    if args.log:
        from nonlocalheatequation_torch.utils.csvlog import SimulationCsvLogger

        s.logger = SimulationCsvLogger(s.op, test=args.test, tag="1d", nlog=args.nlog)
    if args.test:
        s.test_init()
    else:
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[: args.nx])

    from nonlocalheatequation_torch.utils.profiling import trace

    t0 = time.perf_counter()
    with trace(args.profile):
        u = s.do_work()
    elapsed = time.perf_counter() - t0
    publish_solve_metrics("1d", elapsed, args.nx, args.nt,
                          error_l2=s.error_l2 if args.test else None)
    if args.test:
        s.print_error(args.cmp)
    if args.results:
        for sx in range(args.nx):
            print(f"S[{sx}] = {u[sx]:g}")

    from nonlocalheatequation_torch.utils.timing import print_time_results_1d

    print_time_results_1d(os.cpu_count() or 1, elapsed, args.nx, args.nt,
                          header=not args.no_header)
    return 0


if __name__ == "__main__":
    sys.exit(main())
